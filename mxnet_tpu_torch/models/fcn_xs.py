"""FCN-xs semantic segmentation (reference `example/fcn-xs/symbol_fcnxs.py`).

The reference builds fcn32s/16s/8s on a VGG16 backbone with `pad=100` on the
first conv and closed-form filter-map arithmetic to compute crop offsets
(`symbol_fcnxs.py:4-75`).  As `mxnet_tpu/models/fcn_xs.py` builds it,
the backbone uses symmetric SAME padding so every stage is exactly a /2
downsample, stride-2^k deconvolutions bring the score maps back to input
resolution, and `Crop(crop_like)` handles the residual off-by-k
alignment: dense per-pixel 21-way scores with skip fusion from
pool3/pool4, on static shapes.

Variants match the reference training recipe (`fcn_xs.py:24-45`):
  fcn32s — upsample score by 32x directly.
  fcn16s — fuse pool4 skip, upsample by 16x.
  fcn8s  — fuse pool4 + pool3 skips, upsample by 8x.
"""
from .. import symbol as sym


def _vgg16_backbone(data, workspace_prefix=""):
    """Returns (pool3, pool4, relu7): VGG16 conv features + conv6/7 head."""
    p = workspace_prefix

    def block(x, num_filter, layers, stage):
        for i in range(layers):
            x = sym.Convolution(data=x, kernel=(3, 3), pad=(1, 1),
                                num_filter=num_filter,
                                name="%sconv%d_%d" % (p, stage, i + 1))
            x = sym.Activation(data=x, act_type="relu",
                               name="%srelu%d_%d" % (p, stage, i + 1))
        return sym.Pooling(data=x, pool_type="max", kernel=(2, 2),
                           stride=(2, 2), name="%spool%d" % (p, stage))

    net = block(data, 64, 2, 1)
    net = block(net, 128, 2, 2)
    pool3 = block(net, 256, 3, 3)
    pool4 = block(pool3, 512, 3, 4)
    pool5 = block(pool4, 512, 3, 5)
    # fc6/fc7 as convolutions (fully-convolutional head,
    # `symbol_fcnxs.py:113-121`); kernel 7 -> SAME pad 3 keeps /32 grid
    fc6 = sym.Convolution(data=pool5, kernel=(7, 7), pad=(3, 3),
                          num_filter=4096, name="%sfc6" % p)
    relu6 = sym.Activation(data=fc6, act_type="relu", name="%srelu6" % p)
    drop6 = sym.Dropout(data=relu6, p=0.5, name="%sdrop6" % p)
    fc7 = sym.Convolution(data=drop6, kernel=(1, 1), num_filter=4096,
                          name="%sfc7" % p)
    relu7 = sym.Activation(data=fc7, act_type="relu", name="%srelu7" % p)
    return pool3, pool4, sym.Dropout(data=relu7, p=0.5, name="%sdrop7" % p)


def _upscore(score, scale, num_classes, name):
    """Stride-`scale` bilinear-initializable deconvolution
    (`symbol_fcnxs.py` `fcnxs_score`; weights set by Bilinear init,
    reference `init_fcnxs.py:20-34`)."""
    k = 2 * scale
    pad = scale // 2
    return sym.Deconvolution(data=score, kernel=(k, k),
                             stride=(scale, scale), pad=(pad, pad),
                             num_filter=num_classes, no_bias=True, name=name)


def get_fcn_xs(num_classes=21, variant="fcn8s"):
    """FCN-32s/16s/8s symbol; input NCHW with H, W divisible by 32.

    Output: per-pixel SoftmaxOutput (multi_output) over `num_classes`,
    like the reference's `mx.symbol.SoftmaxOutput(..., multi_output=True)`
    (`symbol_fcnxs.py:131-133`).
    """
    if variant not in ("fcn32s", "fcn16s", "fcn8s"):
        raise ValueError("variant must be fcn32s|fcn16s|fcn8s, got %r"
                         % (variant,))
    data = sym.Variable(name="data")
    pool3, pool4, head = _vgg16_backbone(data)
    score = sym.Convolution(data=head, kernel=(1, 1),
                            num_filter=num_classes, name="score")

    if variant == "fcn32s":
        up = _upscore(score, 32, num_classes, "upscore32")
        up = sym.Crop(up, data, num_args=2, name="upscore_crop")
        return sym.SoftmaxOutput(data=up, multi_output=True, use_ignore=True,
                                 ignore_label=255, name="softmax")

    # fuse pool4 skip at stride 16 (`symbol_fcnxs.py:139-152`)
    score2 = _upscore(score, 2, num_classes, "score2")
    score_pool4 = sym.Convolution(data=pool4, kernel=(1, 1),
                                  num_filter=num_classes, name="score_pool4")
    score_pool4c = sym.Crop(score_pool4, score2, num_args=2,
                            name="score_pool4c")
    score_fused = score2 + score_pool4c

    if variant == "fcn16s":
        up = _upscore(score_fused, 16, num_classes, "upscore16")
        up = sym.Crop(up, data, num_args=2, name="upscore_crop")
        return sym.SoftmaxOutput(data=up, multi_output=True, use_ignore=True,
                                 ignore_label=255, name="softmax")

    # fuse pool3 skip at stride 8 (`symbol_fcnxs.py:154-168`)
    score4 = _upscore(score_fused, 2, num_classes, "score4")
    score_pool3 = sym.Convolution(data=pool3, kernel=(1, 1),
                                  num_filter=num_classes, name="score_pool3")
    score_pool3c = sym.Crop(score_pool3, score4, num_args=2,
                            name="score_pool3c")
    up = _upscore(score4 + score_pool3c, 8, num_classes, "upscore8")
    up = sym.Crop(up, data, num_args=2, name="upscore_crop")
    return sym.SoftmaxOutput(data=up, multi_output=True, use_ignore=True,
                             ignore_label=255, name="softmax")
