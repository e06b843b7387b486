"""ResNet (reference `symbol_resnet-28-small.py` generalized to the standard
ResNet-v1 family; ResNet-50 is the BASELINE.json north-star workload).

As `mxnet_tpu/models/resnet.py` builds it, names included, so parameters
carry across packages.  bf16 compute through the trainer's ``dtype``."""
from .. import symbol as sym


def _conv_bn(data, num_filter, kernel, stride, pad, name, act=True,
             ghost_batch=0):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True,
                           name=name + "_conv")
    bn = sym.BatchNorm(data=conv, fix_gamma=False, eps=2e-5, momentum=0.9,
                       ghost_batch=ghost_batch, name=name + "_bn")
    if act:
        return sym.Activation(data=bn, act_type="relu", name=name + "_relu")
    return bn


def _bottleneck(data, num_filter, stride, dim_match, name, ghost_batch=0):
    gb = ghost_batch
    b1 = _conv_bn(data, num_filter // 4, (1, 1), (1, 1), (0, 0), name + "_b1",
                  ghost_batch=gb)
    b2 = _conv_bn(b1, num_filter // 4, (3, 3), stride, (1, 1), name + "_b2",
                  ghost_batch=gb)
    b3 = _conv_bn(b2, num_filter, (1, 1), (1, 1), (0, 0), name + "_b3",
                  act=False, ghost_batch=gb)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, (1, 1), stride, (0, 0),
                            name + "_sc", act=False, ghost_batch=gb)
    return sym.Activation(data=b3 + shortcut, act_type="relu",
                          name=name + "_out")


def _basic(data, num_filter, stride, dim_match, name, ghost_batch=0):
    gb = ghost_batch
    b1 = _conv_bn(data, num_filter, (3, 3), stride, (1, 1), name + "_b1",
                  ghost_batch=gb)
    b2 = _conv_bn(b1, num_filter, (3, 3), (1, 1), (1, 1), name + "_b2",
                  act=False, ghost_batch=gb)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, (1, 1), stride, (0, 0),
                            name + "_sc", act=False, ghost_batch=gb)
    return sym.Activation(data=b2 + shortcut, act_type="relu",
                          name=name + "_out")


_UNITS = {
    # 28 = the reference's symbol_resnet-28-small.py CIFAR variant
    # (3 stages x n blocks); served by the small-image stem below.
    28: ([4, 4, 4], _basic, [64, 128, 256]),
    18: ([2, 2, 2, 2], _basic, [64, 128, 256, 512]),
    34: ([3, 4, 6, 3], _basic, [64, 128, 256, 512]),
    50: ([3, 4, 6, 3], _bottleneck, [256, 512, 1024, 2048]),
    101: ([3, 4, 23, 3], _bottleneck, [256, 512, 1024, 2048]),
    152: ([3, 8, 36, 3], _bottleneck, [256, 512, 1024, 2048]),
}


def get_resnet(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               pooling_convention="full", ghost_batch=0):
    """pooling_convention: 'full' keeps the reference's ceil-mode pooled
    sizes (stages at 57/29/15/8 for 224 input, `pooling-inl.h:191-197`);
    'valid' is floor mode, giving the standard 56/28/14/7 ResNet geometry —
    ~17% fewer FLOPs (the bench.py setting).

    ghost_batch > 0 computes every BatchNorm's statistics over sub-batches
    of that size (see the BatchNorm op)."""
    units, block, filters = _UNITS[num_layers]
    data = sym.Variable("data")
    small = image_shape[1] < 64
    if small:  # CIFAR-style stem (resnet-28-small)
        body = _conv_bn(data, 16, (3, 3), (1, 1), (1, 1), "stem",
                        ghost_batch=ghost_batch)
        filters = [f // 4 for f in filters]
    else:
        body = _conv_bn(data, 64, (7, 7), (2, 2), (3, 3), "stem",
                        ghost_batch=ghost_batch)
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max", name="stem_pool",
                           pooling_convention=pooling_convention)
    for stage, (n, f) in enumerate(zip(units, filters)):
        stride = (1, 1) if stage == 0 else (2, 2)
        body = block(body, f, stride, False, "stage%d_unit0" % stage,
                     ghost_batch=ghost_batch)
        for unit in range(1, n):
            body = block(body, f, (1, 1), True,
                         "stage%d_unit%d" % (stage, unit),
                         ghost_batch=ghost_batch)
    pool = sym.Pooling(data=body, kernel=(7, 7), global_pool=True,
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(data=pool, name="flatten")
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
