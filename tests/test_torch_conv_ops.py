"""The port's conv-net ops, tensor ops and loss heads against the JAX
package's, on the CPU.

Each op's ``apply`` runs in both packages on the same numpy inputs (made
from a seed): the JAX op under `jax.vjp`, the port's under torch
autograd, with the same random cotangent on every output compared.
Outputs, input gradients, aux updates and ``infer_shape`` (from every
input's shape) must agree.

Tolerances, as `tests/test_torch_ops.py` holds the LM path's ops: both
sides compute in float32 with the same formulas, so they differ only in
the order of their sums (a window of at most 9 terms, a channel sum of at
most 12), 1e-5 absolute and 1e-6 relative on values of magnitude ~1.  A
convolution's products and BatchNorm's batch statistics sum up to a few
hundred terms in another order (oneDNN's blocking against XLA's), so
their gradients, and the convolutions' outputs, are held at rtol 1e-5.

Each trap of the port is shown to catch the naive torch call it replaces:
torch's ``ceil_mode`` pooling, `F.batch_norm`'s unbiased running
variance, a transposed convolution without its groups, and bilinear
upsampling with ``align_corners=True``.  The JAX package's Deconvolution
raises at num_group > 1, so the port's grouped deconvolution is held
against the JAX op run group by group.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import mxnet_tpu.ops  # noqa: F401  (registers the JAX package's ops)
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as treg

ATOL, RTOL = 1e-5, 1e-6
# convolutions and BatchNorm's gradients: sums of up to a few hundred terms
# in another order
RTOL_SUM = 1e-5


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _run(name, params, inputs, diff, *, aux=(), is_train=False, n_out=None,
         seed=0):
    """Both packages' outputs, aux updates and input gradients of op
    ``name``: a dict of numpy lists keyed j/t + outs/aux/grads.  The first
    ``n_out`` outputs (all by default) get a random cotangent each; inputs
    at positions ``diff`` are differentiated.  Both must infer the same
    shapes from every input's shape."""
    jop, top = jreg.get(name), treg.get(name)
    jp, tp = jop.parse_params(params), top.parse_params(params)
    shapes = [tuple(a.shape) for a in inputs]
    assert top.infer_shape(tp, shapes) == jop.infer_shape(jp, shapes)

    def jfn(*d):
        args = [jnp.asarray(a) for a in inputs]
        for i, a in zip(diff, d):
            args[i] = a
        outs, up = jop.apply(
            jreg.OpCtx(is_train=is_train, rng=jax.random.PRNGKey(0)), jp,
            args, [jnp.asarray(a) for a in aux])
        return tuple(outs[:n_out]), up

    jouts, vjp, jaux = jax.vjp(jfn, *(jnp.asarray(inputs[i]) for i in diff),
                               has_aux=True)
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*o.shape).astype(np.asarray(o).dtype) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots)) if diff else []

    targs = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in diff:
        targs[i].requires_grad_()
    touts, taux = top.apply(
        treg.OpCtx(is_train=is_train, rng=torch.Generator().manual_seed(0)),
        tp, targs, [torch.from_numpy(np.array(a)) for a in aux])
    touts = touts[:n_out]
    pairs = [(o, torch.from_numpy(c)) for o, c in zip(touts, cots)
             if o.requires_grad]
    if pairs and diff:
        torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])

    def grad(t):
        return np.zeros(t.shape, np.float32) if t.grad is None else \
            t.grad.numpy()

    return {"jouts": [np.asarray(o) for o in jouts],
            "touts": [o.detach().numpy() for o in touts],
            "jaux": [None if a is None else np.asarray(a) for a in jaux],
            "taux": [None if a is None else a.detach().numpy() for a in taux],
            "jgrads": [np.asarray(g) for g in jgrads],
            "tgrads": [grad(targs[i]) for i in diff]}


def _assert_same(name, params, inputs, diff, *, rtol=RTOL, grad_rtol=None,
                 **kw):
    r = _run(name, params, inputs, diff, **kw)
    for i, (a, b) in enumerate(zip(r["touts"], r["jouts"])):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=rtol,
                                   err_msg="output %d" % i)
    for i, a, b in zip(diff, r["tgrads"], r["jgrads"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=grad_rtol or rtol,
                                   err_msg="grad of input %d" % i)
    assert len(r["taux"]) == len(r["jaux"])
    for i, (a, b) in enumerate(zip(r["taux"], r["jaux"])):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=rtol,
                                       err_msg="aux %d" % i)
    return r


# -- tensor ops -------------------------------------------------------------


def test_flatten_and_swapaxis_match_jax():
    x = _randn(2, 3, 4, 5, seed=1)
    _assert_same("Flatten", {}, [x], [0])
    _assert_same("SwapAxis", {"dim1": 1, "dim2": 3}, [x], [0])


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_concat_matches_jax(dim):
    shapes = [[2, 3, 4], [2, 3, 4], [2, 3, 4]]
    for s, n in zip(shapes, (1, 2, 3)):
        s[dim] = n
    ins = [_randn(*s, seed=i) for i, s in enumerate(shapes)]
    _assert_same("Concat", {"num_args": 3, "dim": dim}, ins, [0, 1, 2])


@pytest.mark.parametrize("axis,squeeze", [(1, False), (0, False), (2, True)])
def test_slice_channel_matches_jax(axis, squeeze):
    shape = [6, 6, 3]
    if squeeze:
        shape[axis] = 3
    _assert_same("SliceChannel", {"num_outputs": 3, "axis": axis,
                                  "squeeze_axis": squeeze},
                 [_randn(*shape, seed=2)], [0])


def test_slice_channel_refuses_what_jax_refuses():
    op = treg.get("SliceChannel")
    with pytest.raises(MXNetError, match="not divisible"):
        op.infer_shape(op.parse_params({"num_outputs": 4}), [(2, 6)])
    with pytest.raises(MXNetError, match="squeeze_axis"):
        op.infer_shape(op.parse_params({"num_outputs": 2,
                                        "squeeze_axis": True}), [(2, 6)])


def test_elementwise_sum_and_cross_device_copy_match_jax():
    ins = [_randn(3, 4, seed=s) for s in (3, 4, 5, 6)]
    _assert_same("ElementWiseSum", {"num_args": 4}, ins, [0, 1, 2, 3])
    _assert_same("_CrossDeviceCopy", {}, ins[:1], [0])


def test_cast_matches_jax_and_casts_the_gradient_back():
    r = _assert_same("Cast", {"dtype": "float16"}, [_randn(3, 5, seed=7)],
                     [0], rtol=1e-3)
    assert r["tgrads"][0].dtype == np.float32
    top = treg.get("Cast")
    assert top.infer_type(top.parse_params({"dtype": "float16"}),
                          [np.dtype(np.float32)])[1] == [np.dtype("float16")]
    # float64 stays float64 in the port (JAX without x64 gives float32)
    y = top.apply(treg.OpCtx(), top.parse_params({"dtype": "float64"}),
                  [torch.zeros(2)], [])[0][0]
    assert y.dtype == torch.float64


def test_block_grad_passes_values_and_stops_the_gradient():
    r = _assert_same("BlockGrad", {}, [_randn(3, 4, seed=8)], [0])
    assert not r["tgrads"][0].any() and not r["jgrads"][0].any()


@pytest.mark.parametrize("params", [
    {"h_w": (3, 4), "offset": (1, 2)},
    {"h_w": (3, 4), "center_crop": True},
    # an offset past the edge: clamped, as jax.lax.dynamic_slice clamps
    {"h_w": (4, 5), "offset": (3, 4)},
])
def test_crop_matches_jax(params):
    _assert_same("Crop", params, [_randn(2, 3, 7, 9, seed=9)], [0])


@pytest.mark.parametrize("center", [False, True])
def test_crop_like_matches_jax(center):
    """``Crop(a, b, num_args=2)``: b's spatial size, b gets no gradient."""
    ins = [_randn(2, 3, 8, 9, seed=10), _randn(2, 5, 5, 6, seed=11)]
    _assert_same("Crop", {"num_args": 2, "center_crop": center,
                          "offset": (1, 1)}, ins, [0, 1])


def test_crop_refuses_without_a_target():
    op = treg.get("Crop")
    with pytest.raises(MXNetError, match="h_w"):
        op.infer_shape(op.parse_params({}), [(1, 2, 5, 5)])


def test_upsampling_nearest_matches_jax():
    """Two inputs: each repeated up to scale x the first's size, then
    concatenated along channels."""
    ins = [_randn(2, 2, 3, 4, seed=12), _randn(2, 3, 6, 8, seed=13)]
    _assert_same("UpSampling", {"scale": 2, "num_args": 2}, ins, [0, 1])
    _assert_same("UpSampling", {"scale": 3}, ins[:1], [0])


@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_bilinear_matches_jax_image_resize(scale):
    """`jax.image.resize` against `F.interpolate(align_corners=False)`,
    edges included: both weigh only the pixels inside the input there.
    ``align_corners=True`` (the naive alternative) moves the values by
    far more than the tolerance."""
    x = _randn(2, 3, 5, 4, seed=14)
    r = _assert_same("UpSampling", {"scale": scale,
                                    "sample_type": "bilinear"}, [x], [0])
    out = r["jouts"][0]
    # the edges: the first and last rows and columns of the output
    for sl in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0],
               np.s_[..., :, -1]):
        np.testing.assert_allclose(r["touts"][0][sl], out[sl], atol=ATOL,
                                   rtol=RTOL)
    naive = F.interpolate(torch.from_numpy(x), scale_factor=scale,
                          mode="bilinear", align_corners=True).numpy()
    assert np.abs(naive - out).max() > 100 * ATOL


# -- convolution ------------------------------------------------------------


@pytest.mark.parametrize("params", [
    {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)},
    {"kernel": (3, 2), "num_filter": 6, "stride": (2, 1), "num_group": 2,
     "no_bias": True},
    {"kernel": (3, 3), "num_filter": 4, "dilate": (2, 2), "pad": (2, 1)},
    {"kernel": (1, 1), "num_filter": 2, "stride": (2, 2)},
])
def test_convolution_matches_jax(params):
    top = treg.get("Convolution")
    p = top.parse_params(params)
    x = _randn(2, 4, 9, 7, seed=15)
    shapes = top.infer_shape(p, [x.shape, None, None][:len(
        top.list_arguments(p))])[0]
    ins = [x] + [_randn(*s, seed=16 + i, scale=0.3)
                 for i, s in enumerate(shapes[1:])]
    _assert_same("Convolution", params, ins, list(range(len(ins))),
                 rtol=RTOL_SUM)


@pytest.mark.parametrize("params", [
    {"kernel": (4, 4), "num_filter": 6, "stride": (2, 2), "pad": (1, 1),
     "no_bias": False},
    {"kernel": (3, 3), "num_filter": 3, "stride": (3, 3)},
])
def test_deconvolution_matches_jax(params):
    """Weight (C_in, num_filter, kh, kw), output ``stride*(in-1) + kernel -
    2*pad``."""
    top = treg.get("Deconvolution")
    p = top.parse_params(params)
    x = _randn(2, 4, 5, 3, seed=18)
    shapes = top.infer_shape(p, [x.shape] + [None] * (
        len(top.list_arguments(p)) - 1))[0]
    assert shapes[1] == (4, params["num_filter"]) + p["kernel"]
    ins = [x] + [_randn(*s, seed=19 + i, scale=0.3)
                 for i, s in enumerate(shapes[1:])]
    _assert_same("Deconvolution", params, ins, list(range(len(ins))),
                 rtol=RTOL_SUM)


@pytest.mark.parametrize("num_group,num_filter", [(2, 6), (4, 4)])
def test_grouped_deconvolution_matches_per_group_jax(num_group, num_filter):
    """Weight (C_in, num_filter/num_group, kh, kw).  The JAX op raises at
    num_group > 1 (its IOHW weight against XLA's grouped contraction,
    `mxnet_tpu/ops/nn.py:313-328`), so the port is held against the JAX
    op run on each group's channels and filters, concatenated: the
    reference's grouped deconvolution.  The naive call without the groups
    reads the weight as (C_in, num_filter, ...) and gives another shape."""
    params = {"kernel": (4, 4), "num_filter": num_filter, "stride": (2, 2),
              "pad": (1, 1), "num_group": num_group, "no_bias": False}
    top, jop = treg.get("Deconvolution"), jreg.get("Deconvolution")
    p = top.parse_params(params)
    x = _randn(2, 4, 5, 3, seed=18)
    shapes = top.infer_shape(p, [x.shape, None, None])[0]
    assert shapes[1] == (4, num_filter // num_group, 4, 4)
    x, w, b = [x] + [_randn(*s, seed=19 + i, scale=0.3)
                     for i, s in enumerate(shapes[1:])]
    with pytest.raises(ValueError):
        jop.apply(jreg.OpCtx(), jop.parse_params(params),
                  [jnp.asarray(a) for a in (x, w, b)], [])
    cin, fg = 4 // num_group, num_filter // num_group
    jg = jop.parse_params(dict(params, num_group=1, num_filter=fg,
                               no_bias=True))

    def jfn(x, w, b):
        outs = [jop.apply(jreg.OpCtx(), jg,
                          [x[:, g * cin:(g + 1) * cin],
                           w[g * cin:(g + 1) * cin]], [])[0][0]
                for g in range(num_group)]
        return jnp.concatenate(outs, axis=1) + b.reshape(1, -1, 1, 1)

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, w, b)))
    cot = _randn(*jout.shape, seed=30)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    tout = top.apply(treg.OpCtx(), p, targs, [])[0][0]
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=RTOL_SUM)
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL,
                                   rtol=RTOL_SUM)
    naive = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                               stride=2, padding=1)
    assert naive.shape[1] != num_filter


@pytest.mark.parametrize("op_name", ["Convolution", "Deconvolution"])
def test_f32_convolutions_run_without_tf32_whatever_the_flag(monkeypatch,
                                                             op_name):
    """cuDNN's TF32 flag defaults to True; the ops clear it around their
    forward and their backward (which autograd runs after the op
    returned) and restore it after."""
    seen = []
    real = tnn._no_tf32

    def spy():
        seen.append(torch.backends.cudnn.allow_tf32)
        cm = real()

        class Wrap:
            def __enter__(self):
                cm.__enter__()
                seen.append(torch.backends.cudnn.allow_tf32)

            def __exit__(self, *exc):
                return cm.__exit__(*exc)
        return Wrap()

    monkeypatch.setattr(tnn, "_no_tf32", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    op = treg.get(op_name)
    p = op.parse_params({"kernel": (3, 3), "num_filter": 2,
                         "no_bias": True})
    x = torch.randn(1, 2, 5, 5, requires_grad=True)
    w = torch.randn(2, 2, 3, 3, requires_grad=True)
    y = op.apply(treg.OpCtx(), p, [x, w], [])[0][0]
    y.sum().backward()
    # forward and backward each: True outside, False inside
    assert seen == [True, False, True, False]
    assert torch.backends.cudnn.allow_tf32 is True
    assert x.grad is not None and w.grad is not None


# -- pooling ----------------------------------------------------------------

POOL_CASES = [
    # odd sizes, the reference's clamped ceil mode ('full')
    ((7, 9), {"kernel": (3, 3), "stride": (2, 2)}),
    # stride beyond the kernel: torch's ceil rule sizes it otherwise
    ((7, 8), {"kernel": (2, 2), "stride": (3, 3)}),
    # padding, with the overhang past it
    ((8, 7), {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
    ((6, 6), {"kernel": (2, 3), "stride": (2, 2), "pad": (1, 0)}),
    # the last window starts in the bottom/right padding: the reference
    # keeps it (max -inf, avg and sum 0), torch's ceil_mode drops it
    ((5, 7), {"kernel": (2, 2), "stride": (2, 2), "pad": (1, 1)}),
]


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
@pytest.mark.parametrize("convention", ["full", "valid"])
@pytest.mark.parametrize("hw,params", POOL_CASES)
def test_pooling_matches_jax(pool_type, convention, hw, params):
    params = dict(params, pool_type=pool_type,
                  pooling_convention=convention)
    _assert_same("Pooling", params, [_randn(2, 3, *hw, seed=20)], [0])


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_global_pooling_matches_jax(pool_type):
    _assert_same("Pooling", {"kernel": (7, 7), "global_pool": True,
                             "pool_type": pool_type},
                 [_randn(2, 3, 5, 6, seed=21)], [0])


def test_naive_ceil_mode_pooling_differs_from_the_reference():
    """torch's ``ceil_mode`` drops a last window that starts in the padding,
    where the reference keeps it, and clips the avg divisor at the padded
    edge, where the reference divides every window by the full kernel
    area."""
    x = _randn(1, 2, 5, 7, seed=22)
    r = _run("Pooling", {"kernel": (2, 2), "stride": (2, 2), "pad": (1, 1),
                         "pool_type": "max"}, [x], [])
    naive = F.max_pool2d(torch.from_numpy(x), 2, 2, padding=1,
                         ceil_mode=True)
    assert r["jouts"][0].shape == (1, 2, 4, 5) and naive.shape != (1, 2, 4, 5)
    x = _randn(1, 2, 8, 7, seed=23)
    r = _run("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                         "pool_type": "avg"}, [x], [])
    naive = F.avg_pool2d(torch.from_numpy(x), 3, 2, padding=1,
                         ceil_mode=True, count_include_pad=True).numpy()
    assert naive.shape == r["jouts"][0].shape
    assert np.abs(naive - r["jouts"][0]).max() > 100 * ATOL


def test_pooling_refuses_an_unknown_convention_and_type():
    op = treg.get("Pooling")
    with pytest.raises(MXNetError, match="pooling_convention"):
        op.infer_shape(op.parse_params({"kernel": (2, 2),
                                        "pooling_convention": "same"}),
                       [(1, 1, 4, 4)])
    with pytest.raises(MXNetError, match="pool_type"):
        op.apply(treg.OpCtx(), op.parse_params({"kernel": (2, 2),
                                                "pool_type": "lp"}),
                 [torch.zeros(1, 1, 4, 4)], [])


@pytest.mark.parametrize("hw,params", [
    ((6, 6), {"kernel": (2, 2), "stride": (2, 2)}),
    ((7, 9), {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
])
def test_unpooling_matches_jax(hw, params):
    """The pooled map from the JAX op itself, ties included (a ReLU'd
    input): each window's value goes to its first max."""
    pool_in = np.maximum(_randn(2, 3, *hw, seed=24), 0)
    jp = jreg.get("Pooling")
    pooled = np.asarray(jp.apply(jreg.OpCtx(), jp.parse_params(dict(
        params, pool_type="max")), [jnp.asarray(pool_in)], [])[0][0])
    x = _randn(*pooled.shape, seed=25)
    _assert_same("Unpooling", params, [x, pool_in, pooled], [0, 1, 2])


# -- BatchNorm --------------------------------------------------------------


def _bn_inputs(n=6, c=3, hw=(4, 5), seed=26):
    x = _randn(n, c, *hw, seed=seed, scale=2.0) + 0.5
    return [x, _randn(c, seed=seed + 1) + 1, _randn(c, seed=seed + 2)]


def _bn_aux(c=3, seed=29):
    return [_randn(c, seed=seed, scale=0.1),
            np.abs(_randn(c, seed=seed + 1)) + 0.5]


@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("ghost_batch", [0, 2, 3])
def test_batch_norm_training_matches_jax(fix_gamma, ghost_batch):
    """Training: batch statistics in float32, the moving statistics'
    update with the biased variance, the three outputs (mean and var the
    batch's), gradients through the statistics; with ``fix_gamma`` the
    gamma argument's gradient is zero in both."""
    params = {"fix_gamma": fix_gamma, "ghost_batch": ghost_batch,
              "eps": 2e-5, "momentum": 0.9}
    r = _assert_same("BatchNorm", params, _bn_inputs(), [0, 1, 2],
                     aux=_bn_aux(), is_train=True, grad_rtol=RTOL_SUM)
    if fix_gamma:
        assert not r["tgrads"][1].any() and not r["jgrads"][1].any()


def test_batch_norm_two_training_steps_then_eval_match_jax():
    """The aux states after two training steps, then inference from them,
    and ``use_global_stats`` in training (the moving statistics, no
    update)."""
    params = {"fix_gamma": False, "eps": 1e-3}
    aux = _bn_aux()
    for step in range(2):
        r = _assert_same("BatchNorm", params, _bn_inputs(seed=40 + step),
                         [0, 1, 2], aux=aux, is_train=True,
                         grad_rtol=RTOL_SUM)
        aux = r["jaux"]
    for train, glob in ((False, False), (True, True)):
        r = _assert_same("BatchNorm", dict(params, use_global_stats=glob),
                         _bn_inputs(seed=50), [0, 1, 2], aux=aux,
                         is_train=train, grad_rtol=RTOL_SUM)
        assert r["taux"] == [None, None]


def test_batch_norm_moving_variance_is_the_biased_one():
    """`F.batch_norm(training=True)`, the naive call, updates the running
    variance with the unbiased variance: n/(n-1) of the reference's."""
    x, gamma, beta = _bn_inputs(n=2, hw=(2, 2))
    mean, var = _bn_aux()
    r = _run("BatchNorm", {"fix_gamma": False}, [x, gamma, beta], [],
             aux=[mean, var], is_train=True)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    F.batch_norm(torch.from_numpy(x), rm, rv, torch.from_numpy(gamma),
                 torch.from_numpy(beta), training=True, momentum=0.1,
                 eps=1e-3)
    np.testing.assert_allclose(rm.numpy(), r["jaux"][0], atol=ATOL)
    assert np.abs(rv.numpy() - r["jaux"][1]).max() > 100 * ATOL
    np.testing.assert_allclose(r["taux"][1], r["jaux"][1], atol=ATOL,
                               rtol=RTOL)


def test_batch_norm_refuses_a_ghost_size_that_does_not_divide():
    op = treg.get("BatchNorm")
    x, gamma, beta = (torch.from_numpy(a) for a in _bn_inputs(n=5))
    with pytest.raises(MXNetError, match="ghost_batch=2"):
        op.apply(treg.OpCtx(is_train=True), op.parse_params(
            {"ghost_batch": 2}), [x, gamma, beta],
            [torch.zeros(3), torch.ones(3)])


def test_batch_norm_shows_one_output_of_three():
    op = treg.get("BatchNorm")
    p = op.parse_params({})
    assert op.list_outputs(p) == ["output", "mean", "var"]
    assert op.num_visible_outputs(p) == 1
    assert op.list_aux(p) == ["moving_mean", "moving_var"]


# -- the other layers -------------------------------------------------------


@pytest.mark.parametrize("nsize", [3, 4, 5])
def test_lrn_matches_jax(nsize):
    _assert_same("LRN", {"nsize": nsize, "alpha": 1e-2, "beta": 0.75,
                         "knorm": 1.0},
                 [_randn(2, 6, 3, 4, seed=31, scale=2.0)], [0])


@pytest.mark.parametrize("act", ["leaky", "elu", "prelu", "rrelu"])
def test_leaky_relu_matches_jax(act):
    """rrelu at inference: the midpoint slope, in both."""
    ins = [_randn(2, 3, 4, 5, seed=32)]
    if act == "prelu":
        ins.append(_randn(3, seed=33, scale=0.3))
    _assert_same("LeakyReLU", {"act_type": act, "slope": 0.3}, ins,
                 list(range(len(ins))))


def test_rrelu_in_training_draws_slopes_in_range():
    """Training rrelu draws a slope per element from the op's generator, in
    [lower_bound, upper_bound): PyTorch's draws, not JAX's bits (ROADMAP
    queue 3, beside Dropout).  Positive inputs pass unchanged."""
    op = treg.get("LeakyReLU")
    p = op.parse_params({"act_type": "rrelu", "lower_bound": 0.1,
                         "upper_bound": 0.3})
    x = torch.cat([-torch.ones(4000), torch.ones(10)])

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return op.apply(treg.OpCtx(is_train=True, rng=gen), p, [x],
                        [])[0][0]

    y = run(1)
    slope = -y[:4000]
    assert slope.min() >= 0.1 and slope.max() < 0.3
    assert abs(slope.mean().item() - 0.2) < 0.005
    assert torch.equal(y[4000:], x[4000:])
    assert torch.equal(run(1), y) and not torch.equal(run(2), y)
    with pytest.raises(MXNetError, match="random generator"):
        op.apply(treg.OpCtx(is_train=True), p, [x], [])


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation_matches_jax(mode):
    _assert_same("SoftmaxActivation", {"mode": mode},
                 [_randn(2, 4, 3, 2, seed=34)], [0])


# -- loss heads -------------------------------------------------------------


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "LogisticRegressionOutput",
                                  "MAERegressionOutput"])
@pytest.mark.parametrize("grad_scale", [1.0, 0.5])
def test_regression_heads_match_jax(name, grad_scale):
    """The backward ignores the incoming gradient (a random cotangent
    here): ``(out - label) * grad_scale`` (MAE: its sign)."""
    x, label = _randn(4, 3, seed=35), _randn(4, 3, seed=36)
    r = _assert_same(name, {"grad_scale": grad_scale}, [x, label], [0])
    out = r["jouts"][0]
    want = (np.sign(out - label) if name.startswith("MAE") else
            out - label) * grad_scale
    np.testing.assert_allclose(r["tgrads"][0], want, atol=ATOL, rtol=RTOL)


def test_softmax_cross_entropy_matches_jax():
    x = _randn(5, 7, seed=37)
    label = np.array([0, 6, 3, 3, 1], np.float32)
    _assert_same("softmax_cross_entropy", {}, [x, label], [0])


def test_kl_sparse_reg_adds_its_penalty_in_backward():
    x = np.random.RandomState(38).uniform(0.05, 0.95, (6, 4)).astype(
        np.float32)
    r = _assert_same("IdentityAttachKLSparseReg",
                     {"sparseness_target": 0.2, "penalty": 0.01}, [x], [0])
    np.testing.assert_array_equal(r["touts"][0], x)
