"""Neural-network layer ops.

A port of `mxnet_tpu/ops/nn.py`, with the JAX package's parameters,
argument lists, shape rules (NCHW, the reference's clamped ceil-mode
pooling, its weight layouts) and numerics.  Bodies are torch calls that
run on both devices with no branch on the device: the matrix products go
to `F.linear` and the convolutions to `aten.convolution` (cuBLAS and
cuDNN on the card), as the JAX package leaves them to XLA.  No op here
has a kernel of the table: the JAX package computes all of them outside
Pallas.

* `Activation`'s gelu is the tanh form: `jax.nn.gelu` defaults to
  ``approximate=True``, torch's `F.gelu` to the erf form.
* `Dropout` and `LeakyReLU`'s rrelu draw from the op's
  `torch.Generator`; they cannot give the JAX package's bits.
* `Embedding`'s backward is autograd's scatter-add into the table: on the
  card its order of summation may differ from the CPU's.
* `Convolution` and `Deconvolution` run float32 without TF32, forward
  and backward, whatever ``torch.backends.cudnn.allow_tf32`` says (it
  defaults to True): the flag is cleared around each cuDNN call
  (`_Conv`).  bf16 stays on cuDNN's tensor cores.
* `Pooling` pads explicitly (``-inf`` for max, 0 for avg and sum) out to
  the ceil-mode overhang, then pools with no padding and, for avg, the
  full kernel area as divisor: torch's ``ceil_mode`` sizes the output
  by another rule and clips the avg divisor at the padded edge.
* `BatchNorm` computes the batch statistics in float32 and updates the
  moving variance with the biased variance, as `jnp.var` does
  (`F.batch_norm`'s running variance is the unbiased one), then
  normalises in the compute dtype.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpDef, Param, register


def _pair(v, name):
    if v is None:
        return None
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        v = (v[0], v[0])
    if len(v) != 2:
        raise MXNetError("%s must have 2 entries, got %r" % (name, v))
    return v


class Activation(OpDef):
    """`src/operator/activation-inl.h`: relu/sigmoid/tanh/softrelu, plus
    gelu (tanh form, as `jax.nn.gelu`)."""

    name = "Activation"
    params = {"act_type": Param(str, required=True)}
    _FNS = {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softrelu": F.softplus,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }

    def apply(self, octx, params, inputs, aux):
        act = params["act_type"]
        if act not in self._FNS:
            raise MXNetError("Activation: unknown act_type %r" % act)
        return [self._FNS[act](inputs[0])], []


register(Activation)


class FullyConnected(OpDef):
    """`src/operator/fully_connected-inl.h:46-243` — y = x·Wᵀ + b, weight
    (num_hidden, in).  Input is flattened to (batch, -1) like the
    reference."""

    name = "FullyConnected"
    params = {
        "num_hidden": Param(int, required=True),
        "no_bias": Param(bool, default=False),
    }

    def list_arguments(self, params):
        return ["data", "weight"] if params["no_bias"] else ["data", "weight", "bias"]

    def infer_shape(self, params, in_shapes):
        nh = params["num_hidden"]
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if len(d) < 2:
            raise MXNetError(
                "FullyConnected: data must be (batch, ...) with at least 2 "
                "dims, got %s" % (d,))
        flat = int(np.prod(d[1:]))
        shapes = [d, (nh, flat)]
        if not params["no_bias"]:
            shapes.append((nh,))
        return shapes, [(d[0], nh)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0].reshape(inputs[0].shape[0], -1)
        bias = None if params["no_bias"] else inputs[2]
        return [F.linear(x, inputs[1], bias)], []


register(FullyConnected)


class Dropout(OpDef):
    """`src/operator/dropout-inl.h` — inverted dropout (scale at train)."""

    name = "Dropout"
    params = {"p": Param(float, default=0.5)}
    need_rng = True

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        p = params["p"]
        if not octx.is_train or p <= 0.0:
            return [x], []
        keep = 1.0 - p
        u = torch.rand(x.shape, generator=octx.require_rng(),
                       device=x.device)
        return [torch.where(u < keep, x / keep, 0.0).to(x.dtype)], []


register(Dropout)


class Embedding(OpDef):
    """`src/operator/embedding-inl.h` — table lookup; backward is a
    scatter-add into the table (autograd of the lookup)."""

    name = "Embedding"
    params = {
        "input_dim": Param(int, required=True),
        "output_dim": Param(int, required=True),
    }

    def list_arguments(self, params):
        return ["data", "weight"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        w = (params["input_dim"], params["output_dim"])
        if d is None:
            return [None, w], [None], []
        return [d, w], [tuple(d) + (params["output_dim"],)], []

    def apply(self, octx, params, inputs, aux):
        return [F.embedding(inputs[0].long(), inputs[1])], []


register(Embedding)


class LeakyReLU(OpDef):
    """`src/operator/leaky_relu-inl.h`: leaky/prelu/rrelu (+elu extension).

    rrelu draws a uniform slope in [lower_bound, upper_bound] per element in
    training and uses the midpoint at inference, like the reference.
    """

    name = "LeakyReLU"
    params = {
        "act_type": Param(str, default="leaky"),
        "slope": Param(float, default=0.25),
        "lower_bound": Param(float, default=0.125),
        "upper_bound": Param(float, default=0.334),
    }
    need_rng = True

    def list_arguments(self, params):
        if params["act_type"] == "prelu":
            return ["data", "gamma"]
        return ["data"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if params["act_type"] == "prelu":
            g = (d[1],) if d is not None else in_shapes[1]
            return [d, g], [d], []
        return [d], [d], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        act = params["act_type"]
        if act == "leaky":
            return [torch.where(x > 0, x, params["slope"] * x)], []
        if act == "elu":
            return [torch.where(x > 0, x,
                                params["slope"] * (torch.exp(x) - 1.0))], []
        if act == "prelu":
            gamma = inputs[1].reshape((1, -1) + (1,) * (x.dim() - 2))
            return [torch.where(x > 0, x, gamma * x)], []
        if act == "rrelu":
            lo, hi = params["lower_bound"], params["upper_bound"]
            if octx.is_train:
                slope = torch.rand(x.shape, generator=octx.require_rng(),
                                   device=x.device, dtype=x.dtype) \
                    * (hi - lo) + lo
            else:
                slope = (lo + hi) / 2.0
            return [torch.where(x > 0, x, slope * x)], []
        raise MXNetError("LeakyReLU: unknown act_type %r" % act)


register(LeakyReLU)


class SoftmaxActivation(OpDef):
    """`src/operator/softmax_activation-inl.h`: softmax over features
    (mode=instance) or over channel axis per spatial position (mode=channel)."""

    name = "SoftmaxActivation"
    params = {"mode": Param(str, default="instance")}

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        if params["mode"] == "channel":
            return [torch.softmax(x, dim=1)], []
        flat = x.reshape(x.shape[0], -1)
        return [torch.softmax(flat, dim=1).reshape(x.shape)], []


register(SoftmaxActivation)


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _no_tf32():
    """Clear cuDNN's TF32 flag for the block: float32 convolutions keep
    float32 products (a bf16 one is unaffected)."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = old


class _Conv(torch.autograd.Function):
    """`aten.convolution` (``transposed`` for Deconvolution) with no bias,
    forward and backward under `_no_tf32`: autograd's own backward would
    read the global flag when it runs, outside the op."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilate, groups, transposed):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, pad, dilate, transposed, groups)
        with _no_tf32():
            return torch.ops.aten.convolution(
                x, w, None, stride, pad, dilate, transposed, [0, 0], groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, dilate, transposed, groups = ctx.args
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _no_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, None, stride, pad, dilate, transposed,
                [0, 0], groups, mask)
        return dx, dw, None, None, None, None, None


class Convolution(OpDef):
    """`src/operator/convolution-inl.h` — NCHW, OIHW weights, grouped and
    dilated convolution, one cuDNN call on the card (`_Conv`)."""

    name = "Convolution"
    params = {
        "kernel": Param("shape", required=True),
        "stride": Param("shape", default=(1, 1)),
        "dilate": Param("shape", default=(1, 1)),
        "pad": Param("shape", default=(0, 0)),
        "num_filter": Param(int, required=True),
        "num_group": Param(int, default=1),
        "no_bias": Param(bool, default=False),
        "workspace": Param(int, default=512),  # accepted, ignored
    }

    def list_arguments(self, params):
        return ["data", "weight"] if params["no_bias"] else ["data", "weight", "bias"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if len(d) != 4:
            raise MXNetError("Convolution: data must be NCHW 4D, got %s" % (d,))
        k = _pair(params["kernel"], "kernel")
        s = _pair(params["stride"], "stride")
        dil = _pair(params["dilate"], "dilate")
        p = _pair(params["pad"], "pad")
        nf, ng = params["num_filter"], params["num_group"]
        if d[1] % ng or nf % ng:
            raise MXNetError("Convolution: channels not divisible by num_group")
        wshape = (nf, d[1] // ng, k[0], k[1])
        oh = (d[2] + 2 * p[0] - (dil[0] * (k[0] - 1) + 1)) // s[0] + 1
        ow = (d[3] + 2 * p[1] - (dil[1] * (k[1] - 1) + 1)) // s[1] + 1
        if oh <= 0 or ow <= 0:
            raise MXNetError("Convolution: kernel exceeds input")
        shapes = [d, wshape] + ([] if params["no_bias"] else [(nf,)])
        return shapes, [(d[0], nf, oh, ow)], []

    def apply(self, octx, params, inputs, aux):
        y = _Conv.apply(inputs[0], inputs[1],
                        _pair(params["stride"], "stride"),
                        _pair(params["pad"], "pad"),
                        _pair(params["dilate"], "dilate"),
                        params["num_group"], False)
        if not params["no_bias"]:
            y = y + inputs[2].reshape(1, -1, 1, 1)
        return [y], []


register(Convolution)


class Deconvolution(OpDef):
    """`src/operator/deconvolution-inl.h` — transposed convolution.
    Weight layout (C_in, num_filter/num_group, kh, kw), which is
    `conv_transpose2d`'s; output spatial size `stride*(in-1) + kernel -
    2*pad` like the reference's InferShape."""

    name = "Deconvolution"
    params = {
        "kernel": Param("shape", required=True),
        "stride": Param("shape", default=(1, 1)),
        "pad": Param("shape", default=(0, 0)),
        "num_filter": Param(int, required=True),
        "num_group": Param(int, default=1),
        "no_bias": Param(bool, default=True),
        "workspace": Param(int, default=512),
    }

    def list_arguments(self, params):
        return ["data", "weight"] if params["no_bias"] else ["data", "weight", "bias"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        k = _pair(params["kernel"], "kernel")
        s = _pair(params["stride"], "stride")
        p = _pair(params["pad"], "pad")
        nf, ng = params["num_filter"], params["num_group"]
        wshape = (d[1], nf // ng, k[0], k[1])
        oh = s[0] * (d[2] - 1) + k[0] - 2 * p[0]
        ow = s[1] * (d[3] - 1) + k[1] - 2 * p[1]
        shapes = [d, wshape] + ([] if params["no_bias"] else [(nf,)])
        return shapes, [(d[0], nf, oh, ow)], []

    def apply(self, octx, params, inputs, aux):
        y = _Conv.apply(inputs[0], inputs[1],
                        _pair(params["stride"], "stride"),
                        _pair(params["pad"], "pad"), (1, 1),
                        params["num_group"], True)
        if not params["no_bias"]:
            y = y + inputs[2].reshape(1, -1, 1, 1)
        return [y], []


register(Deconvolution)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


def _pool_out_hw(d, k, s, p, name="Pooling", convention="full"):
    """Pooled output size, shared by Pooling and Unpooling.
    convention='full' is the reference's clamped ceil mode
    (`pooling-inl.h:191-197`); 'valid' is floor mode."""
    if convention == "valid":
        oh = (d[2] + 2 * p[0] - k[0]) // s[0] + 1
        ow = (d[3] + 2 * p[1] - k[1]) // s[1] + 1
    else:
        oh = min(d[2] + 2 * p[0] - k[0] + s[0] - 1,
                 d[2] + 2 * p[0] - 1) // s[0] + 1
        ow = min(d[3] + 2 * p[1] - k[1] + s[1] - 1,
                 d[3] + 2 * p[1] - 1) // s[1] + 1
    if oh <= 0 or ow <= 0:
        raise MXNetError("%s: kernel size exceeds input" % name)
    return oh, ow


def _pool_overhang(d, ohw, k, s, p):
    """Bottom/right ceil-mode extension so every output window fits."""
    eh = max(0, (ohw[0] - 1) * s[0] + k[0] - (d[2] + 2 * p[0]))
    ew = max(0, (ohw[1] - 1) * s[1] + k[1] - (d[3] + 2 * p[1]))
    return eh, ew


class Pooling(OpDef):
    """`src/operator/pooling-inl.h` — max/avg/sum, NCHW, the reference's
    clamped ceil-mode output size (`pooling-inl.h:191-197`).  avg divides by
    the full kernel area including padding, like `pooling-inl.h:94`."""

    name = "Pooling"
    params = {
        "kernel": Param("shape", required=True),
        "pool_type": Param(str, default="max"),
        "stride": Param("shape", default=(1, 1)),
        "pad": Param("shape", default=(0, 0)),
        "global_pool": Param(bool, default=False),
        # 'full' = reference ceil mode; 'valid' = floor (later-MXNet param)
        "pooling_convention": Param(str, default="full"),
    }

    def _out_hw(self, params, d):
        k = _pair(params["kernel"], "kernel")
        s = _pair(params["stride"], "stride")
        p = _pair(params["pad"], "pad")
        if params["global_pool"]:
            return (1, 1), (d[2], d[3]), (1, 1), (0, 0)
        conv = params.get("pooling_convention") or "full"
        if conv not in ("full", "valid"):
            raise MXNetError(
                "Pooling: pooling_convention must be 'full' or 'valid', "
                "got %r" % (conv,))
        return _pool_out_hw(d, k, s, p, convention=conv), k, s, p

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if len(d) != 4:
            raise MXNetError("Pooling: data must be NCHW 4D")
        (oh, ow), _, _, _ = self._out_hw(params, d)
        return [d], [(d[0], d[1], oh, ow)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        d = tuple(x.shape)
        (oh, ow), k, s, p = self._out_hw(params, d)
        eh, ew = _pool_overhang(d, (oh, ow), k, s, p)
        pads = (p[1], p[1] + ew, p[0], p[0] + eh)
        pt = params["pool_type"]
        if pt == "max":
            out = F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)
        elif pt in ("avg", "sum"):
            out = F.avg_pool2d(F.pad(x, pads), k, s,
                               divisor_override=k[0] * k[1] if pt == "avg"
                               else 1)
        else:
            raise MXNetError("Pooling: unknown pool_type %r" % pt)
        return [out], []


register(Pooling)


class Unpooling(OpDef):
    """`src/operator/unpooling-inl.h` + `guided_unpooling.h` — SegNet-style
    max-unpooling without stored switches.

    Inputs: ``data`` (at pooled resolution), ``data_pool`` (the map before
    pooling) and ``data_pooled`` (its max-pooled result).  Each window's
    ``data`` goes to the row-major-first position whose value equals the
    pooled max; ``data_pool`` and ``data_pooled`` get zero gradient.  As
    in the JAX package, the window is unrolled into k_y*k_x strided
    slices of the padded map (the clamped-ceil overhang NaN-padded, so it
    never matches) and the first match is a cumsum-based one-hot.
    """

    name = "Unpooling"
    params = {
        "kernel": Param("shape", required=True),
        "stride": Param("shape", default=(1, 1)),
        "pad": Param("shape", default=(0, 0)),
    }

    def list_arguments(self, params):
        return ["data", "data_pool", "data_pooled"]

    def _pooled_hw(self, params, pd):
        k = _pair(params["kernel"], "kernel")
        s = _pair(params["stride"], "stride")
        p = _pair(params["pad"], "pad")
        return _pool_out_hw(pd, k, s, p, name="Unpooling"), k, s, p

    def infer_shape(self, params, in_shapes):
        d, pd, pdd = in_shapes
        if pd is None:
            return in_shapes, [None], []
        if len(pd) != 4:
            raise MXNetError("Unpooling: data_pool must be NCHW 4D")
        (ph, pw), _, _, _ = self._pooled_hw(params, pd)
        expect = (pd[0], pd[1], ph, pw)
        if d is not None and tuple(d) != expect:
            raise MXNetError(
                "Unpooling: differing expected unpool size %s vs %s"
                % (tuple(d), expect)
            )
        if pdd is not None and tuple(pdd) != expect:
            raise MXNetError(
                "Unpooling: data_pooled shape %s does not match pooled size %s"
                % (tuple(pdd), expect)
            )
        return [expect, pd, expect], [pd], []

    def apply(self, octx, params, inputs, aux):
        x, pool_in, pooled = inputs
        pool_in, pooled = pool_in.detach(), pooled.detach()
        (ph, pw), k, s, p = self._pooled_hw(params, tuple(pool_in.shape))
        n, c, h, w = pool_in.shape
        eh, ew = _pool_overhang(tuple(pool_in.shape), (ph, pw), k, s, p)
        src = F.pad(pool_in, (p[1], p[1], p[0], p[0]))
        if eh or ew:
            src = F.pad(src, (0, ew, 0, eh), value=float("nan"))
        rows = [(ky, kx) for ky in range(k[0]) for kx in range(k[1])]

        def window(t, ky, kx):
            return t[:, :, ky:ky + (ph - 1) * s[0] + 1:s[0],
                     kx:kx + (pw - 1) * s[1] + 1:s[1]]

        eq = torch.stack([window(src, ky, kx) == pooled for ky, kx in rows])
        first = eq & (torch.cumsum(eq.to(torch.int32), dim=0) == 1)
        out = torch.zeros((n, c) + tuple(src.shape[2:]), dtype=x.dtype,
                          device=x.device)
        for i, (ky, kx) in enumerate(rows):
            window(out, ky, kx).add_(torch.where(first[i], x, 0.0))
        return [out[:, :, p[0]:p[0] + h, p[1]:p[1] + w]], []


register(Unpooling)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


class BatchNorm(OpDef):
    """`src/operator/batch_norm-inl.h` — batch normalization over axis 1.

    Outputs [output, mean, var] with one visible output; aux states
    moving_mean/moving_var updated with the reference's momentum rule.
    `fix_gamma` defaults True like the reference (a gamma of ones, so the
    gamma argument's gradient is zero).  Training backward differentiates
    through the batch statistics (autograd).  ``ghost_batch`` > 0 takes
    the statistics over sub-batches of that size; the moving statistics
    track the whole batch's moments.
    """

    name = "BatchNorm"
    params = {
        "eps": Param(float, default=1e-3),
        "momentum": Param(float, default=0.9),
        "fix_gamma": Param(bool, default=True),
        "use_global_stats": Param(bool, default=False),
        "ghost_batch": Param(int, default=0),
    }

    def list_arguments(self, params):
        return ["data", "gamma", "beta"]

    def list_outputs(self, params):
        return ["output", "mean", "var"]

    def num_visible_outputs(self, params):
        return 1

    def list_aux(self, params):
        return ["moving_mean", "moving_var"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None, None, None], [None, None]
        c = (d[1],)
        return [d, c, c], [d, c, c], [c, c]

    def apply(self, octx, params, inputs, aux):
        x, gamma, beta = inputs
        moving_mean, moving_var = aux
        axes = tuple(i for i in range(x.dim()) if i != 1)
        bshape = (1, -1) + (1,) * (x.dim() - 2)
        if params["fix_gamma"]:
            gamma = torch.ones_like(gamma)
        gb = int(params["ghost_batch"] or 0)
        # eps in the compute dtype, as the JAX op rounds it
        eps = float(torch.tensor(params["eps"], dtype=x.dtype))
        xhat = None  # normalized activations; affine applied once below
        if octx.is_train and not params["use_global_stats"]:
            if gb > 0 and x.shape[0] > gb and x.shape[0] % gb != 0:
                raise MXNetError(
                    "BatchNorm ghost_batch=%d does not divide batch %d — "
                    "the experiment would silently run full-batch BN"
                    % (gb, x.shape[0]))
            # batch statistics and the EMA accumulate in float32
            x32 = x.float()
            if gb > 0 and x.shape[0] > gb:
                g = x.shape[0] // gb
                xg = x32.reshape((g, gb) + tuple(x.shape[1:]))
                gaxes = tuple(i for i in range(xg.dim()) if i != 2)[1:]
                gmean = xg.mean(dim=gaxes)                      # (g, C)
                gvar = xg.var(dim=gaxes, correction=0)          # (g, C)
                mean = gmean.mean(dim=0)
                var = gvar.mean(dim=0) + gmean.var(dim=0, correction=0)
                gshape = (g, 1, -1) + (1,) * (x.dim() - 2)
                inv_g = torch.rsqrt(gvar.to(x.dtype).reshape(gshape) + eps)
                xhat = ((xg.to(x.dtype) - gmean.to(x.dtype).reshape(gshape))
                        * inv_g).reshape(x.shape)
            else:
                mean = x32.mean(dim=axes)
                var = x32.var(dim=axes, correction=0)
            m = params["momentum"]
            new_mean = (moving_mean.float() * m + mean.detach() * (1 - m)) \
                .to(moving_mean.dtype)
            new_var = (moving_var.float() * m + var.detach() * (1 - m)) \
                .to(moving_var.dtype)
            aux_updates = [new_mean, new_var]
        else:
            mean, var = moving_mean, moving_var
            aux_updates = [None, None]
        # normalize in the compute dtype (stats cast down at the use site)
        mean_c = mean.to(x.dtype)
        if xhat is None:
            inv = torch.rsqrt(var.to(x.dtype).reshape(bshape) + eps)
            xhat = (x - mean_c.reshape(bshape)) * inv
        out = xhat * gamma.to(x.dtype).reshape(bshape) \
            + beta.to(x.dtype).reshape(bshape)
        return [out, mean_c, var.to(x.dtype)], aux_updates


register(BatchNorm)


class LRN(OpDef):
    """`src/operator/lrn-inl.h` — local response norm across channels:
    out = x * (knorm + alpha/nsize * Σ_window x²)^(-beta)."""

    name = "LRN"
    params = {
        "alpha": Param(float, default=1e-4),
        "beta": Param(float, default=0.75),
        "knorm": Param(float, default=2.0),
        "nsize": Param(int, required=True),
    }

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        n = params["nsize"]
        half = n // 2
        c = x.shape[1]
        # the channel window's sum of squares, zero-padded as the JAX
        # op's reduce_window pads
        sq = F.pad(torch.square(x), (0, 0, 0, 0, half, n - 1 - half))
        ssum = sq[:, 0:c]
        for i in range(1, n):
            ssum = ssum + sq[:, i:i + c]
        scale = params["knorm"] + (params["alpha"] / n) * ssum
        return [x * torch.pow(scale, -params["beta"])], []


register(LRN)
