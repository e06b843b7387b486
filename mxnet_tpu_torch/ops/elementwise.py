"""Elementwise, scalar, reduction and matrix-product ops.

A port of `mxnet_tpu/ops/elementwise.py` (the reference's
`elementwise_binary_op-inl.h`, `elementwise_binary_scalar_op-inl.h`,
`elementwise_unary_op-inl.h`, `broadcast_reduce_op-inl.h` and the
NDArray-side ops of `src/ndarray/ndarray.cc`), under the same names and
aliases.  Each is one torch call, or a few; `transpose` returns a view,
so the attention kernels read its strides with no copy.

A scalar op with ``reverse`` computes ``fn(scalar, x)`` (`_RMinusScalar`
is ``scalar - x``).  The reductions reduce the whole tensor to shape (1,)
unless given ``axis``.  `argmax_channel` returns the index in the
input's dtype.
"""
from __future__ import annotations

import operator

import numpy as np
import torch

from ..base import MXNetError
from .registry import (OpDef, Param, register, register_binary,
                       register_scalar, register_unary)

# -- binary (elementwise_binary_op-inl.h:213-231) ------------------------
register_binary("_Plus", torch.add, aliases=["_plus", "elemwise_add"])
register_binary("_Minus", torch.sub, aliases=["_minus"])
register_binary("_Mul", torch.mul, aliases=["_mul"])
register_binary("_Div", torch.div, aliases=["_div"])
register_binary("_Power", torch.pow, aliases=["_power"])
register_binary("_Maximum", torch.maximum, aliases=["_maximum"])
register_binary("_Minimum", torch.minimum, aliases=["_minimum"])

# -- scalar (elementwise_binary_scalar_op-inl.h) -------------------------
register_scalar("_PlusScalar", operator.add, aliases=["_plus_scalar"])
register_scalar("_MinusScalar", operator.sub, aliases=["_minus_scalar"])
register_scalar("_RMinusScalar", operator.sub, reverse=True,
                aliases=["_rminus_scalar"])
register_scalar("_MulScalar", operator.mul, aliases=["_mul_scalar"])
register_scalar("_DivScalar", operator.truediv, aliases=["_div_scalar"])
register_scalar("_RDivScalar", operator.truediv, reverse=True,
                aliases=["_rdiv_scalar"])
register_scalar("_PowerScalar", operator.pow, aliases=["_power_scalar"])
register_scalar("_RPowerScalar", operator.pow, reverse=True,
                aliases=["_rpower_scalar"])
register_scalar("_MaximumScalar", lambda x, s: torch.clamp(x, min=s),
                aliases=["_maximum_scalar"])
register_scalar("_MinimumScalar", lambda x, s: torch.clamp(x, max=s),
                aliases=["_minimum_scalar"])

# -- unary (elementwise_unary_op-inl.h; functors in mshadow_op.h) --------
register_unary("abs", torch.abs)
register_unary("sign", torch.sign)
register_unary("round", torch.round)
register_unary("ceil", torch.ceil)
register_unary("floor", torch.floor)
register_unary("square", torch.square)
register_unary("sqrt", torch.sqrt)
register_unary("rsqrt", torch.rsqrt)
register_unary("exp", torch.exp)
register_unary("log", torch.log)
register_unary("cos", torch.cos)
register_unary("sin", torch.sin)
register_unary("negative", torch.neg)
register_unary("sigmoid", torch.sigmoid)
register_unary("relu", torch.relu)
register_unary("tanh", torch.tanh)


class _Clip(OpDef):
    """clip(src, a_min, a_max) (`src/ndarray/ndarray.cc` Clip / simple op)."""

    name = "clip"
    params = {
        "a_min": Param(float, required=True),
        "a_max": Param(float, required=True),
    }

    def apply(self, octx, params, inputs, aux):
        return [torch.clamp(inputs[0], params["a_min"], params["a_max"])], []


register(_Clip)


class _Dot(OpDef):
    """2-D matrix product (`ndarray.cc` Dot; mshadow `dot`)."""

    name = "dot"

    def list_arguments(self, params):
        return ["lhs", "rhs"]

    def infer_shape(self, params, in_shapes):
        a, b = in_shapes
        if a is None or b is None:
            return in_shapes, [None], []
        if len(a) != 2 or len(b) != 2 or a[1] != b[0]:
            raise MXNetError("dot: incompatible shapes %s %s" % (a, b))
        return [a, b], [(a[0], b[1])], []

    def apply(self, octx, params, inputs, aux):
        return [torch.mm(inputs[0], inputs[1])], []


register(_Dot)


class _BatchDot(OpDef):
    """Batched matmul over leading dim."""

    name = "batch_dot"

    def list_arguments(self, params):
        return ["lhs", "rhs"]

    def infer_shape(self, params, in_shapes):
        a, b = in_shapes
        if a is None or b is None:
            return in_shapes, [None], []
        if len(a) != 3 or len(b) != 3 or a[0] != b[0] or a[2] != b[1]:
            raise MXNetError("batch_dot: incompatible shapes %s %s" % (a, b))
        return [a, b], [(a[0], a[1], b[2])], []

    def apply(self, octx, params, inputs, aux):
        return [torch.bmm(inputs[0], inputs[1])], []


register(_BatchDot)


class _BroadcastBinary(OpDef):
    """Numpy-broadcasting binary op (later-mxnet `broadcast_*` family;
    it adds the positional embedding to a (batch, seq, embed)
    activation)."""

    def __init__(self, name, fn):
        self.name = name
        self._fn = fn
        self.params = {}

    def list_arguments(self, params):
        return ["lhs", "rhs"]

    def infer_shape(self, params, in_shapes):
        a, b = in_shapes
        if a is None or b is None:
            return in_shapes, [None], []
        try:
            out = tuple(np.broadcast_shapes(a, b))
        except ValueError:
            raise MXNetError(
                "%s: shapes %s and %s do not broadcast" % (self.name, a, b))
        return [a, b], [out], []

    def apply(self, octx, params, inputs, aux):
        return [self._fn(inputs[0], inputs[1])], []


register(_BroadcastBinary("broadcast_plus", torch.add),
         aliases=("broadcast_add",))
register(_BroadcastBinary("broadcast_minus", torch.sub),
         aliases=("broadcast_sub",))
register(_BroadcastBinary("broadcast_mul", torch.mul))
register(_BroadcastBinary("broadcast_div", torch.div))


# -- reductions (broadcast_reduce_op-inl.h:143-181) ----------------------


class _Reduce(OpDef):
    """Whole-tensor reduction to shape (1,), reference semantics; with an
    optional ``axis`` (and ``keepdims``)."""

    params = {
        "axis": Param("shape", default=None),
        "keepdims": Param(bool, default=False),
    }

    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        axis = params["axis"]
        if axis is None:
            return [d], [(1,)], []
        out = tuple(
            (1 if params["keepdims"] else None) if i in axis else s
            for i, s in enumerate(d)
        )
        out = tuple(s for s in out if s is not None)
        return [d], [out if out else (1,)], []

    def apply(self, octx, params, inputs, aux):
        axis, x = params["axis"], inputs[0]
        if axis is None:
            return [self._fn(x, tuple(range(x.dim())), False).reshape(1)], []
        out = self._fn(x, tuple(axis), params["keepdims"])
        return [out.reshape(1) if out.dim() == 0 else out], []


register(_Reduce("sum", lambda x, ax, kd: torch.sum(x, ax, kd)),
         aliases=["sum_axis"])
register(_Reduce("max", lambda x, ax, kd: torch.amax(x, ax, kd)),
         aliases=["max_axis"])
register(_Reduce("min", lambda x, ax, kd: torch.amin(x, ax, kd)),
         aliases=["min_axis"])
register(_Reduce("norm", lambda x, ax, kd: torch.sqrt(
    torch.sum(torch.square(x), ax, kd))))


class _ArgmaxChannel(OpDef):
    """argmax over axis 1, per row (`broadcast_reduce_op-inl.h`
    argmax_channel).  Input (n, c) -> output (n,)."""

    name = "argmax_channel"

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if len(d) != 2:
            raise MXNetError("argmax_channel: input must be 2D")
        return [d], [(d[0],)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        return [torch.argmax(x, dim=1).to(x.dtype)], []


register(_ArgmaxChannel)


class _Transpose(OpDef):
    name = "transpose"
    params = {"axes": Param("shape", default=None)}

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        axes = params["axes"] or tuple(reversed(range(len(d))))
        return [d], [tuple(d[a] for a in axes)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        axes = params["axes"] or tuple(reversed(range(x.dim())))
        return [x.permute(axes)], []


register(_Transpose)


class _SmoothL1(OpDef):
    """smooth_l1 with sigma (a later simple op; detection heads)."""

    name = "smooth_l1"
    params = {"scalar": Param(float, default=1.0)}

    def apply(self, octx, params, inputs, aux):
        sigma2 = params["scalar"] ** 2
        x = inputs[0]
        out = torch.where(torch.abs(x) < 1.0 / sigma2,
                          0.5 * sigma2 * torch.square(x),
                          torch.abs(x) - 0.5 / sigma2)
        return [out], []


register(_SmoothL1)
