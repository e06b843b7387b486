"""Elementwise and layout ops of the LM path.

A port of the part of `mxnet_tpu/ops/elementwise.py` that the transformer
LM reaches: `_Plus` (what `Symbol.__add__` builds) and `_PlusScalar`,
`broadcast_plus`, and `transpose`.  Each is one torch call; `transpose`
returns a view, so the attention kernels read its strides with no copy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import OpDef, Param, register, register_binary, register_scalar

register_binary("_Plus", torch.add, aliases=["_plus", "elemwise_add"])
register_scalar("_PlusScalar", torch.add, aliases=["_plus_scalar"])


class _BroadcastPlus(OpDef):
    """Numpy-broadcasting add (later-mxnet `broadcast_*` family; it adds
    the positional embedding to a (batch, seq, embed) activation)."""

    name = "broadcast_plus"

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
        return [inputs[0] + inputs[1]], []


register(_BroadcastPlus, aliases=("broadcast_add",))


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
