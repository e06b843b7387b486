"""Tensor-manipulation ops of the LM path.

A port of `mxnet_tpu/ops/tensor.py` `Reshape`: ``shape`` (or the
reference's ``target_shape``) with MXNet's codes, 0 = copy this dim of the
input and -1 = infer it.  `torch.reshape` returns a view wherever the
strides allow, as the JAX reshape fuses away.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .registry import OpDef, Param, register


class Reshape(OpDef):
    """`src/operator/reshape-inl.h`.  Accepts `target_shape` (reference) or
    `shape` with 0=copy-dim and -1=infer extensions."""

    name = "Reshape"
    params = {
        "target_shape": Param("shape", default=None),
        "shape": Param("shape", default=None),
    }

    def _resolve(self, params, d):
        tgt = params["shape"] or params["target_shape"]
        if tgt is None:
            raise MXNetError("Reshape: need target_shape or shape")
        tgt = list(tgt)
        for i, v in enumerate(tgt):
            if v == 0:
                tgt[i] = d[i]
        if -1 in tgt:
            known = int(np.prod([v for v in tgt if v != -1]))
            tgt[tgt.index(-1)] = int(np.prod(d)) // max(known, 1)
        if int(np.prod(tgt)) != int(np.prod(d)):
            raise MXNetError("Reshape: size mismatch %s -> %s" % (d, tgt))
        return tuple(tgt)

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d], [self._resolve(params, d)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        return [x.reshape(self._resolve(params, tuple(x.shape)))], []


register(Reshape)
