"""Neural-network layer ops of the LM path.

A port of the four `mxnet_tpu/ops/nn.py` ops the transformer LM reaches:
`Activation`, `FullyConnected`, `Dropout` and `Embedding`, with the JAX
package's parameters, argument lists and shape rules.  Bodies are torch
calls; the large matrix products go to `F.linear` (cuBLAS on the card),
as the JAX package leaves them to XLA.

* `Activation`'s gelu is the tanh form: `jax.nn.gelu` defaults to
  ``approximate=True``, torch's `F.gelu` to the erf form.
* `Dropout` is inverted (scaled at training) and draws its mask from the
  op's `torch.Generator`; it cannot give the JAX package's bits.
* `Embedding`'s backward is autograd's scatter-add into the table: on the
  card its order of summation may differ from the CPU's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpDef, Param, register


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
