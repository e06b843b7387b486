"""PyTorch/CUDA port of mxnet_tpu, slice by slice.

This package sits beside the JAX package `mxnet_tpu`, keeps its module
names where that helps a reader find the counterpart, and imports
neither JAX nor anything of `mxnet_tpu`.  Two slices exist:

* serving the transformer LM (`serving.ServingEngine` over
  `serving.TransformerKVModel`);
* training it: `models.get_transformer_lm` builds the symbol graph
  (`symbol`, the ops of `ops`), `executor._build_graph_fn` runs it, and
  `parallel.SPMDTrainer` steps forward, backward and the optimizer update
  on one device, with `random` and `initializer` drawing the JAX
  package's initial parameters bit for bit.

Hand-written CUDA kernels for Hopper carry both paths: LayerNorm forward
and backward, flash attention forward, dq and dk/dv, and the fused
projection + softmax-CE head of ``fused_head=True`` (statistics forward,
single-pass forward, dW/db, dx) (`ops/pallas_kernels/`, sources under
`csrc/`).  `optimizer.stochastic_round_bf16` stores Adam's second moment
in bf16 for ``SPMDTrainer(adam_v_dtype='bfloat16')``.

Entry points run on ``cuda:0`` unless given ``ctx="cpu"``; without a
GPU and without that argument they raise (`context.resolve`).

    import mxnet_tpu_torch as mx
    mx.random.seed(0)
    net = mx.models.get_transformer_lm(vocab_size=32768, seq_len=1024,
                                       num_layers=12, num_heads=12,
                                       num_embed=768)
    trainer = mx.parallel.SPMDTrainer(
        net, data_shapes={"data": (32, 1024), "softmax_label": (32, 1024)},
        optimizer="adam", lr=1e-3, wd=0.0, dtype="bfloat16")
    outputs = trainer.step({"data": tokens, "softmax_label": labels})
"""
from __future__ import annotations

from . import attribute, initializer, models, name, ops, optimizer
from . import parallel, random
from . import symbol
from . import symbol as sym
from .attribute import AttrScope
from .base import MXNetError
from .context import resolve
from .parallel import SPMDTrainer, load_params
from .symbol import Symbol

init = initializer

__all__ = ["AttrScope", "MXNetError", "SPMDTrainer", "Symbol", "attribute",
           "init", "initializer", "load_params", "models", "name", "ops",
           "optimizer", "parallel", "random", "resolve", "sym", "symbol"]
