"""PyTorch/CUDA port of mxnet_tpu, slice by slice.

This package sits beside the JAX package `mxnet_tpu`, keeps its module
names where that helps a reader find the counterpart, and imports
neither JAX nor anything of `mxnet_tpu`.  The first slice serves the
transformer LM (`serving.ServingEngine` over
`serving.TransformerKVModel`) with two hand-written CUDA kernels for
Hopper: the LayerNorm forward and the flash-attention forward
(`ops/pallas_kernels/`, sources under `csrc/`).

Entry points run on ``cuda:0`` unless given ``ctx="cpu"``; without a
GPU and without that argument they raise (`context.resolve`).
"""
from __future__ import annotations

from .base import MXNetError
from .context import resolve

__all__ = ["MXNetError", "resolve"]
