"""Optimizer helpers of the port.

A port of the part of `mxnet_tpu/optimizer.py` that the fused trainer
needs: `stochastic_round_bf16`, which stores Adam's second moment in
bfloat16 (``SPMDTrainer(adam_v_dtype='bfloat16')``).  The optimizer
classes wait for a later slice.
"""
from __future__ import annotations

import torch

from .random import random_bits

__all__ = ["stochastic_round_bf16"]


def stochastic_round_bf16(x, key):
    """Stochastically round float32 ``x`` to bfloat16, bit for bit as the
    JAX package does with the same key.

    With beta2 = 0.999 the per-step relative change of Adam's second
    moment (~1e-3) sits below bf16's ~2**-8 ulp, so round-to-nearest
    would stall the average.  Adding 16 uniform random bits below the bf16
    mantissa before truncating makes the rounding unbiased.  The bits are
    the low 16 of `random.random_bits` (``jax.random.bits`` in uint16 is
    the low half of its uint32 words at the same positions).

    ``key`` is a key of `random`; its words may be int64 tensors of shape
    (b, 1), and then ``x`` is (b, ...) and row i is rounded with key i.
    """
    batched = isinstance(key[0], torch.Tensor) and key[0].dim() == 2
    shape = tuple(x.shape[1:]) if batched else tuple(x.shape)
    rnd = random_bits(key, shape, x.device) & 0xFFFF
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    hi = (bits + rnd) & 0xFFFF0000
    # back to the int32 bit pattern (two's complement) of the float32
    hi = torch.where(hi >= 2 ** 31, hi - 2 ** 32, hi).to(torch.int32)
    return hi.view(torch.float32).to(torch.bfloat16)
