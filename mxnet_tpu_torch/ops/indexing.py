"""Gathers with the JAX package's out-of-range semantics.

`jnp.take` and `jnp.take_along_axis` (the JAX package's Embedding, the
pick of `softmax_cross_entropy`, the serving embedding) run in fill
mode: an index in [-n, 0) wraps by n, and one outside [-n, n) gives NaN
(for a float table) and takes no gradient.  A torch gather would raise
on such an index on the CPU and trip a device-side assert on the card,
which ends the process's CUDA context.  Here every index is wrapped or
clamped into range for the gather, and the rows of the indices out of
range are then replaced by NaN with `torch.where`, so the gradient
through the ``where`` drops them as the JAX gather's does.  No value is
read on the host.  Float indices truncate to int32 first, as
``astype(jnp.int32)`` does.
"""
from __future__ import annotations

import torch

__all__ = ["as_index", "in_range", "take_rows", "pick"]


def as_index(idx):
    """Indices as the JAX package casts them: int32 (floats truncate
    toward zero), returned as int64 for torch's gathers."""
    if idx.dtype != torch.int32:
        idx = idx.to(torch.int32)
    return idx.long()


def in_range(idx, n):
    """(index wrapped and clamped into [0, n), whether it was in
    [-n, n)) for int64 ``idx``."""
    valid = (idx >= -n) & (idx < n)
    wrapped = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return wrapped, valid


def take_rows(table, idx):
    """``jnp.take(table, idx, axis=0)``: table[idx] with the rows of
    out-of-range indices NaN (``idx`` any int or float tensor)."""
    wrapped, valid = in_range(as_index(idx), table.shape[0])
    rows = torch.nn.functional.embedding(wrapped, table)
    return torch.where(valid[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


def pick(x, idx):
    """``jnp.take_along_axis(x, idx[:, None], axis=1)[:, 0]`` for a (b, n)
    ``x``: NaN where an index is out of range."""
    wrapped, valid = in_range(as_index(idx).reshape(-1), x.shape[1])
    got = x.gather(1, wrapped[:, None])[:, 0]
    return torch.where(valid, got, torch.full((), float("nan"),
                                              dtype=x.dtype,
                                              device=x.device))
