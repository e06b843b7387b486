"""Token sampling for the serving engine, in plain torch.

A port of `mxnet_tpu/serving/sampling.py`.  Greedy is temperature <= 0
(argmax, first index on ties and the first NaN of a row with one, as
`jnp.argmax`); otherwise temperature, then the top-k mask, then the
nucleus (top-p) mask off one descending sort, then a categorical draw.

The draw reproduces the JAX package's random stream, so a seeded request
samples the same tokens in both.  The key for the token that will occupy
absolute position P of a request with seed s is
``fold_in(PRNGKey(s), P)``, and ``categorical`` is Gumbel-max over
``uniform(tiny, 1)``.  Under JAX's partitionable threefry (the default
of the JAX version this was written against) that is:

* ``PRNGKey(s)`` = (0, s); ``fold_in(k, P)`` = threefry2x32(k, (0, P));
* the V random words are ``y1 ^ y2`` of threefry2x32(key, (0, iota(V)));
* uniform = bitcast((bits >> 9) | 0x3f800000) - 1, then
  ``max(tiny, u * (1 - tiny) + tiny)`` in float32;
* token = argmax(-log(-log(uniform)) + masked logits).

Threefry (`mxnet_tpu_torch.random`) runs in int64 tensors masked to 32
bits, so it runs wherever the logits are.  It is not a kernel: the JAX
sampler has no Pallas.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..random import threefry2x32

__all__ = ["argmax", "sample_tokens", "threefry2x32", "random_bits",
           "uniform"]

_TINY = float(torch.finfo(torch.float32).tiny)


def random_bits(seed, pos, n):
    """(b, n) uint32 words (as int64) of ``random.bits(fold_in(
    PRNGKey(seed), pos), (n,))`` for int tensors seed, pos of shape (b,)."""
    seed = seed.long()[:, None] & 0xFFFFFFFF
    pos = pos.long()[:, None]
    return _random.random_bits(_random.fold_in((0, seed), pos), (n,))


def uniform(seed, pos, n):
    """(b, n) float32 ``random.uniform(key, (n,), minval=tiny, maxval=1)``
    for the same key as `random_bits`."""
    return _random.uniform_from_bits(random_bits(seed, pos, n), _TINY, 1.0)


def _mask_top_k_top_p(scaled, top_k, top_p):
    """Top-k then nucleus masks off one descending sort; entries below
    the smallest surviving logit become -inf.  A k-masked tail entry can
    never survive the nucleus test (the ``isfinite`` guard)."""
    v = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k = top_k.long().clamp(0, v)
    k_eff = torch.where(k > 0, k, v)[:, None]
    cols = torch.arange(v, device=scaled.device)[None, :]
    desc_k = torch.where(cols < k_eff, desc, float("-inf"))
    probs = torch.softmax(desc_k, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    p_eff = top_p.float().clamp(0.0, 1.0)[:, None]
    keep = ((csum - probs) < p_eff) & torch.isfinite(desc_k)
    thr = torch.where(keep, desc_k, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(scaled >= thr, scaled, float("-inf"))


def argmax(x):
    """``jnp.argmax`` over the last axis: the first NaN of a row that has
    one (a request whose prompt embedded as NaN), else the first
    maximum."""
    nan = torch.isnan(x)
    first_nan = nan.to(torch.uint8).argmax(dim=-1)
    return torch.where(nan.any(dim=-1), first_nan, x.argmax(dim=-1))


def sample_tokens(logits, temperature, top_k, top_p, seed, newpos):
    """One token per row from per-row sampling parameters.

    logits (b, V); temperature (b,) float, <= 0 selects greedy; top_k (b,)
    int, <= 0 disables; top_p (b,) float, >= 1 disables; seed (b,) int,
    the request's RNG identity; newpos (b,) int, the absolute position the
    sampled token will occupy.  Returns (b,) int64 token ids."""
    logits = logits.float()
    greedy = argmax(logits)
    temperature = temperature.float()
    t = torch.where(temperature > 0, temperature, 1.0)
    masked = _mask_top_k_top_p(logits / t[:, None], top_k, top_p)
    gumbel = -torch.log(-torch.log(uniform(seed, newpos, logits.shape[-1])))
    sampled = argmax(gumbel + masked)
    return torch.where(temperature > 0, sampled, greedy)
