"""Random numbers of the port: `jax.random`'s threefry, bit for bit.

A port of `mxnet_tpu/random.py`: a process-global root key (set by
`seed`) hands out subkeys (`next_key`), and `uniform`/`normal` draw from
them.  The keys and bits are those of `jax.random` under its partitionable
threefry (``jax_threefry_partitionable=True``, the default of the JAX
version this was written against), so the same seed gives the same keys,
the same `uniform` draws and, through `initializer.Uniform`, the same
initial parameters in both packages:

* ``PRNGKey(s)`` = (0, s & 0xFFFFFFFF): JAX without 64-bit types (its
  default) keeps the low 32 bits of the seed;
* ``fold_in(k, d)`` = threefry2x32(k, (0, d));
* ``split(k, n)``: key i is threefry2x32(k, (0, i));
* ``bits(k, shape)``: word i (row-major) is y1 ^ y2 of threefry2x32(k,
  (0, i));
* ``uniform``: bitcast((bits >> 9) | 0x3f800000) - 1, then
  ``max(lo, u * (hi - lo) + lo)`` in float32;
* ``randint`` (int32): two bit draws from ``split(k)``, reduced mod the
  span as JAX's ``_randint`` does; ``bernoulli``: ``uniform < p``.

Threefry runs in int64 tensors masked to 32 bits, on the device asked for
(so a large parameter is drawn on the card).  A key is a pair of uint32
words: Python ints, or int64 tensors that broadcast together.  `normal`
is ``sqrt(2) * erfinv(u)`` as in JAX, but torch's `erfinv` is not XLA's,
so its draws agree with JAX only to float32 rounding.  The graph
function's operator generators (`torch.Generator`) are seeded from these
keys; their own draws are PyTorch's.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .base import check_shape
from .context import resolve

__all__ = ["seed", "next_key", "get_state", "set_state", "prng_key",
           "fold_in", "split", "threefry2x32", "random_bits",
           "uniform_from_bits", "randint", "bernoulli", "uniform", "normal",
           "normal_from_key", "key_seed"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_state = threading.local()
_DEFAULT_SEED = 0


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), as `jax.random`'s.  All four
    arguments are int64 tensors (or ints) holding uint32 values and
    broadcast together; returns the two output words likewise."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def prng_key(seed_value):
    """`jax.random.PRNGKey(seed)` as JAX computes it by default (64-bit
    types off): the low 32 bits of the seed, high word 0."""
    return (0, int(seed_value) & _MASK)


def fold_in(key, data):
    """`jax.random.fold_in(key, data)` for an int (or int64 tensor) data."""
    return threefry2x32(key[0], key[1], 0, data & _MASK)


def split(key, num=2):
    """`jax.random.split(key, num)` as a list of ``num`` keys."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key, shape, device=None):
    """`jax.random.bits(key, shape)` (uint32 words, as int64): word i of
    the row-major order is y1 ^ y2 of threefry2x32(key, (0, i)).  The
    words of ``key`` may be int64 tensors of shape (b, 1), for b keys
    at once."""
    n = int(np.prod(check_shape(shape)))
    if isinstance(key[0], torch.Tensor):
        device = key[0].device
    iota = torch.arange(n, dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(key[0], key[1], 0, iota)
    bits = y1 ^ y2
    return bits.reshape(bits.shape[:-1] + tuple(check_shape(shape)))


def uniform_from_bits(bits, minval, maxval):
    """`jax.random.uniform`'s float32 from its bits: the 23 high bits as a
    mantissa in [1, 2), minus 1, scaled to [minval, maxval) in float32.

    XLA fuses ``u * (hi - lo) + lo`` into one multiply-add, rounded once.
    The product of two float32 values is exact in float64, so the sum is
    taken there and rounded to float32: that equals the fused result
    except where the float64 sum lands exactly on a float32 rounding
    midpoint (none in 4M draws of the tests)."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    # lo and hi - lo in float32, as Python floats (exact): no tensor made
    # from a host value, so no copy to the card and no sync
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    scaled = floats.double() * span + float(lo)
    return scaled.float().clamp_min(float(lo))


def _mul32(a, b):
    """a * b mod 2**32 for uint32 values held in int64, as uint32
    multiplication wraps (the full product may not fit in int64)."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _MASK


def randint(key, shape, minval, maxval, device=None):
    """`jax.random.randint(key, shape, minval, maxval)` bit for bit, in
    int32 (JAX's default integer without 64-bit types).  As JAX's
    ``_randint``: words hi, lo from the two keys of ``split(key)``, span
    = maxval - minval as uint32 (1 where maxval <= minval), m = (2**16 mod
    span)**2 mod span, and minval + ((hi mod span) * m + lo mod span) mod
    2**32 mod span.  ``minval``/``maxval`` are ints or int tensors that
    broadcast to ``shape``."""
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, hi.device)
    lim = (-2 ** 31, 2 ** 31 - 1)
    minval = torch.as_tensor(minval, dtype=torch.int64,
                             device=hi.device).clamp(*lim)
    maxval = torch.as_tensor(maxval, dtype=torch.int64,
                             device=hi.device).clamp(*lim)
    span = torch.where(maxval <= minval, 1, (maxval - minval) & _MASK)
    mult = (2 ** 16) % span
    mult = _mul32(mult, mult) % span
    offset = ((_mul32(hi % span, mult) + lo % span) & _MASK) % span
    out = minval + offset  # int32 arithmetic, wrapped
    return (((out - lim[0]) & _MASK) + lim[0]).to(torch.int32)


def bernoulli(key, p=0.5, shape=None, device=None):
    """`jax.random.bernoulli(key, p, shape)` bit for bit (its default 'low'
    mode): float32 ``uniform(key, shape) < p``."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    if shape is None:
        shape = tuple(p.shape)
    u = uniform_from_bits(random_bits(key, shape, device), 0.0, 1.0)
    return u < p.to(u.device)


def _root():
    if not hasattr(_state, "key"):
        _state.key = prng_key(_DEFAULT_SEED)
    return _state.key


def seed(seed_state):
    """Seed all generators (`mx.random.seed`): the root key of `next_key`
    and, as the JAX package does, numpy's global generator."""
    global _DEFAULT_SEED
    _DEFAULT_SEED = int(seed_state)
    _state.key = prng_key(_DEFAULT_SEED)
    np.random.seed(_DEFAULT_SEED & 0x7FFFFFFF)


def next_key():
    """Split off a fresh subkey from the global stream (the JAX package's
    ``_state.key, sub = jax.random.split(key)``)."""
    _state.key, sub = split(_root())
    return sub


def get_state():
    """Every host-visible random state, for an exact checkpoint and
    resume: the root key (as the JAX package's uint32 pair) and numpy's
    global generator (the iterators' shuffles).  A picklable dict in the
    JAX package's layout, so either package restores the other's."""
    k = _root()
    return {"jax_key": np.array([int(k[0]), int(k[1])], np.uint32),
            "np_state": np.random.get_state()}


def set_state(state):
    """Restore a `get_state` snapshot: the draws go on from where it was
    taken."""
    k = np.asarray(state["jax_key"]).astype(np.uint64).reshape(-1)
    _state.key = (int(k[0]), int(k[1]))
    np.random.set_state(state["np_state"])


def key_seed(key):
    """A 63-bit seed for a `torch.Generator`, from a key's two words."""
    return ((int(key[0]) << 32) | int(key[1])) & (2 ** 63 - 1)


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, dtype=torch.float32):
    """Draw from U[low, high) (`mx.nd.uniform`) with the next key, on
    ``ctx`` (the card unless asked otherwise): the JAX package's draw bit
    for bit in float32."""
    bits = random_bits(next_key(), shape, resolve(ctx))
    u = uniform_from_bits(bits, low, high)
    return u.to(dtype)


def normal_from_key(key, shape, device=None):
    """`jax.random.normal(key, shape)` in float32: ``sqrt(2) * erfinv(u)``
    for u uniform in (-1, 1) from ``key``'s bits."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(1.0)))
    u = uniform_from_bits(random_bits(key, shape, device), lo, 1.0)
    return math.sqrt(2) * torch.erfinv(u)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, dtype=torch.float32):
    """Draw from N(loc, scale^2) (`mx.nd.normal`) with the next key."""
    z = normal_from_key(next_key(), shape, resolve(ctx))
    return (loc + scale * z).to(dtype)
