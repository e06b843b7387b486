"""The port's sampler against the JAX package's, on the CPU.

`mxnet_tpu_torch.serving.sampling` reproduces `jax.random`'s stream for
the serving sampler's key, ``fold_in(PRNGKey(seed), position)``, in
torch integer ops, so a seeded request at T > 0 draws the same tokens in
both packages.  The random words and uniforms must be bit-identical;
`sample_tokens` must pick the same token ids from the same logits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from mxnet_tpu_torch.serving import sampling as ts

SEEDS_POS = [(0, 0), (1, 5), (7, 31), (12345, 1000), (2 ** 31 - 1, 4095)]


def _key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(seed), pos)


@pytest.mark.parametrize("n", [1, 61, 1000])
def test_random_bits_equal_jax(n):
    seed = torch.tensor([s for s, _ in SEEDS_POS])
    pos = torch.tensor([p for _, p in SEEDS_POS])
    got = ts.random_bits(seed, pos, n).numpy()
    for i, (s, p) in enumerate(SEEDS_POS):
        want = np.asarray(jax.random.bits(_key(s, p), (n,), jnp.uint32))
        np.testing.assert_array_equal(got[i], want.astype(np.int64))


def test_uniform_equals_jax_bit_for_bit():
    tiny = float(np.finfo(np.float32).tiny)
    seed = torch.tensor([s for s, _ in SEEDS_POS])
    pos = torch.tensor([p for _, p in SEEDS_POS])
    got = ts.uniform(seed, pos, 257).numpy()
    assert got.dtype == np.float32
    for i, (s, p) in enumerate(SEEDS_POS):
        want = np.asarray(jax.random.uniform(_key(s, p), (257,), jnp.float32,
                                             minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(got[i], want)


def test_threefry_known_answer():
    """Threefry-2x32's published known-answer vector (Random123), the one
    `jax.random`'s own tests check."""
    x = ts.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert (int(x[0]), int(x[1])) == (0xC4923A9C, 0x483DF7A0)


def _rows(b, v, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, v) * 2).astype(np.float32)


def test_sample_tokens_equal_jax():
    """Per-row temperature / top-k / top-p / seed / position, vocab 61:
    greedy rows, plain T > 0, top-k alone, top-p alone, both, k = 1,
    k >= V and p = 1 (filters off)."""
    v = 61
    params = [  # (temperature, top_k, top_p, seed, newpos)
        (0.0, 0, 1.0, 3, 10), (0.8, 0, 1.0, 4, 11), (1.0, 5, 1.0, 5, 12),
        (0.7, 0, 0.9, 6, 13), (0.8, 50, 0.95, 7, 14), (1.3, 1, 0.5, 8, 15),
        (2.0, 100, 1.0, 9, 16), (0.5, 10, 0.3, 2 ** 31 - 1, 1023),
    ]
    temp, top_k, top_p, seed, newpos = (np.array(c) for c in zip(*params))
    for trial in range(4):
        logits = _rows(len(params), v, seed=trial)
        want = np.asarray(jax_sample_tokens(
            jnp.asarray(logits), jnp.asarray(temp, jnp.float32),
            jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32),
            jnp.asarray(seed, jnp.uint32), jnp.asarray(newpos + trial,
                                                       jnp.int32)))
        got = ts.sample_tokens(
            torch.from_numpy(logits), torch.tensor(temp, dtype=torch.float32),
            torch.tensor(top_k), torch.tensor(top_p, dtype=torch.float32),
            torch.tensor(seed), torch.tensor(newpos + trial))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sample_tokens_draws_vary_with_position_and_respect_top_k():
    v = 61
    logits = torch.from_numpy(np.tile(_rows(1, v, seed=9), (64, 1)))
    ones = torch.ones(64)
    k = torch.full((64,), 3)
    got = ts.sample_tokens(logits, ones, k, ones, torch.full((64,), 11),
                           torch.arange(64))
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    assert set(got.tolist()) <= top3 and len(set(got.tolist())) > 1


def test_greedy_takes_first_index_on_ties():
    logits = torch.zeros(2, 7)
    logits[0, [2, 5]] = 1.0
    logits[1, [0, 6]] = 3.0
    zero = torch.zeros(2)
    got = ts.sample_tokens(logits, zero, torch.zeros(2, dtype=torch.long),
                           torch.ones(2), torch.zeros(2, dtype=torch.long),
                           torch.zeros(2, dtype=torch.long))
    assert got.tolist() == [2, 0]
    want = jax_sample_tokens(jnp.asarray(logits.numpy()), jnp.zeros(2),
                             jnp.zeros(2, jnp.int32), jnp.ones(2),
                             jnp.zeros(2, jnp.uint32),
                             jnp.zeros(2, jnp.int32))
    assert np.asarray(want).tolist() == [2, 0]


def test_top_p_keeps_the_mass_strictly_below_p():
    """Logits (log 2, 0, 0) give the exact probabilities (0.5, 0.25, 0.25),
    so the mass before token 1 is exactly 0.5: top_p = 0.5 drops it (JAX
    compares with <), and every draw is token 0.  (With <= tokens 1 and 2
    would both survive, as ties at the threshold are kept.)"""
    n = 16
    logits = np.tile(np.array([np.log(2), 0, 0], np.float32), (n, 1))
    args = (np.ones(n, np.float32), np.zeros(n, np.int64),
            np.full(n, 0.5, np.float32), np.arange(n), np.arange(n))
    got = ts.sample_tokens(torch.from_numpy(logits),
                           *(torch.from_numpy(a) for a in args))
    want = jax_sample_tokens(jnp.asarray(logits), jnp.asarray(args[0]),
                             jnp.asarray(args[1], jnp.int32),
                             jnp.asarray(args[2]),
                             jnp.asarray(args[3], jnp.uint32),
                             jnp.asarray(args[4], jnp.int32))
    assert got.tolist() == [0] * n == np.asarray(want).tolist()
