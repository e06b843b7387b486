"""The port's serving slice against the JAX package's, on the CPU.

`mxnet_tpu_torch.serving` is held to `mxnet_tpu.serving` at the size of
`tests/test_serving.py` (V, S, L, H, E = 61, 32, 2, 2, 32) with the same
numpy weights:

* `TransformerKVModel` programs (prefill, decode, paged prefill and
  decode): logits and K/V within 2e-5 in float32, the bound
  `tests/test_serving.py` holds the JAX programs to (float32 sums in
  another order, through 2 layers, on logits of magnitude ~1-10);
* the engine: batched runs equal solo runs bit for bit (paged and slot),
  greedy tokens equal the JAX engine's where the test first shows every
  step's top-1/top-2 logit margin is far above that bound, the stop rules,
  and preemption replaying exactly.

Everything runs with ``ctx="cpu"``, so the kernels' plain versions run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving import TransformerKVModel as JModel
from mxnet_tpu.serving.paged import BlockAllocator as JBlockAllocator
from mxnet_tpu.serving.paged import pool_bytes as jpool_bytes
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import resolve
from mxnet_tpu_torch.serving import (TRASH_BLOCK, BlockAllocator,
                                     ServeBlocksExhausted, ServingEngine,
                                     TransformerKVModel, pool_bytes)

V, S, L, H, E = 61, 32, 2, 2, 32
ATOL = 2e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    return (JModel(V, S, num_layers=L, num_heads=H, num_embed=E),
            TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E))


@pytest.fixture(scope="module")
def params(models):
    return models[0].init_params(np.random.RandomState(7))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# -- parameters and entry points --------------------------------------------


def test_init_params_are_the_jax_draws(models):
    jm, tm = models
    assert tm.param_shapes() == jm.param_shapes()
    a = jm.init_params(np.random.RandomState(3), scale=0.1)
    b = tm.init_params(np.random.RandomState(3), scale=0.1)
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])


def test_params_from_jax_is_a_checked_copy(models, params):
    _, tm = models
    tp = tm.params_from_jax(params, "cpu")
    for name, arr in params.items():
        assert tp[name].dtype == torch.float32 and tp[name].device == CPU
        np.testing.assert_array_equal(tp[name].numpy(), arr)
    assert tm.params_from_jax(params, "cpu", torch.bfloat16)[
        "embed_weight"].dtype == torch.bfloat16
    bad = dict(params)
    del bad["layer0_q_weight"]
    with pytest.raises(MXNetError, match="missing"):
        tm.params_from_jax(bad, "cpu")
    with pytest.raises(MXNetError, match="unknown"):
        tm.params_from_jax(dict(params, extra=np.zeros(3)), "cpu")
    with pytest.raises(MXNetError, match="shape"):
        tm.params_from_jax(dict(params, pred_bias=np.zeros(V + 1)), "cpu")


def test_entry_points_run_on_cuda_unless_asked(models, params):
    """No quiet CPU fallback: without a card, every entry point that is
    not given the CPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    _, tm = models
    assert resolve("cpu") == CPU and resolve(CPU) == CPU
    with pytest.raises(MXNetError, match="no CUDA"):
        resolve(None)
    with pytest.raises(MXNetError, match="no CUDA"):
        tm.params_from_jax(params)
    with pytest.raises(MXNetError, match="no CUDA"):
        tm.init_cache(2)
    with pytest.raises(MXNetError, match="no CUDA"):
        ServingEngine(tm, params)
    with pytest.raises(MXNetError, match="unsupported device"):
        resolve("meta")


@pytest.mark.parametrize("kw", [
    {"prefix": True}, {"spec": True}, {"quant": "int8"}, {"megastep": 4},
    {"tier": True}, {"deadline_ms": 50}, {"overload": "shed"},
    {"queue_max": 4}, {"name": "replica1"}, {"kv_quant": "int8"}])
def test_later_slice_keywords_are_refused(models, params, kw):
    _, tm = models
    with pytest.raises(TypeError):
        ServingEngine(tm, params, ctx="cpu", **kw)


def test_block_allocator_matches_jax():
    """The same alloc/free sequence hands out the same block ids in both
    packages, denies the same request, and a double or trash free
    raises; `pool_bytes` prices the pool alike."""
    jalloc, talloc = JBlockAllocator(9, 4), BlockAllocator(9, 4)
    held = []
    for op, arg in [("alloc", 3), ("alloc", 2), ("free", 0), ("alloc", 4),
                    ("alloc", 1), ("free", 1), ("alloc", 2), ("alloc", 9)]:
        if op == "alloc":
            got, want = talloc.alloc(arg), jalloc.alloc(arg)
            assert got == want
            if got is not None:
                held.append(got)
        else:
            blocks = held.pop(arg)
            talloc.free(blocks)
            jalloc.free(blocks)
        assert talloc.free_blocks == jalloc.free_blocks
    assert talloc.capacity == jalloc.capacity == 8
    assert talloc.blocks_for(9) == jalloc.blocks_for(9) == 3
    with pytest.raises(MXNetError, match="double free"):
        talloc.free(held[0] + held[0][:1])
    with pytest.raises(MXNetError, match="trash"):
        talloc.free([TRASH_BLOCK])
    with pytest.raises(MXNetError, match=">= 2 blocks"):
        BlockAllocator(1, 4)
    assert pool_bytes(L, 9, 4, E) == jpool_bytes(L, 9, 4, E) \
        == L * 2 * 9 * 4 * E * 4


# -- programs -----------------------------------------------------------------


def _prompts(lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=n).tolist() for n in lens]


def test_prefill_and_decode_match_jax(models, params):
    jm, tm = models
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tm.params_from_jax(params, "cpu")
    lens = [5, 16, 9]
    toks = np.zeros((3, 16), np.int32)
    for i, p in enumerate(_prompts(lens, 0)):
        toks[i, :len(p)] = p
    length = np.array(lens, np.int32)
    jl, jkv = jax.jit(jm.prefill)(pj, jnp.asarray(toks),
                                  jnp.asarray(length))
    tl, tkv = tm.prefill(tp, torch.from_numpy(toks).long(),
                         torch.from_numpy(length))
    _close(tl, jl)
    _close(tkv, jkv)

    slots = np.array([2, 0, 3], np.int32)
    jc = jm.write_prefill(jm.init_cache(5), jkv, jnp.asarray(length),
                          jnp.asarray(slots))
    tc = tm.write_prefill(tm.init_cache(5, "cpu"), tkv,
                          torch.from_numpy(length), torch.from_numpy(slots))
    _close(tc, jc)
    token = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    pos = length.copy()
    decode = jax.jit(jm.decode)
    for _ in range(3):
        jl, jc = decode(pj, jc, jnp.asarray(token), jnp.asarray(pos),
                        jnp.asarray(slots))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(token),
                           torch.from_numpy(pos), torch.from_numpy(slots))
        _close(tl, jl)
        _close(tc, jc)
        token = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        pos = pos + 1


def test_paged_prefill_and_decode_match_jax(models, params):
    """Two chunks of 8 over a pool of 4-row blocks, then decode steps that
    cross a block boundary; the trash block (0) takes padding writes in
    either order, so the comparison covers the real blocks."""
    jm, tm = models
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tm.params_from_jax(params, "cpu")
    bs, nb = 4, 16
    prompts = _prompts([14, 11], 1)
    tables = np.zeros((2, S // bs), np.int32)
    tables[0, :5] = [3, 7, 1, 9, 4]
    tables[1, :4] = [2, 8, 6, 5]
    jpool = jm.init_block_pool(nb, bs)
    tpool = tm.init_block_pool(nb, bs, "cpu")
    prefill_paged = jax.jit(jm.prefill_paged)
    for start in (0, 8):
        toks = np.zeros((2, 8), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p[start:start + 8])] = p[start:start + 8]
        length = np.array([min(8, len(p) - start) for p in prompts],
                          np.int32)
        st = np.full((2,), start, np.int32)
        jl, jpool = prefill_paged(pj, jpool, jnp.asarray(toks),
                                  jnp.asarray(st), jnp.asarray(length),
                                  jnp.asarray(tables))
        tl, tpool = tm.prefill_paged(tp, tpool, torch.from_numpy(toks),
                                     torch.from_numpy(st),
                                     torch.from_numpy(length),
                                     torch.from_numpy(tables))
        _close(tl, jl)
        _close(tpool[:, :, 1:], np.asarray(jpool)[:, :, 1:])
    token = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    decode_paged = jax.jit(jm.decode_paged)
    for _ in range(3):
        jl, jpool = decode_paged(pj, jpool, jnp.asarray(token),
                                 jnp.asarray(pos), jnp.asarray(tables))
        tl, tpool = tm.decode_paged(tp, tpool, torch.from_numpy(token),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(tables))
        _close(tl, jl)
        _close(tpool[:, :, 1:], np.asarray(jpool)[:, :, 1:])
        token = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
        pos = pos + 1


# -- engine -----------------------------------------------------------------


def _engine(tm, params, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("max_new_tokens", 6)
    return ServingEngine(tm, params, ctx="cpu", **kw)


def _solo(tm, params, prompt, paged, **req):
    eng = _engine(tm, params, max_batch=1, paged=paged)
    r = eng.submit(prompt, **req)
    eng.run_until_idle(timeout=60)
    return r.result(1)


@pytest.mark.parametrize("paged", [True, False])
def test_batched_engine_equals_solo_runs(models, params, paged):
    """Requests join and leave the running batch mid-flight (staggered
    submission and max_new_tokens); every output equals its solo run."""
    _, tm = models
    prompts = _prompts((3, 7, 5, 9, 2, 4), 1)
    max_news = [2, 6, 3, 5, 6, 4]
    eng = _engine(tm, params, paged=paged)
    info = eng.warmup()
    assert info["cache"] == ("paged" if paged else "slot")
    first = [eng.submit(p, max_new_tokens=m)
             for p, m in zip(prompts[:4], max_news[:4])]
    for _ in range(3):
        eng.step()
    late = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts[4:], max_news[4:])]
    eng.run_until_idle(timeout=60)
    for r, p, m in zip(first + late, prompts, max_news):
        assert r.done and r.ttft_ms is not None and r.latency_ms is not None
        assert r.result(1) == _solo(tm, params, p, paged, max_new_tokens=m)
        assert len(r.tokens) == m
    assert eng.stats["completed"] == len(prompts)
    assert eng.stats["tokens"] == sum(max_news)
    assert not eng._active and len(eng._free) == eng.max_batch
    if paged:
        assert eng._alloc.free_blocks == eng._alloc.capacity


def _margins(jm, params, reqs):
    """Top-1 minus top-2 logit at every generated position, from the JAX
    model's prefill of prompt + generated[:j]; also checks that each
    greedy token is that argmax."""
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    seqs = [prompt + gen[:j] for prompt, gen in reqs for j in range(len(gen))]
    toks = np.zeros((len(seqs), S), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits, _ = jax.jit(jm.prefill)(pj, jnp.asarray(toks), jnp.asarray(
        [len(s) for s in seqs], jnp.int32))
    logits = np.asarray(logits)
    assert logits.argmax(axis=-1).tolist() == [t for _, g in reqs for t in g]
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("paged", [True, False])
def test_engine_tokens_equal_jax_engine(models, paged):
    """Greedy tokens of both engines, the same batch schedule (a prompt of
    20 streams in two chunks on the paged engines).  Weights at scale 0.5
    spread the logits so that every step's top-1/top-2 margin exceeds
    1e-3, 50x the 2e-5 program bound: a summation-order flip can neither
    pass nor fail the comparison by luck."""
    jm, tm = models
    wparams = jm.init_params(np.random.RandomState(7), scale=0.5)
    lens = (20, 7, 5, 12, 3) if paged else (14, 7, 5, 12, 3)
    prompts = _prompts(lens, 4)
    max_news = [6, 4, 8, 5, 7]
    jeng = JServingEngine(jm, wparams, max_batch=3, prefill_buckets=[8, 16],
                          max_new_tokens=6, paged=paged, sampling=False,
                          prefix=False)
    teng = _engine(tm, wparams, paged=paged)
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, max_news)]
        eng.run_until_idle(timeout=120)
        outs.append([r.result(1) for r in reqs])
    margins = _margins(jm, wparams, list(zip(prompts, outs[0])))
    assert margins.min() > 1e-3, margins.min()
    assert outs[1] == outs[0]


@pytest.mark.parametrize("paged", [True, False])
def test_stop_rules(models, params, paged):
    """EOS retires the request with the eos token included; a request that
    reaches the cache depth generates through the last row (position
    seq_len - 1): one prefill token plus one per remaining position."""
    _, tm = models
    prompt = [5, 9, 11]
    base = _solo(tm, params, prompt, paged, max_new_tokens=6)
    eos = base[2]
    eng = _engine(tm, params, paged=paged)
    req = eng.submit(prompt, max_new_tokens=6, eos_id=eos)
    eng.run_until_idle(timeout=60)
    assert req.result(1) == base[:base.index(eos) + 1]

    eng = _engine(tm, params, paged=paged, prefill_buckets=[16, S])
    plen = S - 2
    req = eng.submit(list(np.arange(plen) % V), max_new_tokens=10)
    eng.run_until_idle(timeout=60)
    assert len(req.result(1)) == S - plen + 1


def test_preemption_replays_exactly(models, params):
    """A pool too small for every row's growth preempts a row, requeues it
    and replays its context; greedy and seeded-sampled outputs equal the
    unpressured run, and no block leaks."""
    _, tm = models
    prompts = _prompts((7, 6, 5), 2)
    reqs = [dict(max_new_tokens=10), dict(max_new_tokens=10),
            dict(max_new_tokens=10, temperature=0.9, top_k=20, top_p=0.9,
                 seed=5)]
    outs = []
    for n_blocks in (None, 9):
        eng = _engine(tm, params, block_size=4, n_blocks=n_blocks)
        rs = [eng.submit(p, **kw) for p, kw in zip(prompts, reqs)]
        eng.run_until_idle(timeout=60)
        outs.append([r.result(1) for r in rs])
        assert eng._alloc.free_blocks == eng._alloc.capacity
    assert eng.stats["preemptions"] >= 1
    assert outs[1] == outs[0]
    assert all(len(o) == 10 for o in outs[1])


def test_submit_rejections(models, params):
    _, tm = models
    eng = _engine(tm, params, block_size=4, n_blocks=3)
    with pytest.raises(ServeBlocksExhausted):
        eng.submit([1, 2, 3], max_new_tokens=8)
    eng = _engine(tm, params, paged=False)
    with pytest.raises(MXNetError, match="prefill bucket"):
        eng.submit(list(range(17)))
    with pytest.raises(MXNetError, match="empty prompt"):
        eng.submit([])
    with pytest.raises(MXNetError, match="max_new_tokens"):
        eng.submit([1, 2], max_new_tokens=0)
    eng = _engine(tm, params, prefill_buckets=[16, S])
    with pytest.raises(MXNetError, match="leaves no room"):
        eng.submit(list(range(S)))


def test_default_geometry_rules(models, params):
    """The JAX engine's defaults: power-of-two buckets, block size the
    largest divisor (<= 16) of every prefill bucket, and the slot cache's
    budget in blocks."""
    jm, tm = models
    teng = ServingEngine(tm, params, ctx="cpu")
    jeng = JServingEngine(jm, params, prefix=False)
    for attr in ("max_batch", "decode_buckets", "prefill_buckets",
                 "max_new_default", "block_size", "n_blocks"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    odd = TransformerKVModel(V, 100, num_layers=1, num_heads=H, num_embed=E)
    assert ServingEngine(odd, odd.init_params(), ctx="cpu").block_size == 4
