"""The port's prefix cache against the JAX package's, on the CPU.

`mxnet_tpu_torch.serving`'s refcounted `BlockAllocator`, its
`PrefixCache` and `TransformerKVModel.copy_block` are fed the same
operations as the JAX classes and must answer the same, exactly (they
are integer bookkeeping and a copy).  Then both engines serve the same
shared-prefix traffic at the size of `tests/test_serving.py` (V, S, L,
H, E = 61, 32, 2, 2, 32, prefill buckets [8, 16]) with weights at scale
0.5: greedy tokens must be equal where every generated position's
top-1/top-2 logit margin exceeds 1e-3, 50x the 2e-5 bound the two
packages' programs are held to (`tests/test_torch_serving.py`), and the
`stats` equal key for key: the JAX engine's own `stats` where it keeps
the key, its per-replica telemetry counter where the port keeps the
counter in `stats`.  `leaked_blocks()` is 0 on both after every
scenario.  The port runs with ``ctx="cpu"``, the kernels' plain versions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import telemetry
from mxnet_tpu.executor import AotCache
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving import TransformerKVModel as JModel
from mxnet_tpu.serving.paged import BlockAllocator as JBlockAllocator
from mxnet_tpu.serving.paged import PrefixCache as JPrefixCache
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (TRASH_BLOCK, BlockAllocator,
                                     PrefixCache, ServingEngine,
                                     TransformerKVModel)
from test_torch_kernels import _one_thread  # noqa: F401


V, S, L, H, E = 61, 32, 2, 2, 32
MARGIN = 1e-3
# the counters the JAX engine keeps in its telemetry, under
# ``serve.<name>.<key>``, and the port in `stats`
TELEMETRY = ("shed", "expired", "cancelled", "degraded", "block_waits",
             "preempted", "stalled", "drained")
# the decode loop's wall-clock seconds, which no two runs share
CLOCKS = ("wall_s", "host_s", "hidden_s", "fetch_wait_s")
# compiled JAX programs, shared by the engines of one pool geometry
_AOT = {}


@pytest.fixture(scope="module")
def models():
    return (JModel(V, S, num_layers=L, num_heads=H, num_embed=E),
            TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E))


@pytest.fixture(scope="module")
def wparams(models):
    return models[0].init_params(np.random.RandomState(7), scale=0.5)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _pair(models, params, **kw):
    """A port engine and a JAX engine of the same configuration (the JAX
    one greedy-only: its sampler programs are not under test)."""
    jm, tm = models
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("max_new_tokens", 6)
    teng = ServingEngine(tm, params, ctx="cpu", **kw)
    aot = _AOT.setdefault((teng.n_blocks, teng.block_size),
                          AotCache("serve.aot"))
    jeng = JServingEngine(jm, params, sampling=False, aot=aot, **kw)
    return teng, jeng


def same_stats(teng, jeng):
    reg = telemetry.registry()
    for key, got in teng.stats.items():
        if key in CLOCKS:
            continue
        want = reg.counter("serve.%s.%s" % (jeng.name, key)).value \
            if key in TELEMETRY else jeng.stats[key]
        assert got == want, (key, got, want)


def margins(jm, params, reqs):
    """Top-1 minus top-2 logit at every generated position, from the JAX
    model's prefill of prompt + generated[:j]; also checks that each
    greedy token is that argmax."""
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    seqs = [p + g[:j] for p, g in reqs for j in range(len(g))]
    toks = np.zeros((len(seqs), S), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits, _ = jax.jit(jm.prefill)(pj, jnp.asarray(toks), jnp.asarray(
        [len(s) for s in seqs], jnp.int32))
    logits = np.asarray(logits)
    assert logits.argmax(axis=-1).tolist() == [t for _, g in reqs for t in g]
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


def both(models, params, teng, jeng, drive):
    """Run ``drive(engine) -> [requests]`` on each engine; the tokens and
    the stats must agree and no block may leak.  Returns the port's
    requests."""
    out = []
    for eng in (jeng, teng):
        reqs = drive(eng)
        eng.run_until_idle(timeout=120)
        out.append(reqs)
    jreqs, treqs = out
    jtoks = [r.result(1) for r in jreqs]
    m = margins(models[0], params, [(r.prompt, t)
                                    for r, t in zip(jreqs, jtoks)])
    assert m.min() > MARGIN, m.min()
    assert [r.result(1) for r in treqs] == jtoks
    same_stats(teng, jeng)
    assert teng.leaked_blocks() == 0 and jeng.leaked_blocks() == 0
    return treqs


def _prompt(rng, n):
    return rng.randint(0, V, size=n).tolist()


# -- the allocator, the index and the block copy ------------------------------


def test_block_allocator_refcounts_match_jax():
    """Refcounts, release to zero, reclaim, the single-owner free, the
    gauges and `fragmentation` answer alike, and every wrong transition
    raises in both."""
    j, t = JBlockAllocator(8, 4), BlockAllocator(8, 4)

    def same(op, *args):
        a, b = getattr(j, op)(*args), getattr(t, op)(*args)
        assert a == b, (op, args, a, b)
        for attr in ("free_blocks", "used_blocks", "shared_blocks"):
            assert getattr(j, attr) == getattr(t, attr), (op, attr)
        return b

    got = same("alloc", 2)
    same("acquire", got)
    assert [t.refcount(b) for b in got] == [j.refcount(b) for b in got] \
        == [2, 2]
    assert not t.exclusive(got[0]) and not j.exclusive(got[0])
    assert same("fragmentation", 6) == pytest.approx(0.25)
    assert same("release", got) == []
    zeroed = same("release", got)
    assert sorted(zeroed) == sorted(got)
    assert same("can_serve", 5) and not same("can_serve", 6)
    same("reclaim", zeroed)
    held = same("alloc", 3)
    assert t.exclusive(held[0]) and j.exclusive(held[0])
    assert same("fragmentation", 10, 1) == pytest.approx(1 - 10 / 16)
    same("free", held[:1])
    for alloc in (j, t):
        with pytest.raises(Exception, match="double free"):
            alloc.release(held[:1])
        with pytest.raises(Exception, match="reclaiming free"):
            alloc.reclaim(held[:1])
        with pytest.raises(Exception, match="acquiring free"):
            alloc.acquire(held[:1])
        with pytest.raises(Exception, match="trash"):
            alloc.acquire([TRASH_BLOCK])
        with pytest.raises(Exception, match="reclaiming held"):
            alloc.reclaim(held[1:2])
    assert same("alloc", 9) is None
    same("reset")
    assert t.free_blocks == t.capacity == 7
    assert BlockAllocator(8, 4).fragmentation(0) == 0.0
    with pytest.raises(MXNetError, match="trash"):
        t.release([TRASH_BLOCK])


def test_prefix_cache_matches_jax_on_random_operations():
    """400 random inserts, lookups, parks, unparks, evictions and
    invalidations over token runs from a 3-token alphabet (so prefixes
    collide and duplicates arrive under other blocks), with a pool cap:
    the same blocks out, the same eviction order, the same counts."""
    rng = np.random.RandomState(0)
    for cap in (-1, 3):
        j, t = JPrefixCache(2, pool_cap=cap), PrefixCache(2, pool_cap=cap)
        next_block = [1]
        for _ in range(400):
            op = rng.randint(7)
            toks = rng.randint(0, 3, size=2 * rng.randint(1, 5)).tolist()
            if op == 0:
                n = len(toks) // 2
                blocks = list(range(next_block[0], next_block[0] + n))
                next_block[0] += n
                k = int(rng.randint(0, n + 1))
                assert t.insert(toks, blocks, k) == j.insert(toks, blocks, k)
            elif op == 1:
                jp = j.lookup_plan(toks)
                assert t.lookup_plan(toks) == (jp[0], []) and jp[1] == []
            elif op == 2:
                assert t.lookup(toks) == j.lookup(toks)
            elif op in (3, 4):
                b = int(rng.randint(1, next_block[0] + 1))
                assert t.park(b) == j.park(b)
            elif op == 5:
                b = [int(rng.randint(1, next_block[0] + 1))]
                if rng.randint(2):
                    t.unpark(b)
                    j.unpark(b)
                else:
                    assert t.invalidate(b) == j.invalidate(b)
            else:
                n = int(rng.randint(0, 3))
                assert t.evict(n) == j.evict(n)
            assert t.parked_count == j.parked_count
            assert t.cached_blocks == j.cached_blocks
            for b in range(1, next_block[0]):
                assert t.contains(b) == j.contains(b)
        t.clear()
        assert t.lookup([0, 0]) == [] and t.cached_blocks == 0


def test_prefix_cache_leaf_first_lru_and_cap():
    """The eviction order of the JAX package's own test: leaves before
    roots, a touched root kept, the cap evicting at park."""
    for pc in (PrefixCache(2), JPrefixCache(2)):
        pc.insert([1, 2, 3, 4, 5, 6], [10, 11, 12], 3)
        for b in (10, 11, 12):
            assert pc.park(b) == []
        assert pc.evict(1) == [12] and pc.evict(1) == [11]
        pc.insert([1, 2, 9, 9], [10, 30], 2)
        pc.park(30)
        pc.lookup([1, 2])
        assert pc.evict(1) == [30]
    for pc in (PrefixCache(2, pool_cap=1), JPrefixCache(2, pool_cap=1)):
        pc.insert([1, 2, 3, 4], [10, 11], 2)
        assert pc.park(11) == [] and pc.park(10) == [11]
        assert pc.park(99) is None


def test_copy_block_matches_jax(models):
    """One block's rows, every layer, K and V, copied in place; exact."""
    jm, tm = models
    pool = np.random.RandomState(1).randn(L, 2, 6, 4, E).astype(np.float32)
    want = np.asarray(jax.jit(jm.copy_block)(
        jnp.asarray(pool), jnp.asarray([2], jnp.int32),
        jnp.asarray([5], jnp.int32)))
    got = torch.from_numpy(pool.copy())
    assert tm.copy_block(got, torch.tensor([2]), torch.tensor([5])) is got
    np.testing.assert_array_equal(got.numpy(), want)
    tm.copy_block(got, 3, 1)
    np.testing.assert_array_equal(got[:, :, 1].numpy(), pool[:, :, 3])


# -- the engines on shared-prefix traffic -------------------------------------


def test_suffix_only_prefill(models, wparams):
    """Requests extending a cached 16-token prefix acquire its blocks and
    prefill only their tails."""
    teng, jeng = _pair(models, wparams)
    assert teng._prefix is not None
    rng = np.random.RandomState(11)
    sys_p = _prompt(rng, 16)
    tails = [_prompt(rng, n) for n in (3, 6, 1)]

    def drive(eng):
        first = eng.submit(sys_p + tails[0], max_new_tokens=4)
        eng.run_until_idle(timeout=60)
        return [first] + [eng.submit(sys_p + t, max_new_tokens=4)
                          for t in tails[1:]]
    both(models, wparams, teng, jeng, drive)
    st = teng.stats
    assert st["prefix_hits"] == 2 and st["prefix_tokens"] == 32
    assert st["prefill_tokens"] == 16 + 3 + 6 + 1
    assert st["prefix_lookup_tokens"] == 3 * 16 + 3 + 6 + 1


def test_sharing_while_the_writer_still_decodes(models, wparams):
    """Eager registration: B shares blocks A still holds mid-decode."""
    teng, jeng = _pair(models, wparams, max_batch=2, max_new_tokens=8)
    rng = np.random.RandomState(12)
    sys_p = _prompt(rng, 16)
    shared = []

    def drive(eng):
        ra = eng.submit(sys_p + [1, 2, 3])
        eng.step()
        rb = eng.submit(sys_p + [4, 5])
        eng.step()
        shared.append(eng._alloc.shared_blocks)
        return [ra, rb]
    both(models, wparams, teng, jeng, drive)
    assert shared[1] == shared[0] >= 2
    assert teng.stats["prefix_hits"] == 1


def test_full_cover_bootstraps_through_decode_with_cow(models, wparams):
    """An identical block-aligned prompt skips prefill: it feeds its last
    token through a decode, whose write lands in the last shared block,
    so that block is copied first; its first token is stamped then."""
    teng, jeng = _pair(models, wparams)
    prompt = _prompt(np.random.RandomState(14), 16)
    late = []

    def drive(eng):
        a = eng.submit(prompt, max_new_tokens=5)
        eng.run_until_idle(timeout=60)
        prefills = eng.stats["prefills"]
        b = eng.submit(prompt, max_new_tokens=5)
        eng.step()
        late.append((b.t_first is not None, len(b.tokens),
                     eng.stats["prefills"] - prefills))
        return [a, b]
    treqs = both(models, wparams, teng, jeng, drive)
    assert late[0] == late[1] == (True, 1, 0)
    assert treqs[0].tokens == treqs[1].tokens
    st = teng.stats
    assert st["prefix_bootstraps"] == 1 and st["cow_copies"] == 1
    assert st["prefix_tokens"] == 16 and st["prefills"] == 1


def test_preempted_resume_over_a_shared_prefix(models, wparams):
    """Growth pressure preempts a sequence holding shared prefix blocks;
    its resume re-acquires them through the index (here it covers the
    whole replayed context and bootstraps).  Refs drop exactly once."""
    teng, jeng = _pair(models, wparams, max_batch=2, n_blocks=5,
                       max_new_tokens=12)
    sys_p = _prompt(np.random.RandomState(16), 8)

    def drive(eng):
        ra = eng.submit(sys_p + [7])
        eng.step()
        return [ra, eng.submit(sys_p + [9])]
    both(models, wparams, teng, jeng, drive)
    st = teng.stats
    assert st["preemptions"] >= 1 and st["prefix_hits"] >= 2
    assert st["prefix_bootstraps"] >= 1
    assert teng._alloc.free_blocks + teng._prefix.parked_count \
        == teng._alloc.capacity


def test_parked_blocks_evict_under_pressure(models, wparams):
    """A retired prefix parks until a stranger needs the room; then it is
    evicted leaf first, and its next use misses and prefills again."""
    teng, jeng = _pair(models, wparams, n_blocks=5, max_new_tokens=3)
    rng = np.random.RandomState(17)
    hot, stranger = _prompt(rng, 16), _prompt(rng, 24)
    parked = []

    def drive(eng):
        a = eng.submit(hot)
        eng.run_until_idle(timeout=60)
        parked.append(eng._prefix.parked_count)
        b = eng.submit(stranger)
        eng.run_until_idle(timeout=60)
        return [a, b, eng.submit(hot + [5])]
    both(models, wparams, teng, jeng, drive)
    assert parked == [2, 2]
    st = teng.stats
    assert st["prefix_evictions"] >= 2 and st["prefix_hits"] == 0


def test_prefix_pool_cap(models, wparams):
    teng, jeng = _pair(models, wparams, prefix_pool=1)
    rng = np.random.RandomState(18)
    prompts = [_prompt(rng, 16) for _ in range(3)]
    both(models, wparams, teng, jeng,
         lambda eng: [eng.submit(p, max_new_tokens=2) for p in prompts])
    assert teng._prefix.parked_count == 1
    assert teng.stats["prefix_evictions"] >= 1


def test_prefix_off_is_single_owner_paging(models, wparams):
    """``prefix=False``: no index, blocks freed at retire, no prefix
    accounting; its tokens equal the prefix engine's on the same
    traffic, the stats the JAX single-owner engine's."""
    rng = np.random.RandomState(13)
    sys_p = _prompt(rng, 16)
    prompts = [sys_p + _prompt(rng, n) for n in (2, 5, 3)] + [list(sys_p)]

    def drive(eng):
        return [eng.submit(p, max_new_tokens=4) for p in prompts]
    teng, jeng = _pair(models, wparams, prefix=False)
    off = both(models, wparams, teng, jeng, drive)
    assert teng._prefix is None
    assert teng._alloc.free_blocks == teng._alloc.capacity
    assert all(teng.stats[k] == 0 for k in (
        "prefix_hits", "prefix_tokens", "prefix_lookup_tokens",
        "prefix_bootstraps", "cow_copies", "prefix_evictions"))
    teng, jeng = _pair(models, wparams)
    on = both(models, wparams, teng, jeng, drive)
    assert [r.tokens for r in on] == [r.tokens for r in off]
    assert teng.stats["prefix_hits"] == 3


def test_sampled_tokens_do_not_depend_on_sharing(models, wparams):
    """Sampling is keyed by (seed, position): a sampled request draws the
    same tokens whether its prefix was shared, bootstrapped or
    prefilled."""
    _, tm = models
    rng = np.random.RandomState(19)
    sys_p = _prompt(rng, 16)
    prompts = [sys_p + _prompt(rng, 3), list(sys_p), sys_p + [4]]
    outs = []
    for prefix in (False, True):
        eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=2,
                            prefill_buckets=[8, 16], prefix=prefix)
        reqs = [eng.submit(p, max_new_tokens=8, temperature=0.9, top_k=20,
                           top_p=0.9, seed=3 + i)
                for i, p in enumerate(prompts)]
        eng.run_until_idle(timeout=60)
        outs.append([r.result(1) for r in reqs])
        assert eng.leaked_blocks() == 0
    assert eng.stats["prefix_bootstraps"] == 1
    assert outs[0] == outs[1]
