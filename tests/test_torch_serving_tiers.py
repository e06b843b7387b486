"""The port's host-DRAM tier and sessions against the JAX package's, on
the CPU.

* `HostBlockTier`: the JAX test's LRU scenario, and the same random
  put/get/touch/free sequence through both classes with the same
  answers; `PrefixCache` with a spilling hook: 400 random operations
  (insert, park, lookup_plan, evict, drop_host, restore_landed,
  invalidate) give the same results as the JAX class.
* Both engines on the same traffic (spill then restore; restore after
  the host LRU forgot; the restore-ahead cap; a session reattached
  directly and through the tier; a shed session submit; a racing one;
  ``spill_fail``; ``restore_slow``; a restore that fails mid-way; the
  model drafter following restores; an eviction storm under chaos):
  greedy tokens equal where every generated position's top-1/top-2
  logit margin exceeds 1e-3 (the rule of the other
  `tests/test_torch_serving*.py`), `stats` equal key for key
  (``spilled``, ``restored``, ``restored_tokens``, ``prefill_tokens``,
  ``session_hits``, ``session_turns``, ``spill_fails`` and the prefix
  counters among them), the same errors, and no block leaked on the card
  or in the host tier.
* The port alone: a spilled-then-restored block's bytes equal the
  never-evicted original, a request served through a restore gives the
  never-evicting engine's tokens, ``MXNET_SERVE_TIER=0`` is the engine
  without a tier bit for bit, and `ReplicaRouter` keeps a session on
  its replica and moves sessions off a drained one.

The models are the JAX test file's (V, S, L, H, E = 61, 32, 2, 2, 32,
block size 4, 9 blocks) with weights at scale 0.5, as the port's other
serving tests draw them.  The port runs with ``ctx="cpu"``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.executor import AotCache
from mxnet_tpu.serving import HostBlockTier as JHostBlockTier
from mxnet_tpu.serving import PrefixCache as JPrefixCache
from mxnet_tpu.serving import ServeOverload as JServeOverload
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving import TransformerKVModel as JModel
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (HostBlockTier, PrefixCache,
                                     ReplicaRouter, ServeOverload,
                                     ServingEngine, TransformerKVModel)
from test_torch_kernels import _one_thread  # noqa: F401


V, S, L, H, E = 61, 32, 2, 2, 32
BS = 4
POOL = 9
MARGIN = 1e-3
TELEMETRY = ("shed", "expired", "cancelled", "degraded", "block_waits",
             "preempted", "stalled", "drained")
CLOCKS = ("wall_s", "host_s", "hidden_s", "fetch_wait_s")
JAX_ONLY = ("handoffs", "handoffs_in", "handoff_fails")
_AOT = {}


@pytest.fixture(scope="module")
def models():
    return (JModel(V, S, num_layers=L, num_heads=H, num_embed=E),
            TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E))


@pytest.fixture(scope="module")
def wparams(models):
    return models[0].init_params(np.random.RandomState(7), scale=0.5)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("MXNET_CHAOS", "MXNET_SERVE_TIER", "MXNET_SERVE_HOST_BLOCKS",
                 "MXNET_SERVE_RESTORE_AHEAD", "MXNET_SERVE_SESSION_CAP"):
        monkeypatch.delenv(name, raising=False)
    for mod in (jtelemetry, telemetry, jchaos, chaos):
        mod.reset()
    yield
    for mod in (jtelemetry, telemetry, jchaos, chaos):
        mod.reset()


# -- the host tier and the index -------------------------------------------


def test_host_tier_lru():
    """The JAX `test_host_tier_lru` scenario, on the port's class; then a
    copy that fails (a block of the wrong shape) leaves the full tier as
    it was, and the slot it took serves the next spill."""
    a = torch.ones((1, 2, 4, 8))
    t = HostBlockTier(2, a)
    h1, ev = t.put(a * 1)
    assert ev == [] and t.used == 1
    h2, ev = t.put(a * 2)
    assert ev == []
    t.touch(h1)
    h3, ev = t.put(a * 3)
    assert ev == [h2]
    assert t.get(h2) is None
    assert torch.equal(t.get(h1), a * 1)
    with pytest.raises(RuntimeError):
        t.put(torch.ones(3))
    assert t.used == 2 and torch.equal(t.get(h3), a * 3)
    h4, ev = t.put(a * 4)
    assert ev == [h1] and torch.equal(t.get(h4), a * 4)
    t.free(h3)
    t.free(h3)
    assert t.used == 1 and t.bytes == a.nbytes
    t.clear()
    assert t.used == 0 and t.bytes == 0
    with pytest.raises(MXNetError):
        HostBlockTier(0, a)


@pytest.mark.parametrize("pair", [False, True], ids=["rows", "pair"])
def test_host_tier_matches_jax_on_random_operations(pair):
    """300 random operations on both tiers, plain blocks or (rows,
    scales) pairs: the same handles, evictions, counts and bytes, and
    every block read back as it was put (slots are recycled)."""
    rng = np.random.RandomState(0)
    like = torch.zeros((1, 2, 4, 8))
    tiers = (HostBlockTier(5, (like, like[..., 0]) if pair else like),
             JHostBlockTier(5))
    live, put = [], {}
    for step in range(300):
        op = rng.randint(4)
        if op == 0 or not live:
            block = rng.rand(1, 2, 4, 8).astype(np.float32)
            scales = block[..., 0] + 1
            got = [t.put((torch.from_numpy(block), torch.from_numpy(scales))
                         if pair and i == 0 else (block, scales) if pair
                         else torch.from_numpy(block) if i == 0 else block)
                   for i, t in enumerate(tiers)]
            assert got[0] == got[1], step
            put[got[0][0]] = (block, scales)
            live.append(got[0][0])
            for h in got[0][1]:
                live.remove(h)
        else:
            h = live[rng.randint(len(live))]
            if op == 1:
                got = [t.get(h) for t in tiers]
                assert (got[0] is None) == (got[1] is None)
                if got[0] is not None:
                    want = put[h] if pair else put[h][0]
                    for g, w in zip(got[0] if pair else (got[0],),
                                    want if pair else (want,)):
                        assert np.array_equal(g.numpy(), w), step
            elif op == 2:
                for t in tiers:
                    t.touch(h)
            else:
                for t in tiers:
                    t.free(h)
                live.remove(h)
        assert tiers[0].used == tiers[1].used
        assert tiers[0].bytes == tiers[1].bytes


def test_prefix_cache_with_a_tier_matches_jax_on_random_operations():
    """Both indexes with a spilling hook that hands out the same handles
    (and refuses one spill in five), a host-drop hook logging what it
    drops, and 400 random operations: every answer, every hook call and
    the counts equal."""
    rng = np.random.RandomState(1)
    logs = ([], [])

    def make(cls, log):
        state = {"next": 100}

        def spill(block, tokens, node):
            log.append(("spill", block, tuple(tokens)))
            if (block + len(tokens)) % 5 == 0:
                return None
            state["next"] += 1
            return state["next"]

        return cls(2, pool_cap=6, spill_hook=spill,
                   host_drop_hook=lambda h: log.append(("drop", h)))

    caches = (make(PrefixCache, logs[0]), make(JPrefixCache, logs[1]))
    blocks = iter(range(1, 10 ** 6))
    held = []
    for step in range(400):
        op = rng.randint(6)
        toks = [int(t) for t in rng.randint(0, 3, size=2 * rng.randint(1, 5))]
        if op == 0:
            bl = [next(blocks) for _ in range(len(toks) // 2)]
            got = [c.insert(toks, bl, len(bl)) for c in caches]
            held.extend(bl)
        elif op == 1 and held:
            b = held.pop(rng.randint(len(held)))
            got = [c.park(b) for c in caches]
        elif op == 2:
            got = []
            land, dst = rng.rand() < 0.5, next(blocks)
            for c in caches:
                dev, host = c.lookup_plan(toks)
                got.append((dev, [n.block for n in host]))
                if host and land:
                    got.append(c.restore_landed(host[0], host[0].block, dst))
        elif op == 3:
            n = rng.randint(1, 3)
            got = [c.evict(n) for c in caches]
        elif op == 4 and caches[1]._by_host:
            h = sorted(caches[1]._by_host)[rng.randint(
                len(caches[1]._by_host))]
            got = [c.drop_host(h) for c in caches]
        else:
            got = [c.invalidate(held[:1]) for c in caches]
        if op == 2:
            half = len(got) // 2
            assert got[:half] == got[half:], step
        else:
            assert got[0] == got[1], (step, op)
        for attr in ("cached_blocks", "host_count", "parked_count"):
            assert getattr(caches[0], attr) == getattr(caches[1], attr)
    assert logs[0] == logs[1]
    assert any(e[0] == "spill" for e in logs[0])
    assert any(e[0] == "drop" for e in logs[0])


# -- the engines ----------------------------------------------------------------


def _pair(models, params, **kw):
    """A port engine and a JAX engine of the same configuration, both
    warmed (the JAX one greedy-only; its compiled programs shared by the
    engines of one configuration)."""
    jm, tm = models
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("max_new_tokens", 4)
    kw.setdefault("block_size", BS)
    kw.setdefault("n_blocks", POOL)
    kw.setdefault("tier", True)
    kw.setdefault("host_blocks", 32)
    teng = ServingEngine(tm, params, ctx="cpu", **kw)
    key = tuple(sorted((k, repr(v)) for k, v in kw.items()
                       if k in ("n_blocks", "spec", "spec_k", "spec_drafter",
                                "max_batch")))
    aot = _AOT.setdefault(key, AotCache("serve.aot"))
    jeng = JServingEngine(jm, params, sampling=False, aot=aot, **kw)
    jeng.warmup()
    teng.warmup()
    return teng, jeng


def same_stats(teng, jeng):
    reg = jtelemetry.registry()
    for key, got in teng.stats.items():
        if key in CLOCKS:
            continue
        want = reg.counter("serve.%s.%s" % (jeng.name, key)).value \
            if key in TELEMETRY else jeng.stats[key]
        assert got == want, (key, got, want)
    assert set(jeng.stats) - set(teng.stats) <= set(JAX_ONLY)


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


def both(models, params, teng, jeng, drive, errors=None):
    """``drive(engine) -> [requests]`` on the JAX engine, then on the
    port's: the same results (tokens under the margin rule; errors by
    type, ``errors`` mapping the JAX type to the port's), the same
    `stats`, no leaked block in either tier.  Returns the port's
    results."""
    out = []
    for eng in (jeng, teng):
        reqs = drive(eng)
        eng.run_until_idle(timeout=120)
        res = []
        for r in reqs:
            try:
                res.append(r.result(1))
            except Exception as e:  # noqa: BLE001 -- compared by type
                res.append(type(e))
        out.append((reqs, res))
    (jreqs, jres), (_, tres) = out
    ok = [(r.prompt, t) for r, t in zip(jreqs, jres) if isinstance(t, list)]
    if ok:
        assert margins(models[0], params, ok).min() > MARGIN
    errors = errors or {}
    assert [t if isinstance(t, list) else errors.get(t, t)
            for t in jres] == tres
    same_stats(teng, jeng)
    for eng in (teng, jeng):
        assert eng.leaked_blocks() == 0 and eng.leaked_host_blocks() == 0
    return tres


def _serve(prompts, max_new=4, **kw):
    def drive(eng):
        return [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    return drive


def _force_spill(*engines):
    """Evict every parked block, the allocation-pressure path: with the
    tier on they spill."""
    for eng in engines:
        eng._alloc.reclaim(eng._prefix.evict(eng._alloc.capacity))


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, V, n)]


def test_spill_then_restore_matches_jax(models, wparams):
    """Three full blocks spill and come back by restore, not prefill;
    the restored bytes are the originals, and the tokens those of an
    engine that never evicted."""
    teng, jeng = _pair(models, wparams)
    p = _prompt(0, 12)
    out1 = both(models, wparams, teng, jeng, _serve([p]))
    dev, host = teng._prefix.lookup_plan(p)
    before = [teng._cache[:, :, b].clone() for b in dev]
    assert len(before) == 3 and not host
    _force_spill(teng, jeng)
    assert teng.stats["spilled"] == 3 and teng._tier.used == 3
    prefilled = teng.stats["prefill_tokens"]
    out2 = both(models, wparams, teng, jeng, _serve([p]))
    assert out2 == out1
    assert teng.stats["restored"] == 3
    assert teng.stats["restored_tokens"] == 12
    assert teng.stats["prefill_tokens"] == prefilled
    dev2, host2 = teng._prefix.lookup_plan(p)
    assert len(dev2) == 3 and not host2
    for b, want in zip(dev2, before):
        assert torch.equal(teng._cache[:, :, b], want)
    roomy = ServingEngine(models[1], wparams, ctx="cpu", max_batch=2,
                          prefill_buckets=[8, 16], max_new_tokens=4,
                          block_size=BS, n_blocks=33)
    roomy.warmup()
    r = roomy.submit(p, max_new_tokens=4)
    roomy.run_until_idle(timeout=60)
    assert [r.result(1)] == out1


def test_restore_after_the_host_lru_forgot(models, wparams):
    teng, jeng = _pair(models, wparams, host_blocks=1)
    p = _prompt(2, 12)
    out1 = both(models, wparams, teng, jeng, _serve([p]))
    _force_spill(teng, jeng)
    assert teng._tier.used == 1 == teng._prefix.host_count
    assert both(models, wparams, teng, jeng, _serve([p])) == out1


def test_restore_ahead_cap_admits_on_the_device_match(models, wparams):
    teng, jeng = _pair(models, wparams, restore_ahead=0)
    p = _prompt(1, 12)
    out1 = both(models, wparams, teng, jeng, _serve([p]))
    _force_spill(teng, jeng)
    assert teng.stats["spilled"] >= 3
    assert both(models, wparams, teng, jeng, _serve([p])) == out1
    assert teng.stats["restored"] == 0 and teng.stats["prefill_tokens"] > 12


def test_eviction_storm_under_chaos_matches_jax(models, wparams,
                                                monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS", "block_exhaust:0.2,prefix_evict:0.3")
    teng, jeng = _pair(models, wparams, max_batch=3, host_blocks=16)
    rng = np.random.RandomState(3)
    shared = [int(t) for t in rng.randint(0, V, size=8)]
    prompts = [shared + [int(t) for t in rng.randint(0, V, size=4)]
               for _ in range(8)]
    both(models, wparams, teng, jeng, _serve(prompts, max_new=3))


@pytest.mark.parametrize("through_tier", [False, True],
                         ids=["device", "host"])
def test_session_reattach_matches_jax(models, wparams, through_tier):
    """Two turns of one session; between them the history's blocks stay
    on the card or are spilled to the host tier.  The follow-up prefills
    only what the cache could not cover, and equals a fresh engine given
    the whole history."""
    teng, jeng = _pair(models, wparams,
                       n_blocks=POOL if through_tier else 17,
                       max_new_tokens=8)
    t1, t2 = _prompt(4, 8), _prompt(5, 4)
    out1 = both(models, wparams, teng, jeng, _serve([t1], session="chat"))[0]
    if through_tier:
        _force_spill(teng, jeng)
        assert teng.stats["spilled"] >= 2
    prefilled = teng.stats["prefill_tokens"]
    out2 = both(models, wparams, teng, jeng, _serve([t2], session="chat"))[0]
    assert teng.stats["session_hits"] == 1 and teng.stats["session_turns"] == 2
    assert teng.stats["prefill_tokens"] - prefilled <= len(t2) + 2 * BS - 1
    if through_tier:
        assert teng.stats["restored"] >= 2
    fresh = ServingEngine(models[1], wparams, ctx="cpu", max_batch=2,
                          prefill_buckets=[8, 16], block_size=BS,
                          n_blocks=33, max_new_tokens=8)
    r = fresh.submit(t1 + out1 + t2, max_new_tokens=4)
    fresh.run_until_idle(timeout=60)
    assert r.result(1) == out2


def test_shed_and_racing_session_submits_match_jax(models, wparams):
    """A session submit shed at admission leaves the session as it was;
    a turn submitted while the last is unresolved, or racing a claimed
    one, raises; unclaiming makes the turn retryable."""
    teng, jeng = _pair(models, wparams, n_blocks=33, queue_max=1,
                       overload="shed")
    for eng, overload in ((jeng, JServeOverload), (teng, ServeOverload)):
        filler = eng.submit([1, 2, 3], max_new_tokens=2)
        with pytest.raises(overload):
            eng.submit([4, 5], max_new_tokens=2, session="k")
        eng.run_until_idle(timeout=60)
        filler.result(1)
    both(models, wparams, teng, jeng, _serve([[4, 5]], max_new=2,
                                             session="k"))
    for eng in (jeng, teng):
        live = eng.submit([6], max_new_tokens=2, session="k")
        with pytest.raises(Exception, match="unresolved turn"):
            eng.submit([7], max_new_tokens=2, session="k")
        eng.run_until_idle(timeout=60)
        live.result(1)
        eng._session_prompt("k", [8])              # the next turn claimed
        with pytest.raises(Exception, match="unresolved turn"):
            eng._session_prompt("k", [9])          # the racer loses
        eng._session_unclaim("k")
    both(models, wparams, teng, jeng, _serve([[8]], max_new=2, session="k"))
    assert teng.stats["session_hits"] == 2


@pytest.mark.parametrize("spec", ["spill_fail:1.0", "spill_fail:0.5",
                                  "restore_slow:1.0:5"])
def test_tier_chaos_matches_jax(models, wparams, monkeypatch, spec):
    """``spill_fail`` degrades to forgetting the block (the prefill road),
    ``restore_slow`` only delays: tokens, counts and draws as in the JAX
    engine."""
    monkeypatch.setenv("MXNET_CHAOS", spec)
    teng, jeng = _pair(models, wparams)
    p = _prompt(9, 12)
    out1 = both(models, wparams, teng, jeng, _serve([p]))
    _force_spill(teng, jeng)
    assert both(models, wparams, teng, jeng, _serve([p])) == out1
    if spec == "spill_fail:1.0":
        assert teng.stats["spilled"] == 0 and teng.stats["spill_fails"] >= 3
        assert teng.stats["restored"] == 0
    if spec.startswith("restore_slow"):
        assert teng.stats["restored"] >= 3


def test_mid_restore_failure_degrades_to_replay(models, wparams,
                                                monkeypatch):
    """A restore whose scatter raises before writing: the host entries
    drop, the request requeues and prefills, with the never-failing
    tokens; the JAX engine under the same fault agrees."""
    teng, jeng = _pair(models, wparams)
    p = _prompt(11, 12)
    out1 = both(models, wparams, teng, jeng, _serve([p]))
    _force_spill(teng, jeng)
    calls = []

    def boom(*args):
        calls.append(1)
        raise RuntimeError("injected scoped restore failure")

    monkeypatch.setattr(jeng, "_compiled_restore", boom)
    monkeypatch.setattr(teng, "_write_restore", boom)
    assert both(models, wparams, teng, jeng, _serve([p])) == out1
    assert len(calls) == 2
    assert teng.stats["restore_fails"] == 1 and teng.stats["restored"] == 0
    assert teng.stats["prefix_tokens"] == 0
    assert teng._prefix.host_count == teng._tier.used


def test_a_half_written_restore_rebuilds_the_cache(models, wparams,
                                                   monkeypatch):
    """The port alone: a restore scatter that raises after its first write
    leaves the write mark, so the pool reads as lost and the engine
    rebuilds it, the request retrying by replay with the same tokens."""
    teng, _ = _pair(models, wparams)
    p = _prompt(11, 12)
    r = teng.submit(p, max_new_tokens=4)
    teng.run_until_idle(timeout=60)
    out1 = r.result(1)
    _force_spill(teng)
    write = teng.model.write_block

    def half(cache, dst, data):
        teng.model._mark(cache)
        raise RuntimeError("injected failure after a write")

    monkeypatch.setattr(teng.model, "write_block", half)
    r = teng.submit(p, max_new_tokens=4)
    teng.run_until_idle(timeout=60)
    monkeypatch.setattr(teng.model, "write_block", write)
    assert r.result(1) == out1
    assert telemetry.registry().counter(
        "serve.%s.cache_rebuilds" % teng.name).value == 1
    assert teng.leaked_blocks() == 0 and teng.leaked_host_blocks() == 0


def test_model_drafter_follows_restores(models, wparams):
    teng, jeng = _pair(models, wparams, spec=True, spec_k=2,
                       spec_drafter="model")
    p = _prompt(13, 12)
    out1 = both(models, wparams, teng, jeng, _serve([p]))
    chunks = teng._drafter.prefill_chunks
    _force_spill(teng, jeng)
    assert both(models, wparams, teng, jeng, _serve([p])) == out1
    assert teng.stats["restored"] >= 3 and teng.stats["spec_proposed"] > 0
    # the restored span was prefilled through the draft model
    assert teng._drafter.prefill_chunks > chunks


def test_tier_off_is_the_engine_without_a_tier(models, wparams, monkeypatch):
    """``MXNET_SERVE_TIER=0`` (and a tier without the prefix cache) builds
    no tier and gives, with spills forced between requests, the tokens
    and stats of an engine built without the keyword."""
    monkeypatch.setenv("MXNET_SERVE_TIER", "0")
    kw = dict(ctx="cpu", max_batch=2, prefill_buckets=[8, 16],
              max_new_tokens=4, block_size=BS, n_blocks=POOL)
    off = ServingEngine(models[1], wparams, **kw)
    plain = ServingEngine(models[1], wparams, **kw)
    assert off._tier is None and off.warmup()["tier"] is None
    assert ServingEngine(models[1], wparams, prefix=False, tier=True,
                         **kw)._tier is None
    outs = []
    for eng in (off, plain):
        got = []
        for p in (_prompt(6, 12), _prompt(7, 8), _prompt(6, 12)):
            r = eng.submit(p, max_new_tokens=4)
            eng.run_until_idle(timeout=60)
            got.append(r.result(1))
            _force_spill(eng)
        outs.append(got)
        assert eng.stats["spilled"] == 0 == eng.stats["restored"]
    assert outs[0] == outs[1]
    assert {k: v for k, v in off.stats.items() if k not in CLOCKS} == \
        {k: v for k, v in plain.stats.items() if k not in CLOCKS}


def test_router_session_affinity_and_drain(models, wparams):
    """A session's second turn lands on the replica holding it, even with
    the other one idle; draining that replica moves the session to its
    replacement, where the third turn reattaches."""
    engines = [ServingEngine(models[1], wparams, ctx="cpu",
                             name="replica%d" % i, max_batch=2,
                             prefill_buckets=[8, 16], block_size=BS,
                             n_blocks=17, tier=True, host_blocks=16)
               for i in range(2)]
    router = ReplicaRouter(engines, respawn=False)
    router.warmup()
    r1 = router.submit([1, 2, 3, 4, 5], max_new_tokens=3, session="aff")
    router.run_until_idle(timeout=60)
    out1 = r1.result(1)
    owner = [e for e in router.engines if e.has_session("aff")]
    assert len(owner) == 1
    busy = owner[0].submit([9, 9, 9], max_new_tokens=3)   # depth on it
    r2 = router.submit([6, 7], max_new_tokens=3, session="aff")
    router.run_until_idle(timeout=60)
    busy.result(1)
    assert r2.prompt == [1, 2, 3, 4, 5] + out1 + [6, 7]
    assert owner[0].stats["session_hits"] == 1
    fresh = router.drain(owner[0])
    assert fresh is not None and fresh.has_session("aff")
    r3 = router.submit([8], max_new_tokens=2, session="aff")
    router.run_until_idle(timeout=60)
    r3.result(1)
    assert fresh.stats["session_hits"] == 1
    assert telemetry.registry().counter("serve.sessions_migrated").value == 1
    router.stop()
