"""The port's sub-mesh serving replicas against the JAX package's, on the
CPU.

The counterparts of `tests/test_serve_sharded.py`'s scenarios, at its size
(V, S, L, H, E = 61, 32, 2, 2, 32, prefill buckets [8, 16]) with the
weights of `tests/test_torch_serving_prefix.py`, plus one H=4, V=64 model
so that the whole-head and vocabulary splits run (at H=2 the port splits
attention at 2 shards and replicates it at 4; V=61 never splits).  A
mesh here is ``[cpu] * k``:

* `submeshes` and `mesh_signature` (the JAX package's signature for the
  same group), the trainer's shardings refused;
* `param_shardings` / `kv_shardings` against the JAX rules (the
  whole-head difference stated), `shard_params`' slices;
* every partitioned program against the unsharded port's, logits within
  1e-5 (only the order of the row-parallel sums changes), f32 and under
  int8 weights and K/V;
* a sharded int8 K/V write bit-equal to the unsharded codec's rows and
  scales on the same K/V;
* T=0 tokens of sub-mesh engines at 2 and 4 shards, paged and slot, equal
  to the JAX engine's greedy answer where every position's top-1/top-2
  margin exceeds 1e-3; seeded sampling equal to the unsharded engine's;
* the kill switch, `memory_footprint` (1 > 2 > 4 with the total
  conserved), MoE expert load equal to the unsharded engine's, the host
  tier's and the handoff's bytes equal to the unsharded ones;
* `from_mesh` groups, and chaos with sub-mesh replicas that respawn at
  their width.
"""
import time

import numpy as np
import pytest
import torch

import jax

from mxnet_tpu import chaos as jchaos
from mxnet_tpu.parallel.mesh import mesh_signature as jmesh_signature
from mxnet_tpu.parallel.mesh import submeshes as jsubmeshes
from mxnet_tpu.serving import TransformerKVModel as JModel
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.mesh import (Mesh, data_parallel_sharding,
                                           make_mesh, mesh_signature,
                                           submeshes)
from mxnet_tpu_torch.quant.codec import quantize_rows
from mxnet_tpu_torch.serving import (ReplicaRouter, ServeError,
                                     ServingEngine, TransformerKVModel)
from mxnet_tpu_torch.serving.sharded import ShardedKVModel

from test_torch_serving_prefix import margins, models, wparams  # noqa: F401
from test_torch_serving_router import _oracle
from test_torch_kernels import _one_thread  # noqa: F401

S = 32
KW = dict(max_batch=4, prefill_buckets=[8, 16], max_new_tokens=6,
          sampling=False)
PROMPTS = [[3, 4, 5], [7, 8], [9] * 6, [2], [5, 6, 7, 8, 9]]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for pin in ("MXNET_CHAOS", "MXNET_SERVE_SHARDED",
                "MXNET_SERVE_SHARDED_AXIS", "MXNET_SERVE_SHARDED_DEVICES",
                "MXNET_SERVE_DISAGG"):
        monkeypatch.delenv(pin, raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    for mod in (telemetry, chaos, jchaos):
        mod.reset()
    yield
    for mod in (telemetry, chaos, jchaos):
        mod.reset()


@pytest.fixture(scope="module")
def wide():
    """The H=4, V=64 model (JAX and port) and its weights."""
    jm = JModel(64, S, num_layers=2, num_heads=4, num_embed=32)
    tm = TransformerKVModel(64, S, num_layers=2, num_heads=4, num_embed=32)
    return (jm, tm), jm.init_params(np.random.RandomState(11), scale=0.5)


def _mesh(k):
    return submeshes(["cpu"] * 4, k)[0]


def _serve(eng, submits):
    reqs = [eng.submit(p, **kw) for p, kw in submits]
    eng.run_until_idle(timeout=120)
    return [r.result(1) for r in reqs]


_UNSHARDED = {}


def _unsharded(tm, params, key, submits, **kw):
    """The unsharded port engine's answer, once a module per key."""
    if key not in _UNSHARDED:
        eng = ServingEngine(tm, params, ctx="cpu", **dict(KW, **kw))
        _UNSHARDED[key] = (_serve(eng, submits), eng.memory_footprint(),
                           eng.expert_load())
    return _UNSHARDED[key]


# -- the mesh ---------------------------------------------------------------------


def test_submeshes_geometry_and_signature():
    devs = ["cpu"] * 7
    ms = submeshes(devs, 2)
    assert len(ms) == 3                       # the remainder is dropped
    assert all(m.axis_names == ("model",) and m.devices.shape == (2,)
               for m in ms)
    assert all(str(d) == "cpu" for m in ms for d in m.devices.reshape(-1))
    assert len(submeshes(devs, 3)) == 2
    with pytest.raises(MXNetError, match="sub-mesh"):
        submeshes(devs[:1], 4)
    with pytest.raises(MXNetError, match="per_mesh"):
        submeshes(devs, 0)
    assert mesh_signature(None) == ()
    s2, s4 = mesh_signature(_mesh(2)), mesh_signature(_mesh(4))
    assert s2 != s4 and mesh_signature(submeshes(devs, 2)[1]) == s2
    # the JAX package signs a group of the same width the same way
    assert s2 == jmesh_signature(jsubmeshes(jax.devices(), 2)[0])
    assert s4 == jmesh_signature(jsubmeshes(jax.devices(), 4)[0])
    m = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert dict(m.shape) == {"data": 2, "model": 2}
    with pytest.raises(MXNetError, match="other axis"):
        m.axis_devices("model")
    with pytest.raises(MXNetError, match="queue 1, item 3"):
        data_parallel_sharding(m)
    assert isinstance(_mesh(2), Mesh)


# -- the shard plans -------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_param_shardings_follow_the_jax_rules(models, wide, k):
    """The descriptors name the JAX rules' split axis, except that
    attention splits by whole heads only (H=2 at 4 shards: the JAX rules
    split E=32 inside a head, the port replicates attention)."""
    for jm, tm in (models, wide[0]):
        jmesh = jsubmeshes(jax.devices(), k)[0]
        want = jm.param_shardings(jmesh, "model")
        got = tm.param_shardings(_mesh(k), "model")
        assert set(got) == set(want)
        heads = tm.num_heads % k == 0
        for name, sh in want.items():
            spec = tuple(sh.spec)
            jax_ax = next((i for i, a in enumerate(spec) if a), None)
            attn = any(name.endswith(s) for s in (
                "q_weight", "k_weight", "v_weight", "q_bias", "k_bias",
                "v_bias", "attn_out_weight"))
            if attn and not heads:
                assert got[name] is None, name
            else:
                assert got[name] == jax_ax, (name, got[name], spec)
        pool, scales = tm.kv_shardings(_mesh(k))
        jpool, jscales = jm.kv_shardings(jmesh, "model")
        assert scales is None and tuple(jscales.spec) == ()
        assert pool == (4 if heads else None)
        assert tuple(jpool.spec)[4:] == ("model",)


def test_shard_params_slices(wide):
    (_, tm), params = wide
    sp = tm.shard_params(params, _mesh(2))
    w = params["layer0_ffn2_weight"]
    for s, shard in enumerate(sp.shards):
        np.testing.assert_array_equal(shard["layer0_q_weight"].numpy(),
                                      params["layer0_q_weight"][16 * s:
                                                                16 * s + 16])
        np.testing.assert_array_equal(shard["layer0_ffn2_weight"].numpy(),
                                      w[:, 64 * s:64 * s + 64])
        assert shard["embed_weight"].shape == (32, 32)
    # replicated tensors: one copy per distinct device, shared
    assert sp.shards[0]["final_ln_gamma"] is sp.shards[1]["final_ln_gamma"]
    assert tm.shard_groups(1) == dict.fromkeys(
        ("heads", "ffn", "vocab", "experts"), False)


# -- the partitioned programs -----------------------------------------------------


def _tparams(tm, params):
    return tm.params_from_jax(tm.quantize_params(params), "cpu")


def _programs(model, params, quantized):
    """Every program's outputs on one model, over a fresh pool."""
    rng = np.random.RandomState(3)
    cache = model.init_block_pool(12, 8, device="cpu")
    t = torch.tensor
    out = {}
    tables = t([[1, 2, 3, 4], [5, 6, 7, 0]])
    toks = t(rng.randint(0, model.vocab_size, size=(2, 16)))
    out["prefill_paged"], _ = model.prefill_paged(
        params, cache, toks, t([0, 0]), t([16, 11]), tables)
    out["decode_paged"], _ = model.decode_paged(
        params, cache, t([5, 9]), t([16, 11]), tables)
    out["verify_paged"], _ = model.verify_paged(
        params, cache, t(rng.randint(0, model.vocab_size, size=(2, 4))),
        t([17, 12]), t([4, 3]), tables)
    out["megastep"], _ = model.decode_megastep(
        params, cache, t([1, 2]), t([21, 15]), t([3, 3]), t([-1, -1]),
        tables, 3, lambda lg, p: lg.argmax(dim=-1))
    out["pool"] = model.gather_blocks(cache, t([1, 2, 5]))
    if not quantized:
        slot = model.init_cache(3, device="cpu")
        lg, kv = model.prefill(params, toks[:, :8], t([8, 5]))
        model.write_prefill(slot, kv, t([8, 5]), t([0, 1]))
        out["prefill"] = lg
        out["decode"], _ = model.decode(params, slot, t([4, 6]), t([8, 5]),
                                        t([0, 1]))
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_programs_match_unsharded(models, wparams, wide, k, quant):
    """Each program at 2 and 4 shards against the unsharded port's, H=2
    (attention replicated at 4) and H=4 (heads and vocabulary split):
    logits within 1e-5 of the largest, the pools' rows and int8 scales
    within 1e-5 (int8 rows: at most one step where a product rounded the
    other way)."""
    for (_, tm0), params in ((models, wparams), wide):
        tm = tm0.with_quant(quant, quant)
        p = _tparams(tm, params)
        want = _programs(tm, p, quant)
        sm = ShardedKVModel(tm, _mesh(k))
        got = _programs(sm, sm.shard_params(p), quant)
        for name, w in want.items():
            g = got[name]
            if name == "megastep":
                assert torch.equal(g, w)
                continue
            if name == "pool" and quant:
                assert (g[0].int() - w[0].int()).abs().max() <= 1
                torch.testing.assert_close(g[1], w[1], rtol=1e-5, atol=0)
                continue
            tol = 1e-5 * float(w.abs().max())
            assert float((g - w).abs().max()) <= tol, name


def test_kv8_sharded_write_bit_equal_to_codec(wide):
    """A shard's write quantizes its slice by the whole row's amax: the
    int8 rows and the scales equal `quantize_rows` of the unsharded K/V
    bit for bit, at 2 and 4 shards."""
    (_, tm0), _ = wide
    tm = tm0.with_quant(None, "int8")
    rows = torch.from_numpy(np.random.RandomState(5).randn(3, 8, 32).astype(
        np.float32) * np.array([1e-3, 1.0, 40.0], np.float32)[:, None, None])
    want_q, want_s = quantize_rows(rows, tm.kv_quant)
    for k in (2, 4):
        sm = ShardedKVModel(tm, _mesh(k))
        cache = sm.init_block_pool(4, 8)
        w = 32 // k
        pools, scales = sm._unit_pools(cache)
        sm._write_units(pools, scales,
                        {torch.device("cpu"): (0, 0, slice(1, 4))},
                        [rows[..., s * w:(s + 1) * w] for s in range(k)])
        got_q = torch.cat([u[0, 0, 1:4] for u in cache.units], dim=-1)
        assert torch.equal(got_q, want_q)
        assert torch.equal(cache.scales[torch.device("cpu")][0, 0, 1:4],
                           want_s)


# -- engines ------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("paged", [True, False])
def test_sharded_engine_t0_parity(models, wparams, wide, k, paged):
    """T=0 tokens at 2 and 4 shards, paged and slot: the JAX engine's
    greedy answer (H=2 model), the JAX model's argmax at every position
    with a top-1/top-2 margin above 1e-3 (both models), and the unsharded
    engine's; nothing leaks."""
    submits = [(p, {"max_new_tokens": 6}) for p in PROMPTS]
    for (jm, tm), params, oracle in ((models, wparams, True),
                                     (wide[0], wide[1], False)):
        eng = ServingEngine(tm, params, ctx=_mesh(k), paged=paged, **KW)
        assert eng._mesh is not None and eng.device == torch.device("cpu")
        got = _serve(eng, submits)
        if oracle:
            assert got == [_oracle(models, params, p, 6) for p in PROMPTS]
        assert margins(jm, params, list(zip(PROMPTS, got))).min() > 1e-3
        assert got == _unsharded(tm, params, (tm.num_heads, paged),
                                 submits, paged=paged)[0]
        if paged:
            assert eng.leaked_blocks() == 0


def test_sharded_seeded_sampling(wide):
    (_, tm), params = wide
    submits = [(p, dict(max_new_tokens=6, temperature=0.8, top_k=8,
                        seed=100 + i)) for i, p in enumerate(PROMPTS[:3])]
    want = _unsharded(tm, params, "sampled", submits, sampling=True)[0]
    eng = ServingEngine(tm, params, ctx=_mesh(2), **dict(KW, sampling=True))
    assert _serve(eng, submits) == want


def test_kill_switch_and_memory_footprint(models, wparams, wide,
                                          monkeypatch):
    """Per-device bytes shrink 1 > 2 > 4 with the total conserved (H=4);
    at H=2 the FFN still splits, so both shard counts hold less than one
    device.  ``MXNET_SERVE_SHARDED=0``: the first device, the unsharded
    tokens, one device in the accounting."""
    for (_, tm), params in ((models, wparams), wide):
        one = _unsharded(tm, params, (tm.num_heads, True),
                         [(p, {"max_new_tokens": 6}) for p in PROMPTS])[1]
        mf = {k: ServingEngine(tm, params, ctx=_mesh(k),
                               **KW).memory_footprint() for k in (2, 4)}
        for k in (2, 4):
            assert mf[k]["devices"] == k
            assert mf[k]["total_bytes"] == one["total_bytes"]
            assert mf[k]["per_device_bytes"] < one["per_device_bytes"]
            assert mf[k]["per_device_bytes"] == max(mf[k]["per_shard_bytes"])
        if tm.num_heads == 4:
            assert mf[2]["per_device_bytes"] > mf[4]["per_device_bytes"]
            # four shards on one device hold the whole model there
            assert mf[4]["physical_device_bytes"]["cpu"] == \
                one["total_bytes"]
    monkeypatch.setenv("MXNET_SERVE_SHARDED", "0")
    (_, tm), params = wide
    eng = ServingEngine(tm, params, ctx=_mesh(4), **KW)
    assert eng._mesh is None and eng._kv_shard is None
    assert eng.memory_footprint()["devices"] == 1
    submits = [(p, {"max_new_tokens": 6}) for p in PROMPTS[:3]]
    assert _serve(eng, submits) == _unsharded(
        tm, params, (4, True), [(p, {"max_new_tokens": 6})
                                for p in PROMPTS])[0][:3]


def test_moe_expert_load_equals_unsharded():
    """An MoE model over 4 shards (the experts split, the router
    replicated): the tokens and the per-expert load equal the unsharded
    engine's exactly, and the gauges follow."""
    jm = JModel(64, S, num_layers=2, num_heads=4, num_embed=32,
                moe_experts=4)
    tm = TransformerKVModel(64, S, num_layers=2, num_heads=4, num_embed=32,
                            moe_experts=4)
    params = jm.init_params(np.random.RandomState(9), scale=0.5)
    submits = [(p, {"max_new_tokens": 6}) for p in PROMPTS[:3]]
    want, _, load = _unsharded(tm, params, "moe", submits)
    eng = ServingEngine(tm, params, ctx=_mesh(4), name="moe_mesh", **KW)
    assert eng.model.plan.groups["experts"]
    got = _serve(eng, submits)
    assert got == want
    assert margins(jm, params, list(zip(PROMPTS[:3], got))).min() > 1e-3
    got_load = eng.expert_load()
    assert (got_load == load).all() and got_load.sum() > 0
    reg = telemetry.registry()
    assert [reg.gauge("serve.moe_mesh.expert_load.%d" % e).value
            for e in range(4)] == got_load.tolist()


def test_tier_and_handoff_bytes_equal_unsharded(wide):
    """A sub-mesh replica spills and restores the unsharded layout
    (tokens unchanged through a spill of every parked block), and a
    disaggregated pair of 2-shard replicas hands off the unsharded
    fleet's bytes."""
    (_, tm), params = wide
    kw = dict(KW, tier=True, host_blocks=64)
    plain = ServingEngine(tm, params, ctx="cpu", **kw)
    eng = ServingEngine(tm, params, ctx=_mesh(2), **kw)
    prompt = list(range(1, 18))
    outs = []
    for e in (plain, eng):
        first = _serve(e, [(prompt, {"max_new_tokens": 4})])
        e._alloc.reclaim(e._prefix.evict(e._alloc.capacity))
        again = _serve(e, [(prompt, {"max_new_tokens": 4})])
        assert first == again and e.stats["restored"] >= 1
        outs.append((again, e.stats["spilled"], e._tier.bytes))
        assert e.leaked_host_blocks() == 0
    # the same blocks spilled, in the same bytes
    assert outs[0] == outs[1]
    assert eng._tier._slot_bytes == plain._tier._slot_bytes

    def handoff_bytes(ctxs):
        telemetry.reset()
        engines = [ServingEngine(tm, params, ctx=c, name="replica%d" % i,
                                 **KW) for i, c in enumerate(ctxs)]
        router = ReplicaRouter(engines, respawn=False, disagg=True,
                               prefill_replicas=1)
        router.warmup()
        router.start()
        try:
            toks = [r.result(60) for r in
                    [router.submit(p, max_new_tokens=6) for p in PROMPTS]]
        finally:
            router.stop()
        return toks, telemetry.registry().counter("serve.handoff_bytes").value

    assert handoff_bytes(["cpu", "cpu"]) == handoff_bytes(
        submeshes(["cpu"] * 4, 2))


def test_sharded_cache_rebuild(wide):
    """A sharded decode that marks its cache and raises: the admitted
    request fails `ServeCacheInvalidated`, the cache is rebuilt as a fresh
    sharded one, and the queued request gets the unsharded tokens."""
    from mxnet_tpu_torch.serving import ServeCacheInvalidated
    from mxnet_tpu_torch.serving.sharded import ShardedCache
    (_, tm), params = wide
    eng = ServingEngine(tm, params, ctx=_mesh(2), **dict(KW, max_batch=1))
    real, left = eng._decode, [1]

    def decode(*a):
        if left[0]:
            left[0] -= 1
            eng.model._mark(eng._cache)
            raise RuntimeError("launch exploded mid-write")
        return real(*a)
    eng._decode = decode
    first = eng.submit(PROMPTS[0], max_new_tokens=6)
    second = eng.submit(PROMPTS[1], max_new_tokens=6)
    eng.run_until_idle(timeout=120)
    with pytest.raises(ServeCacheInvalidated):
        first.result(1)
    assert isinstance(eng._cache, ShardedCache)
    assert not eng.model.cache_lost(eng._cache)
    assert telemetry.registry().counter("serve.cache_rebuilds").value == 1
    want = _unsharded(tm, params, (4, True),
                      [(p, {"max_new_tokens": 6}) for p in PROMPTS])[0]
    assert second.result(1) == want[1]
    assert eng.leaked_blocks() == 0


# -- the fleet ------------------------------------------------------------------------


def test_from_mesh_groups_and_chaos_respawn(wide, monkeypatch):
    """`from_mesh` over a 4-entry mesh: two 2-shard replicas, one program
    space; with 1 every entry is a replica.  Under ``engine_crash:3:
    replica0,block_exhaust:0.05`` every request resolves (tokens or
    typed), the respawned replica keeps its width, survivors leak
    nothing."""
    (_, tm), params = wide
    grid = make_mesh((4,), ("model",), devices=["cpu"] * 4)
    singles = ReplicaRouter.from_mesh(tm, params, mesh=grid,
                                      devices_per_replica=1, **KW)
    assert len(singles.engines) == 4
    assert all(e._mesh is None for e in singles.engines)
    monkeypatch.setenv("MXNET_SERVE_SHARDED_DEVICES", "2")
    router = ReplicaRouter.from_mesh(tm, params, mesh=grid, respawn=True,
                                     n_blocks=24, block_size=8, **KW)
    assert [e.name for e in router.engines] == ["replica0", "replica1"]
    assert all(e._mesh.devices.shape == (2,) for e in router.engines)
    assert len({mesh_signature(e._mesh) for e in router.engines}) == 1
    router.warmup()
    monkeypatch.setenv("MXNET_CHAOS",
                       "engine_crash:3:replica0,block_exhaust:0.05")
    chaos.reset()
    rng = np.random.RandomState(5)
    router.start()
    try:
        reqs = [router.submit(list(rng.randint(1, 64, size=rng.randint(2, 9))),
                              max_new_tokens=6, deadline_ms=120000)
                for _ in range(10)]
        done = typed = 0
        for r in reqs:
            try:
                r.result(timeout=120)
                done += 1
            except ServeError:
                typed += 1
        # the monitor respawns the crashed replica at its width
        for _ in range(400):
            if telemetry.registry().counter("serve.respawns").value and \
                    len([e for e in router.engines if e._dead is None]) == 2:
                break
            time.sleep(0.05)
    finally:
        router.stop()
    assert done + typed == len(reqs) and done > 0
    assert telemetry.registry().counter("serve.respawns").value >= 1
    live = [e for e in router.engines if e._dead is None]
    assert len(live) == 2
    for e in live:
        assert e.leaked_blocks() == 0
        assert e._mesh is not None and e._mesh.devices.shape == (2,)
