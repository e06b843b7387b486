"""The port's `ReplicaRouter` and request journal against the JAX
package's, on the CPU.

The counterparts of `tests/test_serve_durability.py` (the replay formula,
exact-replay migration, the journal's kill switch, the rolling-restart
drain, the journal-off drain, the degrade cap on replayed requests, chaos
composition) and of `tests/test_serve_chaos.py`'s failover acceptance
test, at that file's size (V, S, L, H, E = 61, 32, 2, 2, 32, prefill
buckets [8, 16]) with the weights of `tests/test_torch_serving_prefix.py`.
Where a scenario is deterministic (a crash at a set decode step, a drain
on the caller's thread) it runs on both routers and the tokens, the
`serve.migrated`, `serve.replays`, `serve.failovers` and `serve.drained`
counters and the journal's migrations agree; the threaded Poisson runs
hold the port alone to the contract (every request resolves within its
deadline and a grace, the crash fails over, the replica respawns), with
the tokens of every finished request equal to the JAX engine's greedy
answer where each position's top-1/top-2 margin exceeds 1e-3.
"""
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.executor import AotCache
from mxnet_tpu.serving import ReplicaRouter as JReplicaRouter
from mxnet_tpu.serving import RequestJournal as JRequestJournal
from mxnet_tpu.serving import ServeRequest as JServeRequest
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.mesh import make_mesh
from mxnet_tpu_torch.serving import (ReplicaRouter, RequestJournal,
                                     ServeEngineDead, ServeError,
                                     ServeRequest, ServeTimeout,
                                     ServingEngine)

from test_torch_serving_prefix import (_AOT, _fresh_telemetry,  # noqa: F401
                                       margins, models, wparams)
from test_torch_kernels import _one_thread  # noqa: F401


V = 61
KW = dict(prefill_buckets=[8, 16])


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("MXNET_CHAOS", raising=False)
    monkeypatch.delenv("MXNET_SERVE_JOURNAL", raising=False)
    monkeypatch.delenv("MXNET_SERVE_RESPAWN", raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    for mod in (ttelemetry, jchaos, tchaos):
        mod.reset()
    yield
    for mod in (ttelemetry, jchaos, tchaos):
        mod.reset()


def _engines(models, params, jax_side, n=2, **kw):
    """``n`` engines of one package, named replica0, replica1, ...; the
    JAX ones greedy-only, sharing compiled programs per pool geometry."""
    jm, tm = models
    kw = dict(KW, **kw)
    out = []
    for i in range(n):
        name = "replica%d" % i
        if jax_side:
            probe = ServingEngine(tm, params, ctx="cpu", name=name, **kw)
            aot = _AOT.setdefault((probe.n_blocks, probe.block_size),
                                  AotCache("serve.aot"))
            out.append(JServingEngine(jm, params, sampling=False, aot=aot,
                                      name=name, **kw))
        else:
            out.append(ServingEngine(tm, params, ctx="cpu", name=name, **kw))
    return out


_ORACLE = {}


def _oracle(models, params, prompt, max_new):
    """The JAX engine's greedy answer, alone."""
    key = (tuple(prompt), max_new)
    if key not in _ORACLE:
        eng = _ORACLE.get("engine")
        if eng is None:
            eng = _ORACLE["engine"] = _engines(models, params, True, n=1,
                                               max_batch=1)[0]
        req = eng.submit(prompt, max_new_tokens=max_new)
        eng.run_until_idle(timeout=120)
        _ORACLE[key] = req.result(1)
    return _ORACLE[key]


def _margins_ok(models, params, reqs):
    ran = [(r.prompt, list(r.tokens)) for r in reqs if r.error is None]
    if ran:
        assert margins(models[0], params, ran).min() > 1e-3


def _counter(mod, name):
    return mod.registry().counter(name).value


# -- the journal ----------------------------------------------------------------


@pytest.mark.parametrize("tokens,want", [
    ([], None),
    ([11], ([5, 6, 7], 11, 3, 1)),
    ([11, 12, 13], ([5, 6, 7, 11, 12], 13, 5, 3)),
])
def test_replay_state_formula(tokens, want):
    """The resume tuple ``(prompt + generated[:-1], last, pos, n_new)``,
    None before anything was generated: the JAX journal's."""
    got = []
    for journal, request in ((JRequestJournal, JServeRequest),
                             (RequestJournal, ServeRequest)):
        req = request([5, 6, 7], max_new_tokens=8)
        req.tokens = list(tokens)
        got.append(journal.replay_state(req))
    assert got[0] == got[1] == want


def test_journal_records_live_requests():
    journal = RequestJournal()
    reqs = [ServeRequest([1, 2], 4) for _ in range(3)]
    assert [journal.record(r) for r in reqs] == [1, 2, 3]
    reqs[1]._finish()
    assert journal.depth() == 2


# -- migration on a replica's death ---------------------------------------------


def _crash_scenario(models, params, jax_side, monkeypatch, journal=True):
    chaos = jchaos if jax_side else tchaos
    router_cls = JReplicaRouter if jax_side else ReplicaRouter
    engines = _engines(models, params, jax_side, max_batch=2,
                       max_new_tokens=6)
    router = router_cls(engines, respawn=False, journal=journal)
    router.warmup()
    monkeypatch.setenv("MXNET_CHAOS", "engine_crash:2:replica0")
    chaos.reset()
    req = engines[0].submit([3, 4, 5], deadline_ms=60000)
    router.start()
    try:
        try:
            req.result(timeout=120)
        except ServeError:
            pass
        except Exception as e:  # the JAX package's own ServeError
            assert type(e).__name__ == "ServeEngineDead", e
    finally:
        router.stop()
    monkeypatch.delenv("MXNET_CHAOS")
    chaos.reset()
    return router, engines, req


def test_migration_resumes_inflight_token_exact(models, wparams,
                                                monkeypatch):
    """``engine_crash`` kills replica0 after its in-flight request made a
    partial answer: the request migrates to replica1, replays
    ``(prompt + generated)[:pos]`` and finishes with the undisturbed
    answer, on both routers alike; the deadline stays anchored at the
    original submit."""
    want = _oracle(models, wparams, [3, 4, 5], 6)
    out = {}
    for jax_side, mod in ((True, jtelemetry), (False, ttelemetry)):
        router, engines, req = _crash_scenario(models, wparams, jax_side,
                                               monkeypatch)
        assert engines[0]._dead is not None
        assert req.error is None and list(req.tokens) == want
        assert abs((req.t_deadline - req.t_submit) - 60.0) < 1e-6
        out[jax_side] = ([_counter(mod, k) for k in (
            "serve.migrated", "serve.replays", "serve.failovers",
            "serve.replica0.failover")], router.journal.migrations,
            engines[1].stats["replays"], engines[1].leaked_blocks())
    assert out[False] == out[True] == ([1, 1, 1, 1], 1, 1, 0)


def test_journal_kill_switch_fails_admitted_typed(models, wparams,
                                                  monkeypatch):
    """``MXNET_SERVE_JOURNAL=0``: the dead replica's admitted request
    fails `ServeEngineDead`, on both routers."""
    monkeypatch.setenv("MXNET_SERVE_JOURNAL", "0")
    for jax_side, mod in ((True, jtelemetry), (False, ttelemetry)):
        router, engines, req = _crash_scenario(models, wparams, jax_side,
                                               monkeypatch, journal=None)
        assert router.journal is None
        assert type(req.error).__name__ == "ServeEngineDead"
        assert _counter(mod, "serve.migrated") == 0
        assert _counter(mod, "serve.failovers") == 1


# -- drains ---------------------------------------------------------------------


def test_router_drain_rolling_restart_zero_failures(models, wparams):
    """Drain both replicas of a loaded router in turn with 1 ms budgets
    (stragglers mid-flight): every request completes with the
    undisturbed answer and nothing fails, on both routers; the
    replacements leak nothing."""
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, V, size=int(n)).tolist()
               for n in rng.randint(2, 8, size=6)]
    want = [_oracle(models, wparams, p, 8) for p in prompts]
    for jax_side, mod in ((True, jtelemetry), (False, ttelemetry)):
        engines = _engines(models, wparams, jax_side, max_batch=2,
                           max_new_tokens=8)
        router = (JReplicaRouter if jax_side else ReplicaRouter)(
            engines, respawn=False)
        router.warmup()
        router.start()
        try:
            reqs = [router.submit(p) for p in prompts]
            fresh0 = router.drain("replica0", deadline_ms=1)
            assert fresh0 is not None and fresh0.name == "replica0"
            fresh1 = router.drain("replica1", deadline_ms=1)
            assert fresh1 is not None
            outs = [r.result(timeout=120) for r in reqs]
        finally:
            router.stop()
        assert outs == want
        assert _counter(mod, "serve.drained") == 2
        for e in (fresh0, fresh1):
            assert e.leaked_blocks() == 0


def test_journal_off_drain_redispatches_queued_stragglers(
        models, wparams, monkeypatch):
    """With the journal off, `router.drain` is no lossier than a crash:
    queued stragglers (nothing generated, nothing to replay) redispatch
    to the survivor; only the in-flight one fails typed."""
    engines = [ServingEngine(models[1], wparams, ctx="cpu", name=name,
                             max_batch=b, max_new_tokens=30, **KW)
               for name, b in (("replica0", 1), ("replica1", 2))]
    router = ReplicaRouter(engines, respawn=False, journal=False)
    router.warmup()
    # every decode pinned at 50 ms, so the 1 ms drain strands work: the
    # one admitted request mid-generation, two still queued
    monkeypatch.setenv("MXNET_CHAOS", "decode_slow:1.0:50")
    tchaos.reset()
    reqs = [engines[0].submit([3 + i, 4], max_new_tokens=30)
            for i in range(3)]
    engines[0].start()
    engines[1].start()
    while not reqs[0].tokens:
        time.sleep(0.01)
    router.drain("replica0", deadline_ms=1, respawn=False)
    monkeypatch.delenv("MXNET_CHAOS")
    tchaos.reset()
    ok, typed = 0, 0
    for r in reqs:
        try:
            r.result(timeout=120)
            ok += 1
        except ServeEngineDead:
            typed += 1
    router.stop()
    assert (ok, typed) == (2, 1)
    assert _counter(ttelemetry, "serve.redispatched") >= 2


def test_degrade_cap_never_truncates_replayed_requests(models, wparams):
    """The degrade cap shortens new work but never a migrated request:
    its output is promised and partly delivered."""
    eng = ServingEngine(models[1], wparams, ctx="cpu", max_new_tokens=8,
                        queue_max=1, overload="degrade", **KW)
    eng._queue.append(ServeRequest([1], 1))
    fresh = ServeRequest([2, 3], 8)
    eng._enqueue(fresh)
    assert fresh.max_new_tokens == 2
    moved = ServeRequest([2, 3], 8)
    moved.tokens = [5, 6, 7]
    moved._resume = ([2, 3, 5, 6], 7, 4, 3)
    moved._migrated = True
    eng._enqueue(moved)
    assert moved.max_new_tokens == 8


# -- chaos under traffic --------------------------------------------------------


def _poisson(router, rng, n, deadline_ms):
    reqs = []
    for _ in range(n):
        prompt = rng.randint(0, V, size=int(rng.randint(1, 8))).tolist()
        reqs.append(router.submit(prompt, deadline_ms=deadline_ms))
        time.sleep(float(rng.exponential(0.02)))
    return reqs


def _resolve(reqs, deadline_ms, grace_ms=5000.0):
    ok = typed = 0
    for r in reqs:
        try:
            r.result(timeout=120)
            ok += 1
        except ServeTimeout:
            pytest.fail("request %d hung (no resolution)" % r.id)
        except ServeError:
            typed += 1
    assert ok + typed == len(reqs) and all(r.done for r in reqs)
    for r in reqs:
        assert r.latency_ms is not None
        assert r.latency_ms <= deadline_ms + grace_ms
    return ok


def test_chaos_failover_acceptance(models, wparams, monkeypatch):
    """Two replicas under Poisson traffic with ``engine_crash:3:replica0``
    and ``decode_slow:0.2:5``: every request resolves within its deadline
    and a grace, the crash fails over, the monitor respawns the replica,
    later traffic is served, and every finished request has the JAX
    engine's greedy answer."""
    monkeypatch.setenv("MXNET_CHAOS_SEED", "7")
    monkeypatch.setenv("MXNET_CHAOS", "engine_crash:3:replica0,"
                                      "decode_slow:0.2:5")
    tchaos.reset()
    deadline_ms = 60000.0
    engines = _engines(models, wparams, False, max_batch=2,
                       max_new_tokens=4, deadline_ms=deadline_ms)
    router = ReplicaRouter(engines, respawn=True)
    router.warmup()
    rng = np.random.RandomState(3)
    router.start()
    try:
        reqs = _poisson(router, rng, 14, deadline_ms)
        assert _resolve(reqs, deadline_ms) > 0
        assert _counter(ttelemetry, "serve.failovers") >= 1
        t0 = time.perf_counter()
        while _counter(ttelemetry, "serve.respawns") < 1:
            assert time.perf_counter() - t0 < 30, "respawn never happened"
            time.sleep(0.05)
        tail = [router.submit(rng.randint(0, V, size=3).tolist())
                for _ in range(4)]
        for r in tail:
            r.result(timeout=120)
    finally:
        router.stop()
    monkeypatch.delenv("MXNET_CHAOS")
    jchaos.reset()
    done = [r for r in reqs + tail if r.error is None]
    for r in done:
        assert list(r.tokens) == _oracle(models, wparams, r.prompt,
                                         r.max_new_tokens)
    _margins_ok(models, wparams, done)
    assert [e["replica"] for e in ttelemetry.events("serve_respawn")] == \
        ["replica0"]


def test_chaos_composition_durability(models, wparams, monkeypatch):
    """``engine_crash`` and ``block_exhaust`` at once on two replicas:
    no request hangs, every one resolves in bounded time, and the
    survivors leak no block."""
    monkeypatch.setenv("MXNET_CHAOS_SEED", "5")
    monkeypatch.setenv("MXNET_CHAOS", "engine_crash:3:replica0,"
                                      "block_exhaust:0.2")
    tchaos.reset()
    deadline_ms = 60000.0
    engines = _engines(models, wparams, False, max_batch=2,
                       max_new_tokens=4, deadline_ms=deadline_ms)
    router = ReplicaRouter(engines, respawn=True)
    router.warmup()
    rng = np.random.RandomState(3)
    router.start()
    try:
        reqs = _poisson(router, rng, 12, deadline_ms)
        assert _resolve(reqs, deadline_ms) > 0
        assert _counter(ttelemetry, "serve.failovers") >= 1
    finally:
        router.stop()
    for e in router.engines:
        if e._dead is None:
            assert e.leaked_blocks() == 0


# -- the router's surface -------------------------------------------------------


def test_add_and_remove_replicas(models, wparams):
    """`add_replica` templates a started replica off a live one (the
    parameters shared); `remove_replica` drains one and drops it, and
    refuses the last."""
    engines = _engines(models, wparams, False, n=1, max_batch=2,
                       max_new_tokens=3)
    router = ReplicaRouter(engines, respawn=False)
    router.warmup()
    router.start()
    try:
        fresh = router.add_replica()
        assert fresh.name == "replica1" and len(router.engines) == 2
        assert all(t is engines[0]._params[k]
                   for k, t in fresh._params.items())
        reqs = [router.submit([3 + i, 4]) for i in range(4)]
        assert [len(r.result(timeout=60)) for r in reqs] == [3] * 4
        assert router.remove_replica("replica0") == "replica0"
        assert [e.name for e in router.engines] == ["replica1"]
        with pytest.raises(MXNetError, match="last replica"):
            router.remove_replica()
        assert router.depth() == 0
    finally:
        router.stop()


def test_unported_router_parts_name_their_roadmap_item(models, wparams,
                                                       monkeypatch):
    # sharded replicas are ported: from_mesh builds a fleet over a mesh
    # (one replica an entry, or sub-mesh replicas), the shard rules
    # answer; with no card and no mesh from_mesh refuses
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    router = ReplicaRouter.from_mesh(models[1], wparams, mesh=mesh, **KW)
    assert [e.name for e in router.engines] == ["replica0", "replica1"]
    router = ReplicaRouter.from_mesh(models[1], wparams, mesh=mesh,
                                     devices_per_replica=2, **KW)
    assert len(router.engines) == 1
    assert router.engines[0]._mesh.devices.shape == (2,)
    assert models[1].param_shardings(mesh)["layer0_q_weight"] == 0
    assert models[1].kv_shardings(mesh) == (4, None)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            ReplicaRouter.from_mesh(models[1], wparams)
    # disaggregation is ported: the keyword and the env switch build roles
    pair = _engines(models, wparams, False, n=2)
    ReplicaRouter(pair, disagg=True)
    assert [e.role for e in pair] == ["prefill", "decode"]
    pair = _engines(models, wparams, False, n=2)
    monkeypatch.setenv("MXNET_SERVE_DISAGG", "1")
    ReplicaRouter(pair)
    assert [e.role for e in pair] == ["prefill", "decode"]
    monkeypatch.delenv("MXNET_SERVE_DISAGG")
    engines = _engines(models, wparams, False, n=1)
    router = ReplicaRouter(engines)
    # sessions are ported: a session turn is served, and a stopped
    # replica's sessions have nowhere to go without a survivor
    req = router.submit([1, 2], session="chat", max_new_tokens=2)
    router.run_until_idle(timeout=60)
    assert req.result(1) and engines[0].has_session("chat")
    assert router._migrate_sessions(engines[0], {}) == 0
    assert not engines[0].has_session("chat")
    with pytest.raises(MXNetError, match="no replica named"):
        router.drain("replica9")
