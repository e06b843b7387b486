"""The port's disaggregated prefill/decode fleet against the JAX
package's, on the CPU.

The counterparts of `tests/test_serve_disagg.py`'s scenarios, at its size
(V, S, L, H, E = 61, 32, 2, 2, 32, prefill buckets [8, 16]) with the
weights of `tests/test_torch_serving_prefix.py`:

* ``handoff_fail`` parses, `disagg_enabled` reads the switch, the router
  refuses a split without a decode replica or without paging;
* a prefill and a decode replica serve token for token the JAX engine's
  greedy answer (where every position's top-1/top-2 margin exceeds 1e-3)
  and the JAX disaggregated fleet's, with its handoff counters and bytes,
  the decode replica running no prefill chunk; seeded sampling gives the
  JAX engine's sampled tokens;
* the kill switch wires no roles and hands nothing off;
* ``handoff_fail:1.0`` resolves every request by exact replay, counted as
  the JAX fleet counts it;
* a decode target that dies with tickets staged and in its inbox (killed
  at a chosen landing, not by racing the scheduler) loses no request;
* a session's follow-up turn lands on the decode replica that holds it;
* a rolling restart under traffic fails nothing and keeps the roles;
* ``handoff_fail`` + ``engine_crash`` + ``block_exhaust`` together: every
  request resolves, no block leaks on a survivor.

Every wait has a timeout; no sleep orders the events.
"""
import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.executor import AotCache
from mxnet_tpu.serving import ReplicaRouter as JReplicaRouter
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving import disagg_enabled as jdisagg_enabled
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (ReplicaRouter, ServeError,
                                     ServeTimeout, disagg_enabled)

from test_torch_serving_prefix import models, wparams  # noqa: F401
from test_torch_serving_router import _engines, _margins_ok, _oracle
from test_torch_kernels import _one_thread  # noqa: F401

V = 61


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for pin in ("MXNET_CHAOS", "MXNET_SERVE_DISAGG",
                "MXNET_SERVE_PREFILL_REPLICAS", "MXNET_SERVE_JOURNAL",
                "MXNET_SERVE_RESPAWN"):
        monkeypatch.delenv(pin, raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    for mod in (telemetry, jtelemetry, chaos, jchaos):
        mod.reset()
    yield
    for mod in (telemetry, jtelemetry, chaos, jchaos):
        mod.reset()


def _chaos(monkeypatch, spec):
    monkeypatch.setenv("MXNET_CHAOS", spec)
    chaos.reset()
    jchaos.reset()


def _serve(router, submits, timeout=120):
    """Submit (prompt, kwargs) pairs through a started router and wait
    for every one (a failure stays on the request); then stop."""
    router.start()
    try:
        reqs = [router.submit(p, **kw) for p, kw in submits]
        for r in reqs:
            try:
                r.result(timeout=timeout)
            except ServeTimeout:
                pytest.fail("request %d hung" % r.id)
            except ServeError:
                pass
    finally:
        router.stop()
    return reqs


def _fleet(models, params, n=2, jax_side=False, p=1, **kw):
    engines = _engines(models, params, jax_side, n=n, **kw)
    cls = JReplicaRouter if jax_side else ReplicaRouter
    router = cls(engines, respawn=False, disagg=True, prefill_replicas=p)
    router.warmup()
    return engines, router


def _count(mod, name):
    return mod.registry().counter(name).value


PROMPTS = [[3, 4, 5], [7, 8], [9] * 6, [2], [5, 6, 7, 8, 9]]


# -- parsing and validation ---------------------------------------------------


def test_handoff_fail_clause_and_switch_parse(monkeypatch):
    _chaos(monkeypatch, "handoff_fail:0.25")
    assert chaos.spec().handoff_fail == jchaos.spec().handoff_fail == 0.25
    assert not disagg_enabled() and not jdisagg_enabled()
    for v, want in (("1", True), ("0", False), ("false", False),
                    ("no", False), ("yes", True)):
        monkeypatch.setenv("MXNET_SERVE_DISAGG", v)
        assert disagg_enabled() is want is jdisagg_enabled()


def test_split_must_leave_a_decode_replica(models, wparams):
    with pytest.raises(MXNetError, match="decode"):
        ReplicaRouter(_engines(models, wparams, False, n=2), respawn=False,
                      disagg=True, prefill_replicas=2)
    slot = _engines(models, wparams, False, n=2, paged=False)
    with pytest.raises(MXNetError, match="paged"):
        ReplicaRouter(slot, respawn=False, disagg=True)
    # one replica cannot split: the router stays colocated
    one = _engines(models, wparams, False, n=1)
    assert ReplicaRouter(one, disagg=True)._disagg is False
    assert one[0].role is None


# -- parity -------------------------------------------------------------------


def test_disagg_parity_t0(models, wparams):
    """Every prompt prefills on replica0, hands off and decodes on
    replica1: the JAX engine's tokens and the JAX fleet's, the same
    handoff counts and bytes, no prefill chunk on the decode replica, no
    leak on either."""
    want = [_oracle(models, wparams, p, 6) for p in PROMPTS]
    submits = [(p, {"max_new_tokens": 6}) for p in PROMPTS]
    jengines, jrouter = _fleet(models, wparams, jax_side=True)
    jreqs = _serve(jrouter, submits)
    assert [r.result(1) for r in jreqs] == want
    engines, router = _fleet(models, wparams)
    assert [e.role for e in engines] == ["prefill", "decode"]
    reqs = _serve(router, submits)
    assert [r.result(1) for r in reqs] == want
    _margins_ok(models, wparams, reqs)
    assert engines[0].stats["handoffs"] == len(PROMPTS) == \
        jengines[0].stats["handoffs"]
    assert engines[1].stats["handoffs_in"] == len(PROMPTS)
    assert engines[0].stats["handoff_fails"] == 0
    assert engines[1].stats["prefill_chunks"] == 0
    for name in ("serve.handoffs", "serve.handoffs_in", "serve.handoff_bytes"):
        assert _count(telemetry, name) == _count(jtelemetry, name) > 0, name
    assert telemetry.registry()._hist_counts.get(
        "serve.handoff_wait_ms", 0) == len(PROMPTS)
    assert telemetry.registry().gauge("serve.replica1.role").value == 2
    for e in engines + jengines:
        assert e.leaked_blocks() == 0


def test_disagg_parity_seeded_sampling(models, wparams):
    """Sampling keyed by (seed, position): the disaggregated fleet draws
    the JAX engine's tokens."""
    prompts = [[3, 4, 5], [7, 8, 9, 10], [2] * 5]
    kw = {"max_new_tokens": 6, "temperature": 0.8, "top_k": 8}
    jeng = JServingEngine(models[0], wparams, aot=AotCache("serve.aot"),
                          max_batch=4, prefill_buckets=[8, 16])
    jeng.warmup()
    jreqs = [jeng.submit(p, seed=100 + i, **kw)
             for i, p in enumerate(prompts)]
    jeng.run_until_idle(timeout=120)
    engines, router = _fleet(models, wparams)
    reqs = _serve(router, [(p, dict(kw, seed=100 + i))
                           for i, p in enumerate(prompts)])
    assert [r.result(1) for r in reqs] == [r.result(1) for r in jreqs]
    assert engines[1].stats["handoffs_in"] == len(prompts)
    assert all(e.leaked_blocks() == 0 for e in engines)


def test_kill_switch_is_colocated(models, wparams):
    """No disagg: no roles, no sink, nothing handed off, the tokens of
    the colocated router."""
    engines = _engines(models, wparams, False, n=2)
    router = ReplicaRouter(engines, respawn=False)
    assert router._disagg is False
    assert all(e.role is None and e._handoff_sink is None for e in engines)
    router.warmup()
    reqs = _serve(router, [(p, {"max_new_tokens": 6}) for p in PROMPTS[:3]])
    assert [r.result(1) for r in reqs] == \
        [_oracle(models, wparams, p, 6) for p in PROMPTS[:3]]
    for k in ("serve.handoffs", "serve.handoffs_in", "serve.handoff_fails",
              "serve.replays_from_handoff"):
        assert _count(telemetry, k) == 0
    assert all(e.stats["handoffs"] == 0 for e in engines)


# -- the failure roads --------------------------------------------------------


def test_handoff_fail_falls_back_to_exact_replay(models, wparams,
                                                 monkeypatch):
    """``handoff_fail:1.0``: every transfer dies at the pack, and every
    request still resolves with the oracle's tokens by exact replay,
    counted as the JAX fleet counts it."""
    prompts = [[3 + i, 4, 5] for i in range(6)]
    want = [_oracle(models, wparams, p, 6) for p in prompts]
    submits = [(p, {"max_new_tokens": 6}) for p in prompts]
    jengines, jrouter = _fleet(models, wparams, jax_side=True)
    engines, router = _fleet(models, wparams)
    _chaos(monkeypatch, "handoff_fail:1.0")
    jreqs = _serve(jrouter, submits)
    reqs = _serve(router, submits)
    assert [r.result(1) for r in reqs] == want == \
        [r.result(1) for r in jreqs]
    assert engines[0].stats["handoffs"] == 0
    assert engines[0].stats["handoff_fails"] == len(prompts) == \
        jengines[0].stats["handoff_fails"]
    assert router.journal.handoff_replays == len(prompts) == \
        jrouter.journal.handoff_replays
    for k in ("serve.handoff_fails", "serve.replays_from_handoff"):
        assert _count(telemetry, k) == _count(jtelemetry, k) == len(prompts)
    assert all(e.leaked_blocks() == 0 for e in engines)


def test_decode_target_death_mid_transfer(models, wparams):
    """replica1, the decode target with the least depth, dies when its
    third landing comes due, with tickets staged and in its inbox: their
    requests migrate by exact replay and finish on replica2 with the
    oracle's tokens."""
    prompts = [[3 + i, 4, 5] for i in range(8)]
    want = [_oracle(models, wparams, p, 6) for p in prompts]
    engines, router = _fleet(models, wparams, n=3)
    assert [e.role for e in engines] == ["prefill", "decode", "decode"]
    target = engines[1]
    landings = []
    land = target._complete_landing

    def dying_landing(ld):
        landings.append(ld.ticket.req.id)
        if len(landings) == 3:
            raise chaos.ChaosEngineCrash("test: decode target killed with "
                                         "landings in flight")
        return land(ld)
    target._complete_landing = dying_landing
    reqs = _serve(router, [(p, {"max_new_tokens": 6,
                                "deadline_ms": 60000}) for p in prompts])
    assert target._dead is not None and len(landings) == 3
    assert [r.result(1) for r in reqs] == want
    assert _count(telemetry, "serve.migrated") >= 1
    for e in engines:
        if e._dead is None:
            assert e.leaked_blocks() == 0


def test_session_follow_up_lands_on_decode_holder(models, wparams):
    """Turn 1 prefills on replica0 and decodes on replica1, which stores
    the history; turn 2 lands on replica1 (a session hit), with the
    tokens of the whole history's greedy answer."""
    turn1, suffix = [3, 4, 5, 6], [7, 8]
    want1 = _oracle(models, wparams, turn1, 4)
    want2 = _oracle(models, wparams, turn1 + want1 + suffix, 4)
    engines, router = _fleet(models, wparams, tier=True, host_blocks=32)
    router.start()
    try:
        q1 = router.submit(turn1, max_new_tokens=4, session="chat")
        assert q1.result(timeout=120) == want1
        q2 = router.submit(suffix, max_new_tokens=4, session="chat")
        assert q2.result(timeout=120) == want2
    finally:
        router.stop()
    assert engines[1].stats["session_hits"] == 1
    assert engines[0].stats["session_hits"] == 0
    assert engines[1].has_session("chat")
    for e in engines:
        assert e.leaked_blocks() == 0 and e.leaked_host_blocks() == 0


def test_rolling_restart_with_disagg_zero_failed(models, wparams):
    """Drain every replica in turn while requests are in flight: nothing
    fails, the tokens are the oracle's and the replacements keep their
    predecessors' roles."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, V, size=int(rng.randint(1, 8))).tolist()
               for _ in range(18)]
    engines = _engines(models, wparams, False, n=3, max_new_tokens=4)
    router = ReplicaRouter(engines, respawn=True, disagg=True,
                           prefill_replicas=1)
    router.warmup()
    router.start()
    reqs = []
    try:
        for i, name in enumerate(("replica0", "replica1", "replica2")):
            reqs += [router.submit(p, max_new_tokens=4)
                     for p in prompts[6 * i:6 * i + 6]]
            router.drain(name, deadline_ms=200)
        got = [r.result(timeout=120) for r in reqs]   # raises on a failure
    finally:
        router.stop()
    assert got == [_oracle(models, wparams, p, 4) for p in prompts]
    assert [e.role for e in router.engines] == \
        ["prefill", "decode", "decode"]
    for e in router.engines:
        assert e.leaked_blocks() == 0


def test_chaos_composition_disagg(models, wparams, monkeypatch):
    """``handoff_fail:0.3,engine_crash:5:replica1,block_exhaust:0.1`` on a
    respawning 1 + 2 fleet: every request resolves (tokens or typed), at
    least one with tokens, the crash happened, no survivor leaks."""
    monkeypatch.setenv("MXNET_CHAOS_SEED", "5")
    _chaos(monkeypatch,
           "handoff_fail:0.3,engine_crash:5:replica1,block_exhaust:0.1")
    engines = _engines(models, wparams, False, n=3, max_new_tokens=4,
                       deadline_ms=60000.0)
    router = ReplicaRouter(engines, respawn=True, disagg=True,
                           prefill_replicas=1)
    router.warmup()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, V, size=int(rng.randint(1, 8))).tolist()
               for _ in range(24)]
    reqs = _serve(router, [(p, {}) for p in prompts])
    ok = sum(r.error is None for r in reqs)
    assert all(r.done for r in reqs) and ok > 0
    assert engines[1]._dead is not None
    assert _count(telemetry, "serve.handoff_fails") > 0
    for e in router.engines:
        if e._dead is None:
            assert e.leaked_blocks() == 0
