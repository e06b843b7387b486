"""The port's request tracing against the JAX package's, on the CPU.

The counterparts of `tests/test_tracing.py`'s scenarios, at its size (V, S,
L, H, E = 61, 32, 2, 2, 32, prefill buckets [8, 16]) with the weights of
`tests/test_torch_serving_prefix.py`:

* the `Tracer` phase machine fed the same calls as the JAX one gives the
  same records (phases, parents, attribution on the root, the
  ``serve.attr.*`` histograms); a failed trace skips the attribution; the
  flight-recorder ring is bounded and dumps as one record; the telemetry
  event tap mirrors replica events;
* an engine's span trees are connected, one root each, their interval
  phases tile > 0.8 of e2e, and each trace's phase sequence equals the JAX
  engine's on the same traffic;
* a preemption replay and a journal migration keep the trace id (a
  ``replay`` phase), one trace crosses the disaggregated handoff (spans on
  both replicas, the pack and land leaves), a sub-mesh replica traces as
  any engine;
* the flight recorder dumps on ``engine_crash`` (``scheduler_death``) and
  on ``handoff_fail``;
* ``MXNET_SERVE_TRACING=0``: the same tokens, no record, no tracer;
* ``serve.handoff_wait_ms`` agrees with the span attribution;
* the gateway's ``gateway_send`` span;
* `tools/trace_report.py` renders the port's records and writes valid
  Chrome trace JSON.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu import tracing as jtracing
from mxnet_tpu_torch import chaos, telemetry, tracing
from mxnet_tpu_torch.parallel.mesh import submeshes
from mxnet_tpu_torch.serving import ReplicaRouter, ServeError, ServingEngine

from test_torch_serving_prefix import models, wparams  # noqa: F401
from test_torch_serving_router import _engines
from test_torch_kernels import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_REPORT = os.path.join(REPO, "tools", "trace_report.py")
KW = dict(max_batch=4, prefill_buckets=[8, 16], max_new_tokens=6,
          sampling=False)
PROMPTS = [[3, 4, 5], [7, 8], [9] * 6]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXNET_CHAOS", "MXNET_SERVE_TRACING", "MXNET_SERVE_DISAGG",
                "MXNET_SERVE_PREFILL_REPLICAS", "MXNET_TRACE_RING"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    for mod in (telemetry, tracing, chaos, jtelemetry, jtracing, jchaos):
        mod.reset()
    yield
    for mod in (telemetry, tracing, chaos, jtelemetry, jtracing, jchaos):
        mod.reset()


def _sink(mod=telemetry):
    return mod.add_sink(mod.MemorySink())


def _chaos(monkeypatch, spec):
    monkeypatch.setenv("MXNET_CHAOS", spec)
    chaos.reset()


def _spans(sink):
    by_trace = tracing.spans(sink.records)
    by_trace.pop(0, None)   # replica-scoped megastep/sweep spans
    return by_trace


def _assert_connected(trace_spans):
    sids = {s["sid"] for s in trace_spans}
    for s in trace_spans:
        if s.get("parent") in (0, None):
            continue
        assert s["parent"] in sids, "orphan span %s" % s


def _root_of(trace_spans):
    roots = [s for s in trace_spans if s["phase"] == "request"]
    assert len(roots) == 1
    return roots[0]


def _attributed_frac(root):
    attrs = root.get("attrs") or {}
    attributed = sum(v for k, v in attrs.items()
                     if k.endswith("_ms") and k not in ("ttft_ms", "e2e_ms")
                     and isinstance(v, (int, float)))
    return attributed / max(root["ms"], 1e-9)


def _run_router(router, submits, timeout=120):
    router.start()
    try:
        reqs = [router.submit(p, **kw) for p, kw in submits]
        for r in reqs:
            try:
                r.result(timeout=timeout)
            except ServeError:
                pass
    finally:
        router.stop()
    return reqs


def _fleet(models, params, n, **kw):
    return [ServingEngine(models[1], params, ctx="cpu", name="replica%d" % i,
                          **dict(KW, **kw)) for i in range(n)]


# -- the phase machine and the recorder ----------------------------------------


def _drive(mod, t0):
    mod.open_trace(7, "r0", t=t0)
    mod.phase(7, "queue_wait", "r0", t=t0)
    mod.phase(7, "prefill", "r0", t=t0 + 0.010)
    mod.add_span(7, "prefill_chunk", "r0", t0 + 0.011, t0 + 0.014, tokens=8)
    mod.phase(7, "decode", "r0", t=t0 + 0.030)
    return mod.finish(7, ttft_ms=30.0, e2e_ms=90.0, n_tokens=4)


def _shape(rec):
    out = {k: v for k, v in rec.items() if k not in ("t0", "t1", "ms")}
    if rec.get("phase") == "request":
        out["attrs"] = {k: v for k, v in rec["attrs"].items()
                        if k in ("ok", "ttft_ms", "n_tokens")}
    return out


def test_phase_machine_matches_jax():
    """The same calls on both tracers: the same records (sids, parents,
    phases, intervals), the same attribution on the root and in the
    ``serve.attr.*`` histograms."""
    sinks = [_sink(telemetry), _sink(jtelemetry)]
    t0 = time.perf_counter()
    recs = [_drive(tracing, t0), _drive(jtracing, t0)]
    spans = [[r for r in s.records if r.get("type") == "span"]
             for s in sinks]
    assert [s["phase"] for s in spans[0]] == [
        "queue_wait", "prefill_chunk", "prefill", "decode", "request"]
    assert [_shape(r) for r in spans[0]] == [_shape(r) for r in spans[1]]
    # the decode interval closes at finish, on each clock
    assert [s["ms"] for s in spans[0][:3]] == [s["ms"] for s in spans[1][:3]]
    _assert_connected(spans[0])
    root = _root_of(spans[0])
    assert recs[0] == root
    by = {s["phase"]: s for s in spans[0]}
    assert by["prefill_chunk"]["parent"] == by["prefill"]["sid"]
    assert by["queue_wait"]["parent"] == root["sid"]
    assert root["attrs"]["queue_wait_ms"] == pytest.approx(10.0, abs=0.5)
    assert root["attrs"]["prefill_ms"] == pytest.approx(20.0, abs=0.5)
    hists = [telemetry.registry()._hists, jtelemetry.registry()._hists]
    assert sorted(hists[0]) == sorted(hists[1])
    assert hists[0]["serve.attr.e2e_ms"] == [90.0]
    assert hists[0]["serve.attr.ttft_ms"] == [30.0]
    assert hists[0]["serve.attr.queue_wait_ms"] == \
        hists[1]["serve.attr.queue_wait_ms"]
    assert tracing.tracer().open_traces() == []
    assert tracing.PHASES == jtracing.PHASES
    assert tracing.ATTR_PHASES == jtracing.ATTR_PHASES


def test_failed_trace_skips_attribution():
    sink = _sink()
    tracing.phase(3, "queue_wait", "r0")
    tracing.finish(3, error="ServeTimeout", e2e_ms=5.0)
    root = _root_of([r for r in sink.records if r.get("type") == "span"])
    assert root["attrs"]["ok"] is False
    assert root["attrs"]["error"] == "ServeTimeout"
    assert "serve.attr.e2e_ms" not in telemetry.registry()._hists


def test_ring_bounded_dump_atomic_and_event_tap(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_RING", "8")
    sink = _sink()
    for i in range(40):
        tracing.note("r0", {"kind": "tick", "i": i})
    assert len(tracing.snapshot("r0")) == 8
    assert tracing.snapshot("r0")[-1]["i"] == 39
    rec = tracing.dump("r0", "quarantine", request=17)
    assert rec["type"] == "flight_recorder" and rec["reason"] == "quarantine"
    assert rec["n"] == len(rec["tail"]) == 8 and rec["ring_cap"] == 8
    assert rec["request"] == 17
    assert [r for r in sink.records
            if r.get("type") == "flight_recorder"] == [rec]
    telemetry.record_event("serve_probe", replica="r9", detail=1)
    ring = tracing.snapshot("r9")
    assert ring and ring[-1]["kind"] == "serve_probe"
    assert ring[-1]["type"] == "event"


# -- engines ------------------------------------------------------------------------


def test_engine_span_trees_match_jax(models, wparams):
    """Connected trees, one root, > 0.8 of e2e attributed, the published
    count on the root, no open trace; each trace's phases in the JAX
    engine's order on the same traffic."""
    phases = []
    for jax_side in (True, False):
        mod = jtelemetry if jax_side else telemetry
        sink = _sink(mod)
        eng = _engines(models, wparams, jax_side, n=1, max_batch=4,
                       max_new_tokens=6)[0]
        eng.warmup()
        published = []
        reqs = [eng.submit(p, max_new_tokens=6, on_token=published.append)
                if i == 0 else eng.submit(p, max_new_tokens=6)
                for i, p in enumerate(PROMPTS)]
        eng.run_until_idle(timeout=120)
        eng.stop()
        by = (jtracing if jax_side else tracing).spans(sink.records)
        by.pop(0, None)
        phases.append([[s["phase"] for s in sorted(
            by[r.id], key=lambda s: s["sid"])] for r in reqs])
    for r in reqs:
        spans = by[r.id]
        _assert_connected(spans)
        root = _root_of(spans)
        assert root["attrs"]["ok"] is True
        assert root["attrs"]["n_tokens"] == len(r.tokens)
        assert _attributed_frac(root) > 0.8
    assert _root_of(by[reqs[0].id])["attrs"]["published"] == \
        len(published) == len(reqs[0].tokens)
    assert phases[0] == phases[1]
    assert tracing.tracer().open_traces() == []


def test_preemption_replay_keeps_trace(models, wparams):
    rng = np.random.RandomState(13)
    sink = _sink()
    eng = ServingEngine(models[1], wparams, ctx="cpu",
                        **dict(KW, max_batch=2, n_blocks=4,
                               max_new_tokens=12))
    ra = eng.submit(list(rng.randint(0, 61, size=7)), max_new_tokens=12)
    rb = eng.submit(list(rng.randint(0, 61, size=7)), max_new_tokens=12)
    eng.run_until_idle(timeout=120)
    eng.stop()
    ra.result(1), rb.result(1)
    assert eng.stats["preemptions"] >= 1
    by = _spans(sink)
    assert sorted(by) == sorted([ra.id, rb.id])
    seen = set()
    for spans in by.values():
        _assert_connected(spans)
        assert _root_of(spans)["attrs"]["ok"] is True
        seen.update(s["phase"] for s in spans)
    assert "replay" in seen
    assert tracing.tracer().open_traces() == []


def test_handoff_trace_crosses_replicas_and_wait_agrees(models, wparams):
    sink = _sink()
    engines = _fleet(models, wparams, 2)
    router = ReplicaRouter(engines, respawn=False, disagg=True,
                           prefill_replicas=1)
    router.warmup()
    reqs = _run_router(router, [(p, {"max_new_tokens": 6})
                                for p in PROMPTS + [[3, 4, 5, 6]]])
    assert all(r.done and r.error is None for r in reqs)
    assert engines[0].stats["handoffs"] == len(reqs)
    by = _spans(sink)
    assert sorted(by) == sorted(r.id for r in reqs)
    for r in reqs:
        spans = by[r.id]
        _assert_connected(spans)
        root = _root_of(spans)
        assert root["attrs"]["n_tokens"] == len(r.tokens)
        assert {"prefill", "handoff_wait", "handoff_pack", "handoff_land",
                "decode"} <= {s["phase"] for s in spans}
        assert {s["replica"] for s in spans} == {"replica0", "replica1"}
        assert _attributed_frac(root) > 0.8
    hists = telemetry.registry()._hists
    metric = hists["serve.handoff_wait_ms"]
    attr = hists["serve.attr.handoff_wait_ms"]
    assert len(metric) == len(attr) == len(reqs)
    m_mean, a_mean = np.mean(metric), np.mean(attr)
    assert abs(m_mean - a_mean) <= max(0.5 * max(m_mean, a_mean), 30.0)
    assert tracing.tracer().open_traces() == []


def test_migration_keeps_trace_and_crash_dumps(models, wparams, monkeypatch):
    """``engine_crash``: the in-flight requests replay on the survivor
    under their original trace ids (a ``replay`` phase), and the dead
    replica's ring dumps as one ``scheduler_death`` record."""
    sink = _sink()
    engines = _fleet(models, wparams, 2)
    router = ReplicaRouter(engines, respawn=False)
    router.warmup()
    _chaos(monkeypatch, "engine_crash:2:replica0")
    reqs = _run_router(router, [([3 + i, 4, 5], {"max_new_tokens": 6,
                                                 "deadline_ms": 60000})
                                for i in range(8)])
    dead = [e.name for e in engines if e._dead is not None]
    assert dead
    assert all(r.done and r.error is None for r in reqs)
    assert telemetry.registry().counter("serve.replays").value >= 1
    by = _spans(sink)
    seen = set()
    for r in reqs:
        _assert_connected(by[r.id])
        assert _root_of(by[r.id])["attrs"]["ok"] is True
        seen.update(s["phase"] for s in by[r.id])
    assert "replay" in seen
    crash = [d for d in sink.records if d.get("type") == "flight_recorder"
             and d["reason"] == "scheduler_death"]
    assert crash and crash[0]["replica"] in dead
    assert crash[0]["n"] == len(crash[0]["tail"]) > 0
    assert all(e.get("type") in ("span", "event") for e in crash[0]["tail"])
    assert tracing.tracer().open_traces() == []


def test_flight_recorder_dumps_on_handoff_fail(models, wparams,
                                               monkeypatch):
    sink = _sink()
    engines = _fleet(models, wparams, 2)
    router = ReplicaRouter(engines, respawn=False, disagg=True,
                           prefill_replicas=1)
    router.warmup()
    _chaos(monkeypatch, "handoff_fail:1.0")
    reqs = _run_router(router, [([3 + i, 4, 5], {"max_new_tokens": 6})
                                for i in range(4)])
    assert all(r.done and r.error is None for r in reqs)
    dumps = [r for r in sink.records if r.get("type") == "flight_recorder"
             and r["reason"] == "handoff_fail"]
    assert len(dumps) == len(reqs)
    assert all(d["replica"] == "replica0" for d in dumps)


def test_kill_switch_bit_for_bit(models, wparams, monkeypatch):
    """Tracing off: the traced leg's tokens and launch counts, no span or
    recorder record, no tracer, no attribution; a sub-mesh replica and a
    megastep engine trace as any engine."""
    def leg(**kw):
        sink = _sink()
        eng = ServingEngine(models[1], wparams, ctx=kw.pop("ctx", "cpu"),
                            **dict(KW, **kw))
        eng.warmup()
        reqs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
        eng.run_until_idle(timeout=120)
        eng.stop()
        return [r.result(1) for r in reqs], sink.records, dict(eng.stats)

    traced, recs, st = leg()
    mesh, mesh_recs, _ = leg(ctx=submeshes(["cpu"] * 2, 2)[0])
    mega, mega_recs, _ = leg(megastep=True)
    assert mesh == traced == mega
    assert {r["phase"] for r in mesh_recs if r.get("type") == "span"} == \
        {r["phase"] for r in recs if r.get("type") == "span"}
    assert {"megastep", "host_sweep"} <= {
        r["phase"] for r in mega_recs if r.get("type") == "span"}
    for mod in (telemetry, tracing):
        mod.reset()
    monkeypatch.setenv("MXNET_SERVE_TRACING", "0")
    off, off_recs, off_st = leg()
    assert off == traced
    assert {k: v for k, v in off_st.items() if not k.endswith("_s")} == \
        {k: v for k, v in st.items() if not k.endswith("_s")}
    assert not any(r.get("type") in ("span", "flight_recorder")
                   for r in off_recs)
    assert tracing._TRACER is None
    assert not any(k.startswith("serve.attr.")
                   for k in telemetry.registry()._hists)


def test_gateway_send_span_and_trace_report(models, wparams, tmp_path,
                                            monkeypatch):
    """A request through the gateway closes a ``gateway_send`` span under
    its trace; `tools/trace_report.py` renders the port's JSONL stream
    (waterfalls, the attribution table) and writes Chrome trace JSON."""
    import urllib.request
    from mxnet_tpu_torch.serving import ServeGateway
    monkeypatch.setenv("MXNET_SERVE_GATEWAY", "1")
    path = str(tmp_path / "stream.jsonl")
    telemetry.add_sink(telemetry.JsonlSink(path))
    engines = _fleet(models, wparams, 1)
    router = ReplicaRouter(engines, respawn=False)
    router.warmup()
    router.start()
    gw = ServeGateway(router, port=0).start()
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d/v1/generate" % gw.port,
            data=json.dumps({"prompt": [3, 4, 5],
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read().decode()
        assert "[DONE]" in body
        for _ in range(200):
            if any(r.get("phase") == "gateway_send"
                   for r in _read(path)):
                break
            time.sleep(0.02)
    finally:
        gw.stop()
        router.stop()
    recs = _read(path)
    send = [r for r in recs if r.get("phase") == "gateway_send"]
    assert len(send) == 1 and send[0]["replica"] == "gateway"
    by = tracing.spans(recs)
    assert send[0] in by[send[0]["trace"]]
    chrome = str(tmp_path / "trace.json")
    out = subprocess.run(
        [sys.executable, TRACE_REPORT, path, "--chrome", chrome],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "queue_wait" in out.stdout and "decode" in out.stdout
    events = json.load(open(chrome))
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert any(e.get("name") == "gateway_send" for e in events)


def _read(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]
