"""The port's telemetry, chaos spec, storage and resource modules against
the JAX package's, on the CPU.

Each case makes the same calls on both modules and compares what comes
back: the registry (counters, gauges, histograms, events, the step
record with its deltas), the sinks (`MemorySink`, and `JsonlSink`'s
size-capped rotation in a temporary directory), `health()` and
`consume_nonfinite()` over staged moments (device arrays in the JAX
package, tensors in the port), ``MXNET_TELEMETRY_HEALTH`` moments of a
fused update, the retrace watch's diagnoses (direct calls, and an
executor rebound at a new batch size), the counters of one short
`Module.fit` over two devices through the local KVStore, name for name
(the JAX package's ``dispatch.*`` counters come from its profiler, which
the port does not have); an ``MXNET_CHAOS`` spec with a clause the port
cannot inject raises `MXNetError`; `storage` (the pool's reuse of a
freed buffer, its cap, its stats, the CPU's empty memory counters, the
``storage`` collector) and `resource` (keys of `random`, the grow-only
scratch space).  Values are compared exactly, moments within 1e-6
relative (float32 sums in another order).
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PK = {"jax": jmx, "torch": tmx}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for v in ("MXNET_CHAOS", "MXNET_NONFINITE_GUARD", "MXNET_TELEMETRY",
              "MXNET_TELEMETRY_HEALTH", "MXNET_TELEMETRY_JSONL"):
        monkeypatch.delenv(v, raising=False)
    for mx in PK.values():
        mx.telemetry.reset()
        mx.chaos.reset()
    yield
    for mx in PK.values():
        mx.telemetry.reset()
        mx.chaos.reset()


def _strip(rec):
    """A step record without its clock readings."""
    rec = dict(rec)
    for k in ("time", "wall_ms"):
        rec.pop(k, None)
    rec["events"] = [{k: v for k, v in e.items() if k != "time"}
                     for e in rec["events"]]
    return rec


def _drive(mx):
    t = mx.telemetry
    sink = t.add_sink(t.MemorySink())
    t.inc("a")
    t.inc("a", 4)
    t.set_gauge("g", 2.5)
    for v in (3.0, 1.0, 2.0):
        t.observe("h", v)
    t.record_event("ev", x=1)
    first = t.step_report(extra={"epoch": 0})
    t.inc("b")
    t.registry().counter("c").inc(2)
    t.registry().gauge("g").set(7)
    t.registry().histogram("h").observe(9)
    second = t.step_end(extra={"epoch": 1})
    return ([_strip(r) for r in sink.records], _strip(first),
            _strip(second), t.events("ev"), t.registry().counter("a").value)


def test_registry_and_step_records_match_jax():
    jout, tout = _drive(jmx), _drive(tmx)
    for j, t in zip(jout[:3], tout[:3]):
        assert t == j
    assert [e["x"] for e in tout[3]] == [e["x"] for e in jout[3]] == [1]
    assert tout[4] == jout[4] == 5
    rec = tout[1]
    assert rec["hists"]["h"] == {"count": 3, "mean": 2.0, "p50": 2.0,
                                 "p99": 3.0, "max": 3.0}
    assert rec["counters"]["events.ev"] == 1 and "storage" in rec
    assert tout[2]["deltas"] == {"b": 1, "c": 2}


def test_jsonl_rotation_matches_jax(tmp_path):
    written = {}
    for which, mx in PK.items():
        path = tmp_path / which / "t.jsonl"
        sink = mx.telemetry.JsonlSink(str(path), max_mb=200 / 2 ** 20,
                                      keep=2)
        for i in range(12):
            sink.emit({"i": i, "pad": "x" * 40})
        sink.close()
        written[which] = {p.name: [json.loads(line)["i"] for line in
                                   p.read_text().splitlines()]
                          for p in sorted(path.parent.iterdir())}
    assert written["torch"] == written["jax"]
    assert {"t.jsonl.1", "t.jsonl.2"} <= set(written["torch"])
    assert "t.jsonl.3" not in written["torch"]


def test_health_and_consume_nonfinite_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    names = ("grad_sq", "update_sq", "param_sq", "nonfinite")
    vals = [np.array([4.0, 0.25, 16.0, 0.0], np.float32),
            np.array([5.0, 0.0, 9.0, 2.0], np.float32)]
    got = {}
    for which, mx in PK.items():
        for v in vals:
            mx.telemetry.stage_health(
                names, jnp.asarray(v) if which == "jax"
                else torch.from_numpy(v))
        first = mx.telemetry.health()
        again = mx.telemetry.health()  # memoized: no second fetch
        n = mx.telemetry.consume_nonfinite()
        got[which] = (first, again, n, mx.telemetry.consume_nonfinite(),
                      {k: v for k, v in
                       mx.telemetry.registry()._counters.items()},
                      [(e["count"], e["skipped"]) for e in
                       mx.telemetry.events("nonfinite_grads")])
    assert got["torch"] == got["jax"]
    h = got["torch"][0]
    assert h["grad_norm"] == 3.0 and h["nonfinite"] == 2
    assert got["torch"][2:4] == (1, 0)


def test_health_moments_of_a_fused_update_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_HEALTH", "1")
    rng = np.random.RandomState(0)
    ws = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    gs = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    gs[1][2] = np.inf
    got = {}
    for which, mx in PK.items():
        upd = mx.optimizer.get_fused_updater(
            mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        w = [mx.nd.array(a, ctx=mx.cpu()) for a in ws]
        upd([0, 1], [mx.nd.array(a, ctx=mx.cpu()) for a in gs], w)
        got[which] = mx.telemetry.health()
        assert np.isinf(w[1].asnumpy()).any()  # health alone skips nothing
    for k, v in got["jax"].items():
        if np.isfinite(v):
            np.testing.assert_allclose(got["torch"][k], v, rtol=1e-6)
        else:
            assert not np.isfinite(got["torch"][k])
    assert got["torch"]["nonfinite"] == 1


def test_retrace_diagnoses_match_jax():
    got = {}
    for which, mx in PK.items():
        t = mx.telemetry
        mk = (lambda s, d: jnp.zeros(s, d)) if which == "jax" else \
            (lambda s, d: torch.zeros(s, dtype=getattr(torch, d)))
        a = t.arrays_signature([mk((2, 3), "float32"), mk((4,), "int32")],
                               ["x", "y"])
        b = t.arrays_signature([mk((5, 3), "float32"), mk((4,), "float32")],
                               ["x", "y"])
        c = t.arrays_signature([mk((5, 3), "float32")], ["x"])
        out = [t.watch_jit("site", a, scope=1),
               t.watch_jit("site", a, scope=1),
               t.watch_jit("site", b, scope=1, meta={"donate": True}),
               t.watch_jit("site", c, scope=1, seed=True),
               t.watch_jit("site", c, scope=1),
               t.watch_jit("site", a, scope=2)]
        got[which] = (a, [None if e is None else
                          (e["diagnosis"], e["n_signatures"]) for e in out])
    assert got["torch"] == got["jax"]
    assert got["torch"][1][2] == (
        "x: shape (2, 3) -> (5, 3); y: dtype int32 -> float32; "
        "donate: new (True)", 2)


def _mlp(mx):
    h = mx.sym.FullyConnected(data=mx.sym.Variable("data"), name="fc1",
                              num_hidden=8)
    h = mx.sym.Activation(data=h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=3)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def test_executor_rebind_fires_one_retrace_as_in_jax():
    got = {}
    for which, mx in PK.items():
        net = _mlp(mx)
        for batch in (8, 8, 4):
            ex = net.simple_bind(mx.cpu(), data=(batch, 5))
            ex.arg_dict["data"][:] = np.ones((batch, 5), np.float32)
            ex.forward(is_train=True)
            ex.backward()
        got[which] = [(e["site"], e["diagnosis"]) for e in
                      mx.telemetry.events("retrace")]
    assert got["torch"] == got["jax"]
    assert [s for s, _ in got["torch"]] == ["executor.train_step"]


def test_module_fit_counters_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_METRIC_INTERVAL", "2")
    counters, gauges = {}, {}
    for which, mx in PK.items():
        mx.random.seed(0)
        rng = np.random.RandomState(0)
        X = rng.randn(48, 5).astype(np.float32)
        y = rng.randint(0, 3, 48).astype(np.float32)
        mod = mx.mod.Module(_mlp(mx), context=[mx.cpu(0), mx.cpu(1)])
        mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=2,
                kvstore="local", optimizer_params={"learning_rate": 0.1})
        reg = mx.telemetry.registry()
        counters[which] = {k: v for k, v in reg._counters.items()
                           if not k.startswith("dispatch.")}
        gauges[which] = sorted(reg._gauges)
        if which == "torch":
            assert mod.stats == {k: counters[which].get(k, 0)
                                 for k in tmx.model.STATS}
    assert counters["torch"] == counters["jax"]
    assert gauges["torch"] == gauges["jax"]
    assert counters["torch"]["kvstore.push_calls"] == 12
    assert counters["torch"]["train.host_blocking_fetches"] == 6


@pytest.mark.parametrize("clause", ["rpc_drop:0.1", "server_crash:3",
                                    "rpc_delay:0.2:30",
                                    "rpc_drop:0.5",
                                    "server_crash:2:1"])
def test_unported_chaos_clauses_raise(monkeypatch, clause):
    monkeypatch.setenv("MXNET_CHAOS", "nan_grad:2," + clause)
    assert jmx.chaos.spec() is not None  # the JAX package takes it
    with pytest.raises(MXNetError, match=clause.split(":")[0]):
        tmx.chaos.spec()
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    with pytest.raises(MXNetError, match="MXNET_CHAOS"):
        mod.fit(tmx.io.NDArrayIter(np.zeros((8, 5), np.float32),
                                   np.zeros(8, np.float32), batch_size=4),
                num_epoch=1)
    # mxlint: disable=chaos-unknown-clause -- deliberately unknown clause: the port's parse rejects it as the JAX one does
    monkeypatch.setenv("MXNET_CHAOS", "bogus:1")
    with pytest.raises(ValueError, match="unknown MXNET_CHAOS clause"):
        tmx.chaos.spec()


def test_storage_pool_matches_jax(monkeypatch):
    monkeypatch.setenv("MXNET_STORAGE_POOL_CAP_BYTES", "100")
    got = {}
    for which, mx in PK.items():
        mx.storage.Storage._instance = None
        st = mx.storage.Storage.get()
        h = st.alloc(64, mx.cpu())
        ptr = h.data.data_ptr() if which == "torch" else None
        st.free(h)
        with pytest.raises(Exception, match="double free"):
            st.free(h)
        h2 = st.alloc(64, mx.cpu())
        if which == "torch":
            assert h2.data.data_ptr() == ptr  # the freed buffer, reused
        stats = [st.pool_stats()]
        st.free(h2)
        big = st.alloc(80, mx.cpu())
        st.free(big)  # 64 + 80 cached > cap 100: the pool drops all
        stats.append(st.pool_stats())
        assert h2.asnumpy().shape == (64,)
        got[which] = (stats, mx.storage.device_memory_stats(mx.cpu()),
                      sorted(mx.telemetry.step_report()["storage"]))
        mx.storage.Storage._instance = None
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == {} and got["torch"][2] == ["pool"]


def test_resource_matches_jax():
    got = {}
    for which, mx in PK.items():
        mx.random.seed(11)
        rm = mx.resource.ResourceManager.get()
        rnd = rm.request(mx.cpu(), mx.resource.ResourceRequest.kRandom)
        keys = [tuple(int(w) for w in np.asarray(rnd.get_key()))
                for _ in range(2)]
        tmp = rm.request(mx.cpu(), "temp_space")
        a = tmp.get_space((4, 4))
        a[:] = 3
        b = tmp.get_space((2, 3), np.int32)
        got[which] = (keys, b.tolist(), tmp._buf.nbytes)
        with pytest.raises(Exception, match="unknown resource"):
            rm.request(mx.cpu(), "bogus")
    assert got["torch"] == got["jax"]
