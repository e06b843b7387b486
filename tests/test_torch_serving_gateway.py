"""The port's HTTP/SSE gateway and autoscaler against the JAX package's,
on the CPU.

The counterparts of `tests/test_serve_gateway.py`, at its size (V, S, L,
H, E = 61, 32, 2, 2, 32, prefill buckets [8, 16]) with the weights of
`tests/test_torch_serving_prefix.py`; served tokens are the JAX engine's
greedy answer where every position's top-1/top-2 margin exceeds 1e-3.

* the switches and the status taxonomy (the JAX package's, class for
  class); a gateway that cannot bind raises;
* an HTTP round trip over a 127.0.0.1 socket on port 0: health, the
  error routes, a JSON body and an SSE stream equal to ``result()``; 429
  on a full queue; HTTP sessions riding the engines' affinity;
* the backpressure matrix: ``client_disconnect`` and a real hang-up
  cancel the request and free its blocks, a slow consumer past the send
  buffer is cancelled typed (SSE 499) while a co-batched request
  finishes, ``conn_flood`` sheds (503) and recovers;
* `AutoScaler.decide` on synthetic streams, the same decisions as the
  JAX autoscaler's, and the shed counter forcing the hot window;
* the fleet: `add_replica` shares the template's parameter storage and
  serves, a scale-down under traffic fails nothing, sessions survive a
  drain and a scale-down, and the loop grows a real fleet.

Every socket has a timeout and every wait a ``timeout=``; no sleep
orders the events.
"""
import http.client
import json
import socket
import threading

import numpy as np
import pytest

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.serving import AutoScaler as JAutoScaler
from mxnet_tpu.serving import http_status as jhttp_status
from mxnet_tpu.serving import errors as jerrors
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (AutoScaler, ReplicaRouter, ServeGateway,
                                     autoscale_enabled, errors,
                                     gateway_enabled, http_status)

from test_torch_serving_prefix import models, wparams  # noqa: F401
from test_torch_serving_router import _engines, _margins_ok, _oracle
from test_torch_kernels import _one_thread  # noqa: F401

WAIT = 120


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXNET_CHAOS", "MXNET_SERVE_GATEWAY",
                "MXNET_SERVE_GATEWAY_PORT", "MXNET_SERVE_GATEWAY_CONN_MAX",
                "MXNET_SERVE_GATEWAY_SEND_BUF", "MXNET_SERVE_AUTOSCALE",
                "MXNET_SERVE_AUTOSCALE_MIN", "MXNET_SERVE_AUTOSCALE_MAX",
                "MXNET_SERVE_HYSTERESIS_S", "MXNET_SERVE_DISAGG"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    for mod in (telemetry, jtelemetry, chaos, jchaos):
        mod.reset()
    yield
    for mod in (telemetry, jtelemetry, chaos, jchaos):
        mod.reset()


def _fleet(models, params, n=2, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_new_tokens", 6)
    router = ReplicaRouter(_engines(models, params, False, n=n, **kw),
                           respawn=False)
    router.warmup()
    return router


def _chaos(monkeypatch, spec):
    monkeypatch.setenv("MXNET_CHAOS", spec)
    chaos.reset()


def _gateway(monkeypatch, router, **kw):
    monkeypatch.setenv("MXNET_SERVE_GATEWAY", "1")
    return ServeGateway(router, **kw).start()


def _on_event(kind):
    """A threading.Event set when telemetry records an event ``kind``."""
    seen = threading.Event()

    def tap(rec):
        if rec.get("kind", rec.get("event")) == kind:
            seen.set()
    telemetry.add_event_tap(tap)
    return seen, tap


# -- HTTP clients -------------------------------------------------------------


def _http(port, method, path, obj=None, timeout=60):
    """One request over http.client: (status, parsed JSON)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if obj is None else json.dumps(obj)
        c.request(method, path, body, {} if body is None
                  else {"Content-Type": "application/json"})
        r = c.getresponse()
        raw = r.read()
        return r.status, (json.loads(raw) if raw else None)
    finally:
        c.close()


def _sse(port, obj, timeout=60, hangup_after=None):
    """POST /v1/generate over a raw socket and read the event stream:
    (status, token frames, [DONE] seen, the SSE error payload or None).
    ``hangup_after=k`` closes the socket after k token frames."""
    body = json.dumps(obj).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.settimeout(timeout)
    try:
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        buf = b""
        frames, done, error, status = [], False, None, None
        while True:
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                line = line.strip()
                if status is None and line.startswith(b"HTTP/1.1"):
                    status = int(line.split()[1])
                elif line == b"data: [DONE]":
                    done = True
                elif line.startswith(b"data: "):
                    payload = json.loads(line[6:])
                    if "token" in payload:
                        frames.append(payload)
                    else:
                        error = payload
                if hangup_after is not None and len(frames) >= hangup_after:
                    s.shutdown(socket.SHUT_RDWR)
                    return status, frames, done, error
            d = s.recv(4096)
            if not d:
                return status, frames, done, error
            buf += d
    finally:
        s.close()


# -- switches and the taxonomy ------------------------------------------------


def test_kill_switches_build_nothing(monkeypatch):
    assert not gateway_enabled() and not autoscale_enabled()
    with pytest.raises(MXNetError, match="MXNET_SERVE_GATEWAY"):
        ServeGateway(None)
    monkeypatch.setenv("MXNET_SERVE_GATEWAY", "1")
    monkeypatch.setenv("MXNET_SERVE_AUTOSCALE", "1")
    assert gateway_enabled() and autoscale_enabled()


def test_http_status_taxonomy_matches_jax():
    for name in ("ServeOverload", "ServeBlocksExhausted",
                 "ServeDeadlineExceeded", "ServeTimeout", "ServeCancelled",
                 "ServeEngineDead", "ServeQuarantined", "ServeError"):
        code = http_status(getattr(errors, name)("x"))
        assert code == jhttp_status(getattr(jerrors, name)("x")), name
    assert http_status(errors.ServeOverload("x")) == 429
    assert http_status(errors.ServeBlocksExhausted("x")) == 413
    assert http_status(errors.ServeTimeout("x")) == 504
    assert http_status(errors.ServeCancelled("x")) == 499
    assert http_status(errors.ServeEngineDead("x")) == 503
    assert http_status(ValueError("x")) == 500


def test_failed_bind_raises(models, wparams, monkeypatch):
    taken = socket.socket()
    taken.settimeout(5)
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    router = _fleet(models, wparams, n=1)
    try:
        monkeypatch.setenv("MXNET_SERVE_GATEWAY", "1")
        gw = ServeGateway(router, port=taken.getsockname()[1])
        with pytest.raises(MXNetError, match="failed to bind"):
            gw.start()
    finally:
        taken.close()
        router.stop()


# -- the HTTP surface ---------------------------------------------------------


def test_http_roundtrip_and_stream_equal_result(models, wparams,
                                                monkeypatch):
    """Health, the error routes, a JSON body and an SSE stream: the
    tokens are the JAX engine's and the stream equals ``result()``."""
    want = _oracle(models, wparams, [3, 4, 5], 6)
    router = _fleet(models, wparams, n=1)
    router.start()
    gw = _gateway(monkeypatch, router)
    try:
        code, health = _http(gw.port, "GET", "/healthz")
        assert code == 200 and health["ok"] and health["replicas"] == 1
        assert _http(gw.port, "GET", "/nope")[0] == 404
        assert _http(gw.port, "GET", "/v1/generate")[0] == 405
        code, err = _http(gw.port, "POST", "/v1/generate", {"prompt": []})
        assert code == 400 and err["error"] == "malformed"
        code, out = _http(gw.port, "POST", "/v1/generate",
                          {"prompt": [3, 4, 5], "stream": False})
        assert code == 200 and out["tokens"] == want
        assert out["ttft_ms"] is not None
        status, frames, done, error = _sse(gw.port, {"prompt": [3, 4, 5]})
        assert status == 200 and done and error is None
        assert [f["token"] for f in frames] == want
        assert [f["index"] for f in frames] == list(range(len(want)))
    finally:
        gw.stop()
        router.stop()
    reg = telemetry.registry()
    assert reg.counter("serve.gateway.accepted").value == 2
    assert reg.counter("serve.gateway.errors").value == 1   # the 400
    assert reg._hist_counts.get("serve.gateway.ttfb_ms", 0) >= 1


def test_overload_answers_429(models, wparams, monkeypatch):
    router = _fleet(models, wparams, n=1, queue_max=1, overload="shed")
    # engines not started: the filler holds the queue, the next sheds
    filler = router.submit([1, 2], max_new_tokens=2)
    gw = _gateway(monkeypatch, router)
    try:
        code, err = _http(gw.port, "POST", "/v1/generate",
                          {"prompt": [3, 4], "stream": False})
        assert code == 429 and err["error"] == "ServeOverload"
    finally:
        gw.stop()
        router.stop()
    assert filler.error is not None


def test_http_session_rides_affinity(models, wparams, monkeypatch):
    router = _fleet(models, wparams, n=2, block_size=4, n_blocks=17,
                    tier=True, host_blocks=16, max_new_tokens=8)
    router.start()
    gw = _gateway(monkeypatch, router)
    try:
        code, out1 = _http(gw.port, "POST", "/v1/generate",
                           {"prompt": [1, 2, 3, 4, 5], "session": "chat",
                            "max_new_tokens": 3, "stream": False})
        assert code == 200
        holders = [e for e in router.engines if e.has_session("chat")]
        assert len(holders) == 1
        code, out2 = _http(gw.port, "POST", "/v1/generate",
                           {"prompt": [6, 7], "session": "chat",
                            "max_new_tokens": 3, "stream": False})
        assert code == 200 and holders[0].stats["session_hits"] == 1
    finally:
        gw.stop()
        router.stop()
    assert out1["tokens"] == _oracle(models, wparams, [1, 2, 3, 4, 5], 3)
    hist = [1, 2, 3, 4, 5] + out1["tokens"] + [6, 7]
    assert out2["tokens"] == _oracle(models, wparams, hist, 3)


# -- backpressure -------------------------------------------------------------


def test_chaos_client_disconnect_frees_blocks(models, wparams, monkeypatch):
    router = _fleet(models, wparams, n=1, max_new_tokens=16)
    router.start()
    gw = _gateway(monkeypatch, router)
    _chaos(monkeypatch, "client_disconnect:1")
    try:
        bystander = router.submit([9, 8, 7], max_new_tokens=16)
        status, frames, done, _ = _sse(gw.port, {"prompt": [3, 4, 5]})
        assert status == 200 and not done and len(frames) >= 1
        assert bystander.result(timeout=WAIT) == \
            _oracle(models, wparams, [9, 8, 7], 16)
        router.run_until_idle(timeout=WAIT)
    finally:
        gw.stop()
        router.stop()
    assert router.engines[0].leaked_blocks() == 0
    assert telemetry.registry().counter(
        "serve.gateway.disconnects").value >= 1
    assert "client_disconnect" in [
        e.get("reason") for e in telemetry.events("serve_gateway_cancel")]


def test_real_socket_hangup_cancels_inflight(models, wparams, monkeypatch):
    """No gateway chaos: a client closing its socket mid-stream is seen
    by the EOF watcher, its request cancels, its blocks go back.
    ``decode_slow`` keeps the generation running past the hang-up."""
    router = _fleet(models, wparams, n=1, max_new_tokens=24)
    router.start()
    gw = _gateway(monkeypatch, router)
    seen, tap = _on_event("serve_gateway_cancel")
    _chaos(monkeypatch, "decode_slow:1:100")
    try:
        status, frames, done, _ = _sse(gw.port, {"prompt": [3, 4, 5]},
                                       hangup_after=1)
        assert status == 200 and not done and len(frames) == 1
        assert seen.wait(timeout=WAIT)
        monkeypatch.delenv("MXNET_CHAOS")
        chaos.reset()
        router.run_until_idle(timeout=WAIT)
    finally:
        telemetry.remove_event_tap(tap)
        gw.stop()
        router.stop()
    assert telemetry.registry().counter(
        "serve.gateway.disconnects").value >= 1
    assert router.engines[0].leaked_blocks() == 0


def test_slow_consumer_cancels_typed_without_stalling(models, wparams,
                                                      monkeypatch):
    router = _fleet(models, wparams, n=1, max_new_tokens=8)
    router.start()
    gw = _gateway(monkeypatch, router, send_buf=48)
    _chaos(monkeypatch, "slow_consumer:1:150")
    try:
        bystander = router.submit([9, 8, 7], max_new_tokens=8)
        status, frames, done, error = _sse(gw.port, {"prompt": [3, 4, 5]})
        assert status == 200 and not done
        assert error is not None and error["status"] == 499
        assert error["error"] == "SlowConsumer"
        assert bystander.result(timeout=WAIT) == \
            _oracle(models, wparams, [9, 8, 7], 8)
        router.run_until_idle(timeout=WAIT)
    finally:
        gw.stop()
        router.stop()
    assert router.engines[0].leaked_blocks() == 0
    assert telemetry.registry().counter(
        "serve.gateway.slow_consumer_cancels").value >= 1


def test_conn_flood_sheds_then_recovers(models, wparams, monkeypatch):
    router = _fleet(models, wparams, n=1)
    gw = _gateway(monkeypatch, router, conn_max=4)
    _chaos(monkeypatch, "conn_flood:8:8")
    try:
        code, err = _http(gw.port, "GET", "/healthz")
        assert code == 503 and err["error"] == "conn_limit"
        assert _http(gw.port, "GET", "/healthz")[0] == 200
    finally:
        gw.stop()
        router.stop()
    assert telemetry.registry().counter(
        "serve.gateway.conn_shed").value == 1


# -- the autoscaler's decisions -----------------------------------------------


def _asc(cls, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("hysteresis_s", 1.0)
    kw.setdefault("up_depth", 4.0)
    kw.setdefault("down_depth", 0.5)
    kw.setdefault("period", 0.25)
    return cls(None, **kw)


def _feed(asc, stream, n):
    """The (now, load) stream through the pure `decide`: the non-zero
    decisions as (now, delta)."""
    pool = asc._pools[0]
    out = []
    for now, load in stream:
        d = asc.decide(pool, n, load, now)
        if d:
            out.append((now, d))
            n += d
    return out


STREAMS = {
    "sustained": ([(0.25 * i, 8.0) for i in range(20)], 1, {}),
    "spike": ([(0.25 * i, 0.0) for i in range(8)] + [(2.0, 8.0)]
              + [(2.25 + 0.25 * i, 0.0) for i in range(8)], 1, {}),
    "flap": ([(0.25 * i, 6.0 if i % 2 == 0 else 0.0) for i in range(40)], 2,
             {}),
    "idle": ([(0.25 * i, 0.0) for i in range(40)], 3, {}),
    "max_clamp": ([(0.25 * i, 8.0) for i in range(40)], 1,
                  {"max_replicas": 2}),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_autoscaler_decisions_match_jax(case):
    stream, n, kw = STREAMS[case]
    got = _feed(_asc(AutoScaler, **kw), stream, n)
    assert got == _feed(_asc(JAutoScaler, **kw), stream, n)
    deltas = [d for _, d in got]
    gaps = [b - a for (a, _), (b, _) in zip(got, got[1:])]
    assert all(g >= 1.0 for g in gaps)          # the cooldown holds
    if case == "sustained":
        assert deltas and set(deltas) == {1} and got[0][0] >= 1.0
    elif case in ("spike", "flap"):
        assert got == []
    elif case == "idle":
        assert deltas == [-1, -1]                # 3 -> 2 -> 1, clamped
    else:
        assert deltas == [1]                     # 1 -> 2, clamped


def test_autoscaler_bad_clamp_raises():
    with pytest.raises(MXNetError, match="below"):
        _asc(AutoScaler, min_replicas=4, max_replicas=2)


class _StubEngine:
    def __init__(self, name):
        self.name = name
        self.role = None
        self.max_batch = 4
        self._dead = None
        self._stopped = threading.Event()
        self._draining = False

    def depth(self):
        return 0

    def decode_depth(self):
        return 0


class _StubRouter:
    def __init__(self):
        self.engines = [_StubEngine("stub0")]
        self.calls = []

    def add_replica(self, role=None):
        self.calls.append(("up", role))
        eng = _StubEngine("stub%d" % len(self.engines))
        self.engines.append(eng)
        return eng

    def remove_replica(self, role=None):
        self.calls.append(("down", role))
        return self.engines.pop().name


def test_shed_delta_forces_the_hot_window():
    """Depth reads 0 but the shed counter rises: the scaler grows, and
    the action lands in ``serve.scale_ups`` and the event stream."""
    router = _StubRouter()
    asc = AutoScaler(router, min_replicas=1, max_replicas=2,
                     hysteresis_s=0.2, up_depth=4.0, down_depth=-1.0,
                     period=0.05)
    asc.step(now=0.0)
    telemetry.inc("serve.shed")
    asc.step(now=0.1)
    telemetry.inc("serve.shed")
    assert asc.step(now=0.35) == [(None, 1)]
    assert router.calls == [("up", None)]
    assert telemetry.registry().counter("serve.scale_ups").value == 1
    assert telemetry.events("serve_scale_up")


# -- the fleet ----------------------------------------------------------------


def test_add_replica_shares_storage_and_serves(models, wparams):
    router = _fleet(models, wparams, n=1)
    router.start()
    try:
        template = router.engines[0]
        fresh = router.add_replica()
        assert fresh.name == "replica1" and len(router.engines) == 2
        assert all(t is template._params[k]
                   and t.data_ptr() == template._params[k].data_ptr()
                   for k, t in fresh._params.items())
        prompts = [[3 + i, 4] for i in range(6)]
        reqs = [router.submit(p) for p in prompts]
        assert [r.result(timeout=WAIT) for r in reqs] == \
            [_oracle(models, wparams, p, 6) for p in prompts]
        assert fresh.stats["completed"] > 0
        gone = router.remove_replica()
        assert gone in ("replica0", "replica1") and len(router.engines) == 1
        assert router.submit([5, 6]).result(timeout=WAIT)
        with pytest.raises(MXNetError, match="last"):
            router.remove_replica()
    finally:
        router.stop()


def test_scale_down_under_traffic_zero_failed(models, wparams):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 61, size=int(n)).tolist()
               for n in rng.randint(2, 8, size=12)]
    router = _fleet(models, wparams, n=3, max_batch=2)
    router.start()
    try:
        reqs = [router.submit(p) for p in prompts[:6]]
        gone = router.remove_replica(deadline_ms=1)   # strands stragglers
        reqs += [router.submit(p) for p in prompts[6:]]
        outs = [r.result(timeout=WAIT) for r in reqs]
    finally:
        router.stop()
    assert outs == [_oracle(models, wparams, p, 6) for p in prompts]
    _margins_ok(models, wparams, reqs)
    assert len(router.engines) == 2
    assert gone not in [e.name for e in router.engines]
    assert all(e.leaked_blocks() == 0 for e in router.engines)


@pytest.mark.parametrize("how", ["drain", "remove"])
def test_session_survives_holder_leaving(models, wparams, how):
    """Draining the holder (a replacement takes its place) or removing it
    moves the session: the follow-up finds its history."""
    router = _fleet(models, wparams, n=2, block_size=4, n_blocks=17,
                    tier=True, host_blocks=16, max_new_tokens=8)
    router.start()
    try:
        out1 = router.submit([1, 2, 3, 4, 5], max_new_tokens=3,
                             session="conv").result(timeout=WAIT)
        holder = [e for e in router.engines if e.has_session("conv")][0]
        if how == "drain":
            assert router.drain(holder) is not None
        else:
            router.remove_replica(holder)
            assert len(router.engines) == 1
        holders = [e for e in router.engines if e.has_session("conv")]
        assert len(holders) == 1 and holders[0] is not holder
        out2 = router.submit([6, 7], max_new_tokens=3,
                             session="conv").result(timeout=WAIT)
        assert holders[0].stats["session_hits"] == 1
    finally:
        router.stop()
    hist = [1, 2, 3, 4, 5] + out1 + [6, 7]
    assert out2 == _oracle(models, wparams, hist, 3)
    assert telemetry.registry().counter("serve.sessions_migrated").value >= 1


def test_autoscaler_loop_grows_a_real_fleet(models, wparams, monkeypatch):
    """The wired loop: queue pressure (held up by ``decode_slow``) grows
    the fleet by one replica sharing the template's parameters."""
    _chaos(monkeypatch, "decode_slow:1:50")
    router = _fleet(models, wparams, n=1)
    router.start()
    grew, tap = _on_event("serve_scale_up")
    asc = AutoScaler(router, min_replicas=1, max_replicas=2,
                     hysteresis_s=0.1, up_depth=0.5, down_depth=-1.0,
                     period=0.02)
    asc.start()
    try:
        reqs = [router.submit([3 + i, 4], max_new_tokens=6)
                for i in range(8)]
        assert grew.wait(timeout=WAIT)
        outs = [r.result(timeout=WAIT) for r in reqs]
    finally:
        telemetry.remove_event_tap(tap)
        asc.stop()
        router.stop()
    assert len(router.engines) == 2 and all(outs)
    assert router.engines[1]._params["embed_weight"] is \
        router.engines[0]._params["embed_weight"]
    assert telemetry.registry().counter("serve.scale_ups").value >= 1
