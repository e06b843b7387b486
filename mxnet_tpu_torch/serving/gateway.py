"""HTTP/SSE front door for the serving fleet (``MXNET_SERVE_GATEWAY``).

A port of `mxnet_tpu/serving/gateway.py`, on stdlib asyncio alone: one
event-loop thread serves a `ReplicaRouter` (or a bare `ServingEngine`).
``POST /v1/generate`` streams the tokens as server-sent events through
the engine's ``on_token`` callback, which the scheduler's thread hands to
the loop with ``call_soon_threadsafe``; a ``"session"`` in the body maps
onto ``submit(session=...)`` and its affinity.

Overload anywhere between the socket and the block allocator resolves
typed, never as an unbounded buffer or a stuck scheduler:

* a bounded connection count (``MXNET_SERVE_GATEWAY_CONN_MAX``): the
  connection past the cap gets an immediate 503;
* admission failures map the error taxonomy onto status codes
  (`ServeOverload` 429, `ServeBlocksExhausted` 413, `ServeEngineDead`
  503, `ServeDeadlineExceeded` / `ServeTimeout` 504, malformed 400);
* a per-connection send buffer bounded by
  ``MXNET_SERVE_GATEWAY_SEND_BUF`` bytes: past it the request of a
  consumer that stopped reading is cancelled (its blocks go back at the
  engine's next sweep) and its socket closed; co-batched rows never
  notice;
* a reader task watches the socket for EOF and cancels the request of a
  client that went away.

A gateway that cannot bind raises from `start`.  ``MXNET_SERVE_GATEWAY=0``
(the default) builds nothing: constructing a `ServeGateway` raises.  The
chaos clauses ``client_disconnect:P``, ``slow_consumer:P:MS`` and
``conn_flood:RATE[:TOTAL]`` inject the gateway's three faults.
"""
from __future__ import annotations

import asyncio
import functools
import json
import os
import threading
import time

from .. import chaos, telemetry, tracing
from ..base import MXNetError
from .errors import (ServeBlocksExhausted, ServeCancelled,
                     ServeDeadlineExceeded, ServeEngineDead, ServeError,
                     ServeOverload, ServeQuarantined, ServeTimeout)

__all__ = ["gateway_enabled", "ServeGateway", "http_status"]

# the status-code taxonomy; order matters: subclasses before ServeError's
# 500 fallback
_STATUS = (
    (ServeOverload, 429),          # queue full / all replicas shed
    (ServeBlocksExhausted, 413),   # prompt cannot fit the block pool
    (ServeDeadlineExceeded, 504),  # SLO deadline expired server-side
    (ServeTimeout, 504),           # gateway-side wait expired
    (ServeCancelled, 499),         # client went away / consumer too slow
    (ServeEngineDead, 503),        # no live replica
    (ServeQuarantined, 500),       # poisoned request
    (ServeError, 500),
)

_REASONS = {400: "Bad Request", 404: "Not Found", 405: "Method Not "
            "Allowed", 413: "Payload Too Large", 429: "Too Many Requests",
            499: "Client Closed Request", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout",
            200: "OK"}


def gateway_enabled():
    """The ``MXNET_SERVE_GATEWAY`` switch (default off: the serving stack
    is a library only)."""
    return os.environ.get("MXNET_SERVE_GATEWAY", "0").lower() not in (
        "0", "false", "no", "")


def http_status(err):
    """Map a typed serve error (or anything else) to its HTTP status."""
    for cls, code in _STATUS:
        if isinstance(err, cls):
            return code
    return 500


class _Conn:
    """Per-connection streaming state: the bounded send buffer between
    the scheduler thread's `on_token` callback and the event loop's
    writer.  Tokens cross threads via `call_soon_threadsafe`; the BYTE
    budget (not a frame count) is what the watermark bounds, so one
    slow consumer can hold at most `send_buf` bytes of this process."""

    def __init__(self, loop, send_buf):
        self.loop = loop
        self.send_buf = send_buf
        self.pending = []          # frames (bytes) not yet written
        self.buffered = 0          # bytes currently in `pending`
        self.event = asyncio.Event()
        self.overflow = False      # watermark tripped: consumer too slow
        self.req = None

    def push_from_scheduler(self, frame):
        """Runs on the event loop (posted via call_soon_threadsafe)."""
        self.buffered += len(frame)
        self.pending.append(frame)
        if self.buffered > self.send_buf and not self.overflow:
            # the one place a slow consumer is allowed to cost anything:
            # its own request cancels typed, its blocks release at the
            # engine's next sweep, and the buffer never grows past the
            # watermark plus one frame
            self.overflow = True
            if self.req is not None:
                self.req.cancel()
        self.event.set()


class ServeGateway:
    """stdlib-asyncio HTTP/SSE server over a `ReplicaRouter` (or a bare
    `ServingEngine`).  `start()` binds and spawns the event-loop thread;
    `stop()` drains it.  Routes:

    * ``POST /v1/generate`` — body ``{"prompt": [ids...],
      "max_new_tokens": n, "stream": true|false, "session": key,
      "temperature"/"top_k"/"top_p"/"seed", "deadline_ms"}``.
      ``stream=true`` (default) answers ``text/event-stream`` with one
      ``data: {"token": t, "index": i}`` frame per generated token and
      a final ``data: [DONE]``; ``stream=false`` answers one JSON body.
    * ``GET /healthz`` — 200 with fleet depth/replica gauges.
    """

    def __init__(self, router, host="127.0.0.1", port=None, conn_max=None,
                 send_buf=None):
        if not gateway_enabled():
            raise MXNetError(
                "ServeGateway: MXNET_SERVE_GATEWAY is off — the gateway "
                "builds nothing by default (set MXNET_SERVE_GATEWAY=1)")
        self.router = router
        self.host = host
        self.port = int(os.environ.get("MXNET_SERVE_GATEWAY_PORT", "0")
                        if port is None else port)
        self.conn_max = int(os.environ.get(
            "MXNET_SERVE_GATEWAY_CONN_MAX", "64")
            if conn_max is None else conn_max)
        self.send_buf = int(os.environ.get(
            "MXNET_SERVE_GATEWAY_SEND_BUF", "65536")
            if send_buf is None else send_buf)
        self._loop = None
        self._server = None
        self._thread = None
        self._ready = threading.Event()
        self._boot_err = None
        self._open = 0             # loop-thread-only: open connections
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Bind and serve on a dedicated event-loop thread.  Returns self;
        `self.port` holds the bound port (ephemeral when constructed with
        port 0)."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run,
                                        name="serve-gateway", daemon=True)
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._boot_err is not None:
            err = self._boot_err
            self._thread = None
            raise MXNetError("ServeGateway: failed to bind %s:%d: %s"
                             % (self.host, self.port, err))
        if not self._ready.is_set():
            raise MXNetError("ServeGateway: event loop failed to start")
        return self

    def _run(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(asyncio.start_server(
                self._handle_conn, self.host, self.port))
            self.port = self._server.sockets[0].getsockname()[1]
        except OSError as e:
            self._boot_err = e
            self._ready.set()
            loop.close()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            self._server.close()
            loop.run_until_complete(self._server.wait_closed())
            # cancel stragglers so close() never hangs on an open stream
            for task in asyncio.all_tasks(loop):
                task.cancel()
            loop.run_until_complete(
                loop.shutdown_asyncgens())
            loop.close()

    def stop(self):
        if self._thread is None:
            return
        self._stopping = True
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(loop.stop)
        self._thread.join(timeout=10)
        self._thread = None
        self._loop = None

    # -- connection handling ----------------------------------------------
    async def _handle_conn(self, reader, writer):
        telemetry.inc("serve.gateway.requests")
        # chaos conn_flood: synthetic attempts burn the same bounded
        # budget real sockets do, so the cap sheds deterministically
        flood = chaos.serve_conn_flood()
        if flood:
            self._open += flood
        if self._open >= self.conn_max or self._stopping:
            if flood:
                self._open -= flood
            telemetry.inc("serve.gateway.conn_shed")
            await self._respond_error(
                writer, 503, "conn_limit",
                "gateway at MXNET_SERVE_GATEWAY_CONN_MAX=%d connections"
                % self.conn_max)
            # close the shed connection too: an open one would hold the
            # server's wait_closed at stop
            writer.close()
            return
        self._open += 1
        telemetry.set_gauge("serve.gateway.open_conns", self._open)
        try:
            await self._handle_request(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # peer vanished mid-response: nothing left to tell it
        finally:
            self._open -= 1
            if flood:
                self._open -= flood
            telemetry.set_gauge("serve.gateway.open_conns", self._open)
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_request(self, reader, writer):
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=30)
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                raise ValueError("bad request line %r" % line[:80])
            method, path = parts[0], parts[1]
            clen = 0
            while True:
                h = await asyncio.wait_for(reader.readline(), timeout=30)
                if h in (b"\r\n", b"\n", b""):
                    break
                name, _, val = h.decode("latin-1").partition(":")
                if name.strip().lower() == "content-length":
                    clen = int(val.strip())
            body = await reader.readexactly(clen) if clen else b""
        except (ValueError, asyncio.TimeoutError,
                UnicodeDecodeError) as e:
            telemetry.inc("serve.gateway.errors")
            await self._respond_error(writer, 400, "malformed", str(e))
            return
        if path == "/healthz":
            await self._respond_json(writer, 200, self._health())
            return
        if path != "/v1/generate":
            await self._respond_error(writer, 404, "not_found", path)
            return
        if method != "POST":
            await self._respond_error(writer, 405, "method_not_allowed",
                                      method)
            return
        try:
            spec = json.loads(body.decode("utf-8")) if body else {}
            prompt = [int(t) for t in spec["prompt"]]
            if not prompt:
                raise ValueError("empty prompt")
        except (ValueError, KeyError, TypeError) as e:
            telemetry.inc("serve.gateway.errors")
            await self._respond_error(writer, 400, "malformed",
                                      "bad body: %s" % e)
            return
        await self._generate(reader, writer, spec, prompt)

    def _health(self):
        r = self.router
        depth = r.depth() if hasattr(r, "depth") else 0
        n = len(getattr(r, "engines", ())) or 1
        return {"ok": True, "replicas": n, "depth": depth,
                "open_conns": self._open}

    # -- generate ----------------------------------------------------------
    async def _generate(self, reader, writer, spec, prompt):
        loop = asyncio.get_event_loop()
        conn = _Conn(loop, self.send_buf)
        stream = bool(spec.get("stream", True))

        def on_token(tok, _c=conn, _n=[0]):
            # scheduler thread: format here (cheap), buffer on the loop
            i = _n[0]
            _n[0] += 1
            frame = b"data: " + json.dumps(
                {"token": int(tok), "index": i}).encode() + b"\n\n"
            _c.loop.call_soon_threadsafe(_c.push_from_scheduler, frame)

        kw = {}
        for k in ("max_new_tokens", "deadline_ms", "temperature", "top_k",
                  "top_p", "seed", "session", "eos_id"):
            if spec.get(k) is not None:
                kw[k] = spec[k]
        t0 = time.perf_counter()
        try:
            req = self.router.submit(prompt, on_token=on_token if stream
                                     else None, **kw)
        except MXNetError as e:
            code = http_status(e)
            telemetry.inc("serve.gateway.errors")
            await self._respond_error(writer, code,
                                      type(e).__name__, str(e))
            return
        conn.req = req
        telemetry.inc("serve.gateway.accepted")
        if not stream:
            await self._collect(writer, req, spec, t0)
            return
        await self._stream(reader, writer, conn, req, t0)

    async def _collect(self, writer, req, spec, t0):
        """Non-streaming: one JSON body once the request resolves.  The
        blocking `result()` wait runs on the default executor — the
        event loop (and every other connection) stays live."""
        timeout = float(spec.get("timeout", 300))
        try:
            tokens = await asyncio.get_event_loop().run_in_executor(
                None, functools.partial(req.result, timeout))
        except MXNetError as e:
            telemetry.inc("serve.gateway.errors")
            await self._respond_error(writer, http_status(e),
                                      type(e).__name__, str(e))
            return
        await self._respond_json(writer, 200, {
            "tokens": tokens, "ttft_ms": req.ttft_ms,
            "latency_ms": req.latency_ms, "id": req.id})

    async def _stream(self, reader, writer, conn, req, t0):
        """SSE pump: drain the bounded buffer to the socket, watch the
        socket for client EOF, poll request completion.  Every exit path
        funnels through one typed resolution."""
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        watcher = asyncio.ensure_future(self._watch_disconnect(
            reader, req))
        slow_ms = chaos.serve_slow_consumer()
        drop_stream = chaos.serve_client_disconnect()
        t_first = None
        wrote = 0
        try:
            while True:
                if conn.overflow:
                    # watermark tripped on the scheduler side; the
                    # request is already cancelled — surface it typed
                    telemetry.inc("serve.gateway.slow_consumer_cancels")
                    telemetry.record_event(
                        "serve_gateway_cancel", request=req.id,
                        reason="slow_consumer", buffered=conn.buffered)
                    await self._sse_error(
                        writer, 499, "SlowConsumer",
                        "send buffer exceeded %d bytes" % conn.send_buf)
                    return
                while conn.pending and not conn.overflow:
                    frame = conn.pending.pop(0)
                    conn.buffered -= len(frame)
                    if slow_ms:
                        # chaos slow_consumer: the CONSUMER stalls — the
                        # pump sleeping here lets the scheduler-side
                        # buffer fill exactly like a congested socket
                        await asyncio.sleep(slow_ms / 1e3)
                    if t_first is None:
                        t_first = time.perf_counter()
                    writer.write(frame)
                    wrote += 1
                    if drop_stream and wrote >= 1:
                        # chaos client_disconnect: hang up mid-stream;
                        # the EOF watcher (or this cancel) must free the
                        # engine-side work
                        telemetry.inc("serve.gateway.disconnects")
                        telemetry.record_event(
                            "serve_gateway_cancel", request=req.id,
                            reason="client_disconnect")
                        req.cancel()
                        return
                await writer.drain()
                if req.done:
                    # _finish publishes (queuing the last frames via
                    # call_soon_threadsafe) BEFORE it flips done, so one
                    # yield to the loop makes every queued frame visible
                    await asyncio.sleep(0)
                    if conn.pending:
                        continue
                    break
                try:
                    await asyncio.wait_for(conn.event.wait(), timeout=0.02)
                except asyncio.TimeoutError:
                    pass  # poll req.done: _finish has no loop-side hook
                conn.event.clear()
            if req.error is not None:
                telemetry.inc("serve.gateway.errors")
                await self._sse_error(writer, http_status(req.error),
                                      type(req.error).__name__,
                                      str(req.error))
                return
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
            t1 = time.perf_counter()
            ttfb = None if t_first is None else 1e3 * (t_first - t0)
            if ttfb is not None:
                telemetry.observe("serve.gateway.ttfb_ms", ttfb)
            tracing.add_span(req.id, "gateway_send", "gateway", t0, t1,
                             ttfb_ms=ttfb, n_tokens=len(req.tokens))
        finally:
            watcher.cancel()
            if not req.done:
                req.cancel()

    async def _watch_disconnect(self, reader, req):
        """EOF on the request socket = the client went away: cancel the
        in-flight request so abandoned work stops burning decode slots
        (its blocks release through the ordinary cancelled-sweep)."""
        try:
            data = await reader.read(1)
            if data == b"" and not req.done:
                telemetry.inc("serve.gateway.disconnects")
                telemetry.record_event("serve_gateway_cancel",
                                       request=req.id,
                                       reason="client_disconnect")
                req.cancel()
        except (asyncio.CancelledError, ConnectionError):
            pass

    # -- response plumbing -------------------------------------------------
    async def _respond_json(self, writer, code, obj):
        body = json.dumps(obj).encode()
        writer.write(b"HTTP/1.1 %d %s\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n"
                     b"Connection: close\r\n\r\n"
                     % (code, _REASONS.get(code, "?").encode(), len(body)))
        writer.write(body)
        await writer.drain()

    async def _respond_error(self, writer, code, kind, msg):
        try:
            await self._respond_json(writer, code, {
                "error": kind, "status": code, "message": msg[:500]})
        except (ConnectionError, RuntimeError):
            pass  # peer already gone

    async def _sse_error(self, writer, code, kind, msg):
        """Typed failure after the 200 header went out: the status rides
        an SSE error event (the HTTP status is already committed)."""
        try:
            writer.write(b"event: error\ndata: " + json.dumps(
                {"error": kind, "status": code,
                 "message": msg[:500]}).encode() + b"\n\n")
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass
