"""Request tracing: per-request span timelines across the fleet.

The port's own copy of `mxnet_tpu/tracing.py` (stdlib plus the port's
telemetry): the same span model, phase taxonomy, flight recorder and
record schema, so `tools/trace_report.py` renders either package's
stream.  Host-side ``perf_counter`` stamps only, records on the existing
telemetry JSONL sinks: tracing adds no CUDA launch, no event and no host
sync.

Span model:

* **trace id** = the request id (`ServeRequest.id`).  Handoff,
  preemption replay and journal migration all reuse the request object,
  so one trace id survives every road a request can take; the
  `HandoffTicket` also carries ``(trace, parent)`` across the prefill to
  decode role boundary (`adopt`).
* **root span**: one ``request`` span per trace, opened at submit (t0 =
  ``t_submit``), closed at `ServeRequest._finish` with status and latency
  attrs.
* **interval phases**: at any moment a request is in exactly one of
  ``queue_wait / prefill / replay / restore_wait / handoff_wait /
  decode``.  `phase()` closes the current interval span and opens the
  next, so the timeline tiles the submit-to-done window: the SLO
  attribution (``serve.attr.*``) is the per-phase totals.
* **leaf spans**: one-shot child spans under the current interval
  (``prefill_chunk``, ``handoff_pack``, ``handoff_land``,
  ``gateway_send``) and replica-scoped spans with trace id 0
  (``megastep``, ``host_sweep``, ``spec_round``) from the scheduler's
  launch and fetch stamps.

Flight recorder: every replica keeps a bounded ring of its last span
closes and events (``MXNET_TRACE_RING``, 256); `dump()` snapshots it into
one atomic ``flight_recorder`` record on typed failures, chaos trips and
scheduler death.

``MXNET_SERVE_TRACING=0`` turns every call site into a no-op: the same
tokens, no records, no rings, no tracer built.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import telemetry

__all__ = [
    "PHASES", "ATTR_PHASES", "enabled", "tracer", "reset",
    "open_trace", "phase", "add_span", "finish", "on_finish",
    "context", "adopt", "note", "dump", "snapshot", "spans",
]

# The phase taxonomy, the JAX package's: tools/trace_report.py renders
# exactly these (tests/test_torch_tracing.py holds the port's call sites
# to it).
PHASES = (
    "request",        # root span, one per trace
    "queue_wait",     # enqueued (incl. every requeue: preempt, rebuild)
    "prefill",        # chunked prefill of a fresh prompt
    "replay",         # re-prefill of replayed context (preempt/migration)
    "restore_wait",   # host-tier restore staged -> landed
    "handoff_wait",   # disagg pack -> transfer -> landed on decode role
    "decode",         # in the active decode set
    "prefill_chunk",  # leaf: one chunk launch
    "handoff_pack",   # leaf: device->host pack of the block run
    "handoff_land",   # leaf: the warmup-compiled landing scatter
    "megastep",       # replica: one m-step launch->fetch window
    "host_sweep",     # replica: the overlap-window host work
    "spec_round",     # replica: one draft->verify->accept round
    "gateway_send",   # leaf: gateway submit -> last SSE byte flushed
)

# Interval phases folded into the serve.attr.* SLO attribution at retire.
ATTR_PHASES = ("queue_wait", "prefill", "replay", "restore_wait",
               "handoff_wait", "decode")

_MAX_TRACES = 8192   # open-trace bookkeeping cap (leak backstop)


def enabled():
    """Master switch: MXNET_SERVE_TRACING=0 no-ops every call site."""
    return os.environ.get("MXNET_SERVE_TRACING", "1").lower() not in (
        "0", "false", "no")


class Tracer:
    """Process-wide span store: per-trace interval state + per-replica
    flight-recorder rings.  All shared state is guarded by one lock; the
    records built under it are emitted to the telemetry sinks OUTSIDE it
    (a slow sink must not serialize scheduler threads)."""

    def __init__(self, ring=None):
        self._lock = threading.Lock()
        self._next = 0         # span-id mint
        self._roots = {}       # trace -> root sid
        self._meta = {}        # trace -> (t0, replica) of the root span
        self._open = {}        # trace -> [sid, phase, t0, replica, attrs]
        self._acc = {}         # trace -> {phase: total seconds}
        self._rings = {}       # replica -> deque of span/event dicts
        cap = int(os.environ.get("MXNET_TRACE_RING", "256")
                  if ring is None else ring)
        self._ring_cap = max(8, cap)

    # -- internals (call under self._lock) ---------------------------------
    def _sid_locked(self):
        self._next += 1
        return self._next

    def _ring_locked(self, replica):
        ring = self._rings.get(replica)
        if ring is None:
            ring = self._rings[replica] = deque(maxlen=self._ring_cap)
        return ring

    def _evict_locked(self):
        while len(self._roots) > _MAX_TRACES:
            old = next(iter(self._roots))
            self._roots.pop(old, None)
            self._meta.pop(old, None)
            self._open.pop(old, None)
            self._acc.pop(old, None)

    def _close_open_locked(self, trace, t, attrs=None):
        """Close the trace's current interval span; returns its record
        (or None).  Accumulates the duration into the attribution."""
        cur = self._open.pop(trace, None)
        if cur is None:
            return None
        sid, ph, t0, replica, open_attrs = cur
        if attrs:
            open_attrs = dict(open_attrs or {}, **attrs)
        acc = self._acc.setdefault(trace, {})
        acc[ph] = acc.get(ph, 0.0) + max(0.0, t - t0)
        return self._record_locked(trace, sid, self._roots.get(trace, 0),
                                   ph, replica, t0, t, open_attrs)

    def _record_locked(self, trace, sid, parent, ph, replica, t0, t1,
                       attrs):
        rec = {"type": "span", "trace": trace, "sid": sid,
               "parent": parent, "phase": ph, "replica": replica,
               "t0": t0, "t1": t1, "ms": round(1e3 * (t1 - t0), 3)}
        if attrs:
            rec["attrs"] = attrs
        self._ring_locked(replica).append(rec)
        return rec

    # -- trace lifecycle ---------------------------------------------------
    def open_trace(self, trace, replica, t=None):
        """Open the root span for ``trace`` (idempotent: a requeue or a
        migration re-entering `_post_enqueue` keeps the original root)."""
        with self._lock:
            if trace in self._roots:
                return self._roots[trace]
            sid = self._sid_locked()
            self._roots[trace] = sid
            self._meta[trace] = (time.perf_counter() if t is None else t,
                                 replica)
            self._evict_locked()
            return sid

    def adopt(self, trace, root_sid, replica=None, t=None):
        """Register a trace context carried in from another replica (the
        `HandoffTicket` road): the decode side parents its spans under the
        SAME root the prefill side opened.  No-op when already known —
        in-process fleets share this tracer, so adoption only matters for
        contexts that crossed a serialization boundary."""
        if root_sid is None:
            return
        with self._lock:
            if trace in self._roots:
                return
            self._roots[trace] = root_sid
            self._meta[trace] = (time.perf_counter() if t is None else t,
                                 replica)
            if self._next < root_sid:
                self._next = root_sid
            self._evict_locked()

    def context(self, trace):
        """(trace, root sid) to stamp into a boundary-crossing carrier
        (the handoff ticket), or None when the trace is unknown."""
        with self._lock:
            sid = self._roots.get(trace)
        return None if sid is None else (trace, sid)

    def phase(self, trace, ph, replica, t=None, **attrs):
        """Transition ``trace`` to interval phase ``ph``: closes the
        current interval span (emitting its record) and opens the new one
        at ``t`` (default now).  Opens the root implicitly for a trace
        this tracer has never seen (a request entering through a side
        door still gets a timeline)."""
        t = time.perf_counter() if t is None else t
        with self._lock:
            if trace not in self._roots:
                self._roots[trace] = self._sid_locked()
                self._meta[trace] = (t, replica)
                self._evict_locked()
            closed = self._close_open_locked(trace, t)
            sid = self._sid_locked()
            self._open[trace] = [sid, ph, t, replica, attrs or None]
        if closed is not None:
            telemetry.emit_record(closed)
        return

    def add_span(self, trace, ph, replica, t0, t1, **attrs):
        """Record one completed child span: parented under the trace's
        current interval span (falling back to the root), or free-standing
        with trace 0 for replica-scoped spans (megastep, host sweep)."""
        with self._lock:
            cur = self._open.get(trace)
            parent = cur[0] if cur is not None \
                else self._roots.get(trace, 0)
            sid = self._sid_locked()
            rec = self._record_locked(trace or 0, sid, parent, ph,
                                      replica, t0, t1, attrs or None)
        telemetry.emit_record(rec)

    def finish(self, trace, error=None, ttft_ms=None, e2e_ms=None,
               **attrs):
        """Close the trace: end the open interval span, close the root,
        and fold the per-phase totals into the ``serve.attr.*`` SLO
        attribution histograms (successful requests only — a typed
        failure's timeline still exports, it just doesn't pollute the
        latency decomposition)."""
        now = time.perf_counter()
        with self._lock:
            root = self._roots.pop(trace, None)
            if root is None:
                return None
            t0, replica = self._meta.pop(trace, (now, None))
            closed = self._close_open_locked(trace, now)
            acc = self._acc.pop(trace, {})
            root_attrs = dict(attrs)
            root_attrs["ok"] = error is None
            if error is not None:
                root_attrs["error"] = error
            if ttft_ms is not None:
                root_attrs["ttft_ms"] = round(ttft_ms, 3)
            for ph, secs in acc.items():
                root_attrs["%s_ms" % ph] = round(1e3 * secs, 3)
            rec = self._record_locked(trace, root, 0, "request", replica,
                                      t0, now, root_attrs)
        if closed is not None:
            telemetry.emit_record(closed)
        telemetry.emit_record(rec)
        if error is None and e2e_ms is not None:
            attributed = 0.0
            for ph in ATTR_PHASES:
                ms = 1e3 * acc.get(ph, 0.0)
                attributed += ms
                if ms > 0:
                    telemetry.observe("serve.attr.%s_ms" % ph, ms)
            telemetry.observe("serve.attr.e2e_ms", e2e_ms)
            if ttft_ms is not None:
                telemetry.observe("serve.attr.ttft_ms", ttft_ms)
            telemetry.observe("serve.attr.unattributed_ms",
                              max(0.0, e2e_ms - attributed))
        return rec

    # -- flight recorder ---------------------------------------------------
    def note(self, replica, event):
        """Mirror one telemetry event into the replica's recorder ring
        (wired as a `telemetry` event tap — every `record_event` with a
        ``replica=`` field lands here without per-site plumbing)."""
        with self._lock:
            self._ring_locked(replica).append(
                dict(event, type="event"))

    def dump(self, replica, reason, **fields):
        """Snapshot the replica's ring into ONE `flight_recorder` record
        and emit it atomically (one sink write = one JSONL line) — the
        postmortem for typed failures, chaos trips and scheduler death."""
        with self._lock:
            tail = list(self._rings.get(replica, ()))
        rec = {"type": "flight_recorder", "replica": replica,
               "reason": reason, "time": time.time(), "n": len(tail),
               "ring_cap": self._ring_cap, "tail": tail}
        if fields:
            rec.update(fields)
        telemetry.emit_record(rec)
        return rec

    def snapshot(self, replica):
        """The replica's current recorder ring (tests)."""
        with self._lock:
            return list(self._rings.get(replica, ()))

    def open_traces(self):
        """Trace ids with an unclosed root (tests: leak detection)."""
        with self._lock:
            return sorted(self._roots)


# ---------------------------------------------------------------------------
# Module-level singleton (the call-site surface; every function is a no-op
# when MXNET_SERVE_TRACING=0, so =0 is bit-for-bit)
# ---------------------------------------------------------------------------

_TRACER = None
_TRACER_LOCK = threading.Lock()


def _tap(event):
    replica = event.get("replica")
    if replica and _TRACER is not None and enabled():
        _TRACER.note(replica, event)


def tracer():
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
                telemetry.add_event_tap(_tap)
    return _TRACER


def reset():
    """Drop the singleton (tests / bench A/B legs): clears every ring and
    open trace; the next call re-reads MXNET_TRACE_RING."""
    global _TRACER
    with _TRACER_LOCK:
        _TRACER = None
    telemetry.remove_event_tap(_tap)


def open_trace(trace, replica, t=None):
    if not enabled():
        return None
    return tracer().open_trace(trace, replica, t=t)


def phase(trace, ph, replica, t=None, **attrs):
    if not enabled():
        return
    tracer().phase(trace, ph, replica, t=t, **attrs)


def add_span(trace, ph, replica, t0, t1, **attrs):
    if not enabled():
        return
    tracer().add_span(trace, ph, replica, t0, t1, **attrs)


def finish(trace, error=None, ttft_ms=None, e2e_ms=None, **attrs):
    if not enabled():
        return None
    return tracer().finish(trace, error=error, ttft_ms=ttft_ms,
                           e2e_ms=e2e_ms, **attrs)


def on_finish(req):
    """`ServeRequest._finish` hook: the ONE site every request resolution
    funnels through, so traces can never leak open roots."""
    if not enabled() or _TRACER is None:
        return
    err = req.error
    _TRACER.finish(
        req.id,
        error=None if err is None else type(err).__name__,
        ttft_ms=req.ttft_ms, e2e_ms=req.latency_ms,
        prompt_len=len(req.prompt), n_tokens=len(req.tokens),
        published=req._published)


def context(trace):
    if not enabled() or _TRACER is None:
        return None
    return _TRACER.context(trace)


def adopt(trace, root_sid, replica=None):
    if not enabled() or root_sid is None:
        return
    tracer().adopt(trace, root_sid, replica=replica)


def note(replica, event):
    if not enabled():
        return
    tracer().note(replica, event)


def dump(replica, reason, **fields):
    if not enabled() or _TRACER is None:
        return None
    return _TRACER.dump(replica, reason, **fields)


def snapshot(replica):
    if _TRACER is None:
        return []
    return _TRACER.snapshot(replica)


def spans(records):
    """Group a record stream's spans by trace id (shared by
    tools/trace_report.py and the tests): {trace: [span, ...]} sorted by
    t0, replica-scoped trace-0 spans included under key 0."""
    by_trace = {}
    for r in records:
        if r.get("type") != "span":
            continue
        by_trace.setdefault(r.get("trace", 0), []).append(r)
    for lst in by_trace.values():
        lst.sort(key=lambda s: (s.get("t0", 0.0), s.get("sid", 0)))
    return by_trace
