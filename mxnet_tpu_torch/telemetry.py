"""Training telemetry: a process-wide metrics registry with a per-step
JSONL stream, a retrace watch, and health statistics staged on the
device.

A port of `mxnet_tpu/telemetry.py`, nearly verbatim, since it is host
code over numpy:

* **Registry** -- counters (monotonic), gauges (last value), histograms
  (per-step observation pools) and events.  The training path feeds it
  under the JAX package's names: ``train.host_blocking_fetches`` (and
  its ``.metric_update``, ``.metric_interval``, ``.health`` parts),
  ``train.nonfinite_steps``, ``train.auto_checkpoints``,
  ``train.resumes``, ``train.steps_in_flight``, ``io.device_batches``,
  ``io.wait_ms``, ``io.device_wait_ms``, ``io.prefetch_depth``,
  ``io.input_wait_frac``, ``kvstore.push_*``/``pull_*``, and the events
  ``retrace``, ``nonfinite_grads``, ``lr_backoff``, ``auto_checkpoint``
  and ``resume``.  ``MXNET_TELEMETRY=0`` turns every call site into a
  no-op.  The JAX executor's compile-cache counters have no counterpart:
  the port compiles no programs.
* **Sinks** -- `step_report()` rolls the registry into one JSON record
  per training step and emits it to every attached sink (`JsonlSink`,
  with size-capped rotation; `MemorySink` for tests).
  ``MXNET_TELEMETRY_JSONL=<path>`` attaches a file sink.  The loops call
  `step_end()`, which is free until a sink is attached.
* **Retrace watch** -- `watch_jit(site, sig)` tracks the shape and dtype
  signatures each chokepoint (the executor's forward and training step,
  the trainer's step, the fused optimizer update) has been called with.
  The port compiles nothing, but a new signature after the first call is
  where the JAX package recompiles, so the watch fires one diagnosed
  ``retrace`` event at the same calls.  Torch dtypes sign as the JAX
  package's names (``float32``, not ``torch.float32``).
* **Health staging** -- `stage_health()` parks the small device tensor
  that `Optimizer.update_multi` computes beside the update (grad, update
  and parameter second moments and the nonfinite count); it is read on
  the host only at `health()` / `step_report()` / `consume_nonfinite()`,
  with one ``.cpu()`` a window, counted as a blocking fetch.

Like the JAX module, this one imports only the standard library and
numpy (a staged tensor is read through its own methods).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

import numpy as np

__all__ = [
    "MetricsRegistry", "JsonlSink", "MemorySink",
    "registry", "reset", "enabled", "health_enabled", "retrace_enabled",
    "inc", "set_gauge", "observe", "record_event", "events",
    "emit_record", "add_event_tap", "remove_event_tap",
    "add_sink", "remove_sink", "register_collector",
    "step_report", "step_end",
    "arrays_signature", "watch_jit",
    "stage_health", "health", "consume_nonfinite",
    "blocking_fetch",
]


# ---------------------------------------------------------------------------
# Env knobs (read per call: tests and debugging sessions flip them live,
# the same contract as optimizer.fused_update_enabled)
# ---------------------------------------------------------------------------

def enabled():
    """Master switch: MXNET_TELEMETRY=0 no-ops every instrumentation site."""
    return os.environ.get("MXNET_TELEMETRY", "1").lower() not in (
        "0", "false", "no")


def health_enabled():
    """MXNET_TELEMETRY_HEALTH=1 computes grad-norm/update-ratio/nonfinite
    moments beside the fused `Optimizer.update_multi` (default off: they
    cost a few reductions over every gradient and weight)."""
    return enabled() and os.environ.get(
        "MXNET_TELEMETRY_HEALTH", "0").lower() in ("1", "true", "yes")


def retrace_enabled():
    """MXNET_TELEMETRY_RETRACE=0 disables the retrace watchdog (signature
    bookkeeping is O(n_args) tuple building per step)."""
    return enabled() and os.environ.get(
        "MXNET_TELEMETRY_RETRACE", "1").lower() not in ("0", "false", "no")


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------

class MemorySink:
    """Test sink: keeps every emitted record in `.records`."""

    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def close(self):
        pass


class JsonlSink:
    """One JSON object per line, flushed per record so a crashed run keeps
    its stream up to the last completed step.

    Size-capped rotation for long soaks: when `max_mb` (default
    ``MXNET_TELEMETRY_MAX_MB``, 0 = unbounded) is set and the current file
    crosses it, the stream rotates shift-style — ``path`` -> ``path.1`` ->
    ``path.2`` ... keeping the newest `keep` (``MXNET_TELEMETRY_KEEP``,
    default 3) rotated files — so a multi-hour serve bench with per-request
    span records cannot fill the disk.  Rotation happens on a record
    boundary, so every file in the set stays valid JSONL."""

    def __init__(self, path, max_mb=None, keep=None):
        self.path = path
        if max_mb is None:
            max_mb = float(os.environ.get("MXNET_TELEMETRY_MAX_MB", "0"))
        if keep is None:
            keep = int(os.environ.get("MXNET_TELEMETRY_KEEP", "3"))
        self.max_bytes = int(max_mb * 1024 * 1024)
        self.keep = max(1, keep)
        self._f = None
        self._written = 0

    def _rotate(self):
        self._f.close()
        self._f = None
        for k in range(self.keep, 0, -1):
            src = self.path if k == 1 else "%s.%d" % (self.path, k - 1)
            dst = "%s.%d" % (self.path, k)
            try:
                if os.path.exists(src):
                    os.replace(src, dst)
            except OSError:
                pass
        # anything past the keep window from an earlier, larger keep
        extra = "%s.%d" % (self.path, self.keep + 1)
        if os.path.exists(extra):
            try:
                os.remove(extra)
            except OSError:
                pass
        self._written = 0

    def emit(self, record):
        if self._f is None:
            d = os.path.dirname(os.path.abspath(self.path))
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
            try:
                self._written = os.path.getsize(self.path)
            except OSError:
                self._written = 0
        line = json.dumps(record, default=str) + "\n"
        self._f.write(line)
        self._f.flush()
        self._written += len(line)
        if self.max_bytes and self._written >= self.max_bytes:
            self._rotate()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# Metric handles (thin views over the registry's dicts)
# ---------------------------------------------------------------------------

class Counter:
    __slots__ = ("_reg", "name")

    def __init__(self, reg, name):
        self._reg, self.name = reg, name

    def inc(self, n=1):
        self._reg.inc(self.name, n)

    @property
    def value(self):
        return self._reg._counters.get(self.name, 0)


class Gauge:
    __slots__ = ("_reg", "name")

    def __init__(self, reg, name):
        self._reg, self.name = reg, name

    def set(self, v):
        self._reg.set_gauge(self.name, v)

    @property
    def value(self):
        return self._reg._gauges.get(self.name)


class Histogram:
    __slots__ = ("_reg", "name")

    def __init__(self, reg, name):
        self._reg, self.name = reg, name

    def observe(self, v):
        self._reg.observe(self.name, v)


class _Watch:
    """Per-(site, scope) retrace watchdog state.  `seen` is an insertion-
    ordered dict used as a bounded set: a pathological workload that mints
    a new signature every step (the exact thing the watchdog diagnoses)
    must not also grow memory without bound."""

    __slots__ = ("seen", "last", "n_total")
    MAX_SEEN = 64

    def __init__(self, sig):
        self.seen = {sig: None}
        self.last = sig
        self.n_total = 1

    def add(self, sig):
        self.seen[sig] = None
        self.n_total += 1
        if len(self.seen) > self.MAX_SEEN:
            del self.seen[next(iter(self.seen))]


_scope_lock = threading.Lock()
_scope_counter = [0]


def watch_scope(obj, attr="_telemetry_scope"):
    """Stable watchdog scope token for `obj`, minted once and stored on the
    object.  Unlike raw id(), a token is never reused after GC, so a new
    model allocated at a dead one's address cannot inherit its signature
    history and fire a spurious retrace."""
    tok = getattr(obj, attr, None)
    if tok is None:
        with _scope_lock:
            _scope_counter[0] += 1
            tok = _scope_counter[0]
        try:
            setattr(obj, attr, tok)
        except AttributeError:  # slotted/immutable obj: fall back to id
            return id(obj)
    return tok


_MAX_HIST = 65536    # per-step observation pool cap (drained every report)
_MAX_EVENTS = 1024   # cumulative event-log cap


class MetricsRegistry:
    """Process-wide metric store.  All mutators are thread-safe (the
    prefetch workers feed it from their own threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._hists = {}          # name -> [observations since last report]
        self._hist_counts = {}    # name -> observed count since last report
        #   (may exceed len(pool) when the _MAX_HIST cap truncated it)
        self._events = []         # since last report
        self._event_log = []      # cumulative (capped)
        self._sinks = []
        self._collectors = {}     # name -> fn() -> dict
        self._watches = {}        # (site, scope) -> _Watch
        self._pending_health = None  # (names, [device_arrays]), unfetched
        self._health_fresh = False   # staged since the last step report
        self._nonfinite_pending = 0  # bad-grad updates since consume_*()
        self._step = 0
        self._last_counters = {}
        self._last_time = None

    # -- handles -----------------------------------------------------------
    def counter(self, name):
        return Counter(self, name)

    def gauge(self, name):
        return Gauge(self, name)

    def histogram(self, name):
        return Histogram(self, name)

    # -- mutators ----------------------------------------------------------
    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name, v):
        with self._lock:
            self._gauges[name] = v

    def observe(self, name, v):
        with self._lock:
            pool = self._hists.setdefault(name, [])
            if len(pool) < _MAX_HIST:
                pool.append(float(v))
            self._hist_counts[name] = self._hist_counts.get(name, 0) + 1

    def record_event(self, kind, **fields):
        ev = {"kind": kind, "time": time.time()}
        ev.update(fields)
        with self._lock:
            self._counters["events.%s" % kind] = \
                self._counters.get("events.%s" % kind, 0) + 1
            # both buffers capped: with no sink attached, step_report never
            # drains _events, and a per-step event source (e.g. a watchdog
            # firing every step) must not grow memory for the process
            # lifetime
            self._events.append(ev)
            if len(self._events) > _MAX_EVENTS:
                del self._events[:len(self._events) - _MAX_EVENTS]
            self._event_log.append(ev)
            if len(self._event_log) > _MAX_EVENTS:
                del self._event_log[:len(self._event_log) - _MAX_EVENTS]
        return ev

    def events(self, kind=None):
        with self._lock:
            log = list(self._event_log)
        if kind is not None:
            log = [e for e in log if e.get("kind") == kind]
        return log

    def emit_record(self, record):
        """Emit one raw record to every sink, bypassing the step rollup —
        the tracing span/flight-recorder stream rides the same JSONL as
        the step reports (readers discriminate on ``record["type"]``)."""
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink.emit(record)
            except Exception:
                logging.exception("telemetry sink %r failed", sink)
        return record

    # -- sinks / collectors ------------------------------------------------
    def add_sink(self, sink):
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
        close = getattr(sink, "close", None)
        if close:
            close()

    def register_collector(self, name, fn):
        """`fn() -> dict`, merged into each step report under `name` (e.g.
        the storage module contributes pool and device memory stats).  Re-registering a
        name replaces the previous collector."""
        with self._lock:
            self._collectors[name] = fn

    # -- health staging ----------------------------------------------------
    def stage_health(self, names, values):
        """Park the in-graph health moments (a small DEVICE array computed
        by the fused update program).  The blocking host fetch happens at
        `health()` / `step_report()`, never here — staging must not add a
        host transfer to the update call.  Multiple stagings between
        fetches (one fused update per device, or per KVStore bucket)
        ACCUMULATE: the derived stats cover every update since the last
        fetch, so a NaN on device 0 is not masked by a clean device 1."""
        names = tuple(names)
        with self._lock:
            pending = self._pending_health
            if pending is not None and pending[0] == names:
                pending[1].append(values)
                # bounded like every other telemetry buffer: if nothing
                # ever drains (health on, no sink, no health() caller),
                # keep the most recent window instead of pinning one
                # device buffer per update call for the process lifetime
                if len(pending[1]) > 128:
                    del pending[1][0]
            else:
                self._pending_health = (names, [values])
            self._health_fresh = True

    def health(self):
        """Derive the staged health stats:
        {grad_norm, update_ratio, param_norm, nonfinite} or None.  The
        device arrays are fetched ONCE and memoized — repeated calls (or
        step reports with no update in between) pay no extra transfers."""
        with self._lock:
            pending, self._pending_health = self._pending_health, None
        if pending is not None:
            # this fetch of device tensors IS a blocking fetch on
            # whichever thread drains the stats: count it with the
            # training loops' other sync points
            self.inc("train.host_blocking_fetches")
            self.inc("train.host_blocking_fetches.health")
            names, value_list = pending
            vals = dict(zip(names, _fetch_sum(value_list)))
            grad_sq = vals.get("grad_sq", 0.0)
            upd_sq = vals.get("update_sq", 0.0)
            param_sq = vals.get("param_sq", 0.0)
            out = {
                "grad_norm": float(np.sqrt(max(grad_sq, 0.0))),
                "param_norm": float(np.sqrt(max(param_sq, 0.0))),
                "update_ratio": float(np.sqrt(upd_sq / param_sq))
                if param_sq > 0 else 0.0,
                "nonfinite": int(vals.get("nonfinite", 0.0)),
            }
            with self._lock:
                self._last_health = out
            if out["nonfinite"]:
                # recovery accounting: a freshly-derived window with
                # nonfinite grads counts as one bad step (the env read
                # dodges an optimizer import cycle; MXNET_NONFINITE_GUARD
                # means update_multi where'd the whole bucket to a no-op)
                skipped = os.environ.get(
                    "MXNET_NONFINITE_GUARD", "0").lower() in (
                        "1", "true", "yes")
                with self._lock:
                    self._nonfinite_pending += 1
                self.inc("train.nonfinite_steps")
                self.record_event("nonfinite_grads",
                                  count=out["nonfinite"], skipped=skipped)
        return getattr(self, "_last_health", None)

    def consume_nonfinite(self):
        """Number of nonfinite-gradient updates observed since the last
        call (draining any staged health stats first).  The training
        loops' optional lr backoff polls this so one bad step backs off
        exactly once."""
        self.health()
        with self._lock:
            n, self._nonfinite_pending = self._nonfinite_pending, 0
        return n

    # -- retrace watchdog --------------------------------------------------
    def watch_jit(self, site, sig, scope=None, meta=None, seed=False):
        """Record one call of the chokepoint at `site` with signature
        `sig` (see `arrays_signature`).  The first signature per
        (site, scope) is the warmup; every NEW signature after it is where
        the JAX package misses its jit cache -- one retrace event fires
        per distinct signature, with a diagnosis diffing against the
        previous call.
        Returns the event dict when one fired, else None.

        ``seed=True`` DECLARES the signature instead of observing a call:
        it joins the seen set without firing.  Multi-shape warmups (the
        serving engine pre-AOT-compiles a whole bucket set) seed each
        bucket's signature so only a shape that escaped the declared set
        ever diagnoses as a recompile."""
        meta_items = tuple(sorted((meta or {}).items()))
        full = (tuple(sig), meta_items)
        key = (site, scope)
        with self._lock:
            w = self._watches.get(key)
            if w is not None and seed and full not in w.seen:
                w.add(full)
                w.last = full
                return None
            if w is None:
                # bounded: transient executors/optimizers (sweeps, test
                # suites) must not accrete signature sets forever — evict
                # the oldest scope past the cap (insertion-ordered dict)
                if len(self._watches) >= 512:
                    self._watches.pop(next(iter(self._watches)))
                self._watches[key] = _Watch(full)
                return None
            if full in w.seen:
                w.last = full
                return None
            diagnosis = _diagnose(w.last, full)
            w.add(full)
            n_sigs = w.n_total
            w.last = full
        logging.warning("telemetry: retrace at %s (%d distinct signatures "
                        "compiled): %s", site, n_sigs, diagnosis)
        return self.record_event("retrace", site=site, diagnosis=diagnosis,
                                 n_signatures=n_sigs)

    # -- per-step rollup ---------------------------------------------------
    def step_report(self, step=None, extra=None):
        """Roll everything observed since the last report into one record,
        emit it to every sink, and return it."""
        now = time.time()
        with self._lock:
            self._step += 1
            rec_step = self._step if step is None else step
            all_counters = dict(self._counters)
            deltas = {k: v - self._last_counters.get(k, 0)
                      for k, v in all_counters.items()
                      if v != self._last_counters.get(k, 0)}
            self._last_counters = all_counters
            # per-record counters carry the cumulative value of only the
            # counters that CHANGED this step: record size stays O(active
            # sites) instead of O(every name ever seen), and a counter's
            # final total is still recoverable from its last appearance
            # in the stream (tools/telemetry_report.py reads it that way)
            counters = {k: all_counters[k] for k in deltas}
            gauges = dict(self._gauges)
            health_fresh, self._health_fresh = self._health_fresh, False
            hists, drained = {}, self._hists
            self._hists = {}
            observed_counts, self._hist_counts = self._hist_counts, {}
            ev, self._events = self._events, []
            last_time, self._last_time = self._last_time, now
            sinks = list(self._sinks)
            collectors = dict(self._collectors)
        for name, pool in drained.items():
            pool.sort()
            n = len(pool)
            hists[name] = {
                "count": observed_counts.get(name, n),  # true observations
                "mean": sum(pool) / n,
                "p50": pool[n // 2],
                "p99": pool[min(n - 1, int(n * 0.99))],
                "max": pool[-1],
            }
            if observed_counts.get(name, n) > n:
                # the _MAX_HIST cap dropped observations: disclose that the
                # summary stats cover only the first `sampled` of them
                hists[name]["sampled"] = n
        record = {
            "type": "step",
            "step": rec_step,
            "time": now,
            "counters": counters,
            "deltas": deltas,
            "gauges": gauges,
            "hists": hists,
            "events": ev,
        }
        if last_time is not None:
            record["wall_ms"] = 1e3 * (now - last_time)
        if health_fresh:
            # deferred device fetch happens here; stale stats (no update
            # since the last report) are NOT re-stamped into new records
            h = self.health()
            if h is not None:
                record["health"] = h
        for name, fn in collectors.items():
            try:
                record[name] = fn()
            except Exception as e:  # a broken collector must not kill a step
                record[name] = {"error": str(e)[:200]}
        if extra:
            record.update(extra)
        for sink in sinks:
            try:
                sink.emit(record)
            except Exception:
                logging.exception("telemetry sink %r failed", sink)
        return record

    def close(self):
        with self._lock:
            sinks, self._sinks = self._sinks, []
        for s in sinks:
            close = getattr(s, "close", None)
            if close:
                try:
                    close()
                except Exception:
                    pass


# ---------------------------------------------------------------------------
# Signature building / retrace diagnosis
# ---------------------------------------------------------------------------

def arrays_signature(arrays, names=None):
    """((name, shape, dtype), ...) signature of a list of arrays or
    tensors: what the JAX package's jit cache keys each argument on.
    `names` (optional, may be shorter) labels entries for readable
    diagnoses."""
    out = []
    for i, a in enumerate(arrays):
        name = names[i] if names is not None and i < len(names) \
            else "arg%d" % i
        out.append((name, tuple(getattr(a, "shape", ())),
                    _dtype_name(getattr(a, "dtype", type(a).__name__))))
    return tuple(out)


def _dtype_name(dtype):
    """A dtype's name as the JAX package signs it: ``torch.float32`` ->
    ``float32``."""
    name = str(dtype)
    return name[6:] if name.startswith("torch.") else name


def _fetch_sum(value_list):
    """The float64 sum of staged moment vectors: numpy arrays, or tensors
    (possibly on several devices) summed on the first one's device and
    read with one ``.cpu()``."""
    if hasattr(value_list[0], "cpu"):
        acc = value_list[0].double()
        for v in value_list[1:]:
            acc = acc + v.to(acc.device).double()
        return acc.cpu().numpy()
    summed = np.zeros(len(value_list[0]), np.float64)
    for v in value_list:  # moments are sums: accumulate on host
        summed += np.asarray(v, np.float64)
    return summed


def _diagnose(old, new):
    """Human diff of two watch signatures: which args changed shape/dtype,
    which appeared/disappeared, which meta entries (donation mode, traced
    hyperparameters) mutated."""
    old_args, old_meta = old
    new_args, new_meta = new
    lines = []
    od = {n: (s, d) for n, s, d in old_args}
    nd = {n: (s, d) for n, s, d in new_args}
    for n, (s, d) in nd.items():
        if n not in od:
            lines.append("%s: new arg %s %s" % (n, d, s))
        elif od[n] != (s, d):
            os_, odt = od[n]
            if os_ != s:
                lines.append("%s: shape %s -> %s" % (n, os_, s))
            if odt != d:
                lines.append("%s: dtype %s -> %s" % (n, odt, d))
    for n in od:
        if n not in nd:
            lines.append("%s: arg removed" % n)
    if len(old_args) != len(new_args):
        lines.append("n_args %d -> %d" % (len(old_args), len(new_args)))
    om, nm = dict(old_meta), dict(new_meta)
    for k, v in nm.items():
        if k not in om:
            lines.append("%s: new (%r)" % (k, v))
        elif om[k] != v:
            lines.append("%s: %r -> %r" % (k, om[k], v))
    for k in om:
        if k not in nm:
            lines.append("%s: removed" % k)
    return "; ".join(lines) if lines else "signature changed"


# ---------------------------------------------------------------------------
# Module-level singleton API (the hot-path surface call sites use)
# ---------------------------------------------------------------------------

_REG = None
_REG_LOCK = threading.Lock()
# collectors that survive `reset()` — framework modules (storage) register
# here at import time; every fresh registry is seeded with them
_DEFAULT_COLLECTORS = {}


def registry():
    """The process-wide registry (created on first use; attaches the
    MXNET_TELEMETRY_JSONL sink when that knob is set)."""
    global _REG
    if _REG is None:
        with _REG_LOCK:
            if _REG is None:
                reg = MetricsRegistry()
                reg._collectors.update(_DEFAULT_COLLECTORS)
                path = os.environ.get("MXNET_TELEMETRY_JSONL")
                if path and enabled():
                    reg.add_sink(JsonlSink(path))
                _REG = reg
    return _REG


def reset():
    """Drop the singleton (tests): closes sinks, clears all state.  The
    next `registry()` call re-reads MXNET_TELEMETRY_JSONL."""
    global _REG
    with _REG_LOCK:
        reg, _REG = _REG, None
    if reg is not None:
        reg.close()


def inc(name, n=1):
    if not enabled():
        return
    registry().inc(name, n)


def set_gauge(name, v):
    if not enabled():
        return
    registry().set_gauge(name, v)


def observe(name, v):
    if not enabled():
        return
    registry().observe(name, v)


def record_event(kind, **fields):
    if not enabled():
        return None
    ev = registry().record_event(kind, **fields)
    # event taps (the tracing flight recorder) see every event the process
    # records; a broken tap must not kill the instrumented call site
    for tap in list(_EVENT_TAPS):
        try:
            tap(ev)
        except Exception:
            logging.exception("telemetry event tap %r failed", tap)
    return ev


def events(kind=None):
    if _REG is None:
        return []
    return _REG.events(kind)


def emit_record(record):
    """Emit one raw (non-step) record to the attached sinks — no-op until
    a sink exists, so span emission is free in unsinked processes."""
    if not enabled() or _REG is None or not _REG._sinks:
        return None
    return _REG.emit_record(record)


# taps survive registry reset() (they belong to the tracing module's
# lifecycle, not the registry's); tracing.reset() removes its own tap
_EVENT_TAPS = []


def add_event_tap(fn):
    """Forward every `record_event` dict to `fn` (the tracing flight
    recorder mirrors replica-tagged events into its rings this way — the
    dependency points tracing -> telemetry, never back)."""
    if fn not in _EVENT_TAPS:
        _EVENT_TAPS.append(fn)
    return fn


def remove_event_tap(fn):
    if fn in _EVENT_TAPS:
        _EVENT_TAPS.remove(fn)


def add_sink(sink):
    return registry().add_sink(sink)


def remove_sink(sink):
    if _REG is not None:
        _REG.remove_sink(sink)


def register_collector(name, fn, default=False):
    """Merge `fn()`'s dict into every step report under `name`.  With
    ``default=True`` the registration survives `reset()` (for framework
    modules that register once at import) and does NOT force the
    singleton into existence — `import mxnet_tpu` must not consume
    MXNET_TELEMETRY_JSONL before the user's code has a chance to set it
    (the sink attaches at first registry USE, as documented)."""
    if default:
        _DEFAULT_COLLECTORS[name] = fn
        if _REG is not None:
            _REG.register_collector(name, fn)
        return
    registry().register_collector(name, fn)


def step_report(step=None, extra=None):
    return registry().step_report(step=step, extra=extra)


def step_end(step=None, extra=None):
    """Training-loop hook: emit a step report IF a sink is attached, else
    do nothing (so instrumented loops stay free until someone opts into a
    stream via `add_sink` or MXNET_TELEMETRY_JSONL)."""
    if not enabled():
        return None
    reg = registry()
    if not reg._sinks:
        return None
    return reg.step_report(step=step, extra=extra)


def watch_jit(site, sig, scope=None, meta=None, seed=False):
    if not retrace_enabled():
        return None
    return registry().watch_jit(site, sig, scope=scope, meta=meta,
                                seed=seed)


def blocking_fetch(site):
    """Record one blocking host<-device fetch on the TRAINING hot path
    (per-batch metric update, interval metric fetch, health drain).  The
    `train.host_blocking_fetches` counter is the zero-sync loop's
    acceptance metric: in steady state it must advance at most once per
    MXNET_METRIC_INTERVAL steps (tests/test_prefetch_metrics.py)."""
    if not enabled():
        return
    reg = registry()
    reg.inc("train.host_blocking_fetches")
    reg.inc("train.host_blocking_fetches.%s" % site)


def stage_health(names, values):
    if not enabled():
        return
    registry().stage_health(names, values)


def health():
    if _REG is None:
        return None
    return _REG.health()


def consume_nonfinite():
    if _REG is None:
        return 0
    return _REG.consume_nonfinite()
