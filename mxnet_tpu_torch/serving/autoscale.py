"""Telemetry-driven fleet autoscaler (``MXNET_SERVE_AUTOSCALE``).

A port of `mxnet_tpu/serving/autoscale.py`.  A background loop reads the
router's own signals (queue depth per live replica, the ``serve.shed``
counter's rise, the per-role depths of a disaggregated fleet) and resizes
the fleet through `ReplicaRouter.add_replica` (scale-up: a new engine
templated off a live replica, sharing its parameter tensors, whose warmup
builds nothing: the port compiles no programs, where the JAX package's
scale-up warms from a shared frozen `AotCache`) and
`ReplicaRouter.remove_replica` (scale-down: a graceful drain whose
stragglers and session histories migrate to survivors by the journal's
exact replay, so no request fails).

Flap resistance, as in the JAX package:

* the load signal is smoothed by an EMA;
* a decision needs the signal past its threshold for a whole hysteresis
  window (``MXNET_SERVE_HYSTERESIS_S``), and entering another regime
  resets the window;
* every action starts a cooldown of the same length;
* the fleet stays within ``[MXNET_SERVE_AUTOSCALE_MIN,
  MXNET_SERVE_AUTOSCALE_MAX]``.

A disaggregated fleet's prefill and decode pools scale independently off
their own depths.  ``MXNET_SERVE_AUTOSCALE=0`` (the default) wires
nothing.  The decision core (`AutoScaler.decide`) is a pure function of
(pool state, replica count, load, now), testable on synthetic streams
without engines or clocks.
"""
from __future__ import annotations

import logging
import os
import threading
import time

from .. import telemetry
from ..base import MXNetError

__all__ = ["autoscale_enabled", "AutoScaler"]


def autoscale_enabled():
    """The ``MXNET_SERVE_AUTOSCALE`` switch (default off: a fixed
    fleet)."""
    return os.environ.get("MXNET_SERVE_AUTOSCALE", "0").lower() not in (
        "0", "false", "no", "")


class _Pool:
    """Per-pool (colocated fleet, or one prefill/decode role) decision
    state: the EMA'd load signal and the hysteresis/cooldown clocks."""

    def __init__(self, role):
        self.role = role           # None | "prefill" | "decode"
        self.ema = None            # smoothed load (depth per replica)
        self.hot_since = None      # when the signal crossed up_depth
        self.cold_since = None     # when the signal dropped to down_depth
        self.cooldown_until = 0.0  # no action before this


class AutoScaler:
    """Gauge-driven elastic control loop over a `ReplicaRouter`.

    ``up_depth``/``down_depth`` are per-replica queue depths: sustained
    load above ``up_depth`` (default: the engines' ``max_batch``, more
    work waiting than one batch holds) grows the pool by one; sustained
    load at or below ``down_depth`` (default 0.5) shrinks it.  A rise of
    the shed counter counts as pressure whatever the depth: shedding is
    the overload signal.  `start()` spawns the loop; `step()` runs one
    observation (tests drive it directly)."""

    def __init__(self, router, min_replicas=None, max_replicas=None,
                 hysteresis_s=None, up_depth=None, down_depth=None,
                 period=None):
        self.router = router
        self.min_replicas = max(1, int(os.environ.get(
            "MXNET_SERVE_AUTOSCALE_MIN", "1")
            if min_replicas is None else min_replicas))
        self.max_replicas = int(os.environ.get(
            "MXNET_SERVE_AUTOSCALE_MAX", "8")
            if max_replicas is None else max_replicas)
        if self.max_replicas < self.min_replicas:
            raise MXNetError(
                "AutoScaler: MXNET_SERVE_AUTOSCALE_MAX=%d below "
                "MXNET_SERVE_AUTOSCALE_MIN=%d"
                % (self.max_replicas, self.min_replicas))
        self.hysteresis_s = float(os.environ.get(
            "MXNET_SERVE_HYSTERESIS_S", "2.0")
            if hysteresis_s is None else hysteresis_s)
        if up_depth is None:
            up_depth = max((e.max_batch for e in router.engines),
                           default=8) if router is not None else 8
        self.up_depth = float(up_depth)
        self.down_depth = 0.5 if down_depth is None else float(down_depth)
        self.period = max(0.02, self.hysteresis_s / 8.0) \
            if period is None else float(period)
        if router is not None and getattr(router, "_disagg", False):
            self._pools = [_Pool("prefill"), _Pool("decode")]
        else:
            self._pools = [_Pool(None)]
        self._shed_last = None     # serve.shed counter at the last step
        self._stop = threading.Event()
        self._thread = None
        self.actions = []          # (monotonic, pool role, +1/-1) history

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serve-autoscaler", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.period):
            try:
                self.step()
            except Exception:  # noqa: BLE001 -- outlive one bad step
                logging.exception("autoscaler: step failed")

    # -- one observation ---------------------------------------------------
    def step(self, now=None):
        """Sample the gauges, advance every pool's decision state, and
        apply at most one scale action per pool.  Returns the list of
        actions taken this step ([(role, delta)], usually empty)."""
        now = time.monotonic() if now is None else now
        shed = telemetry.registry().counter("serve.shed").value
        shed_delta = 0 if self._shed_last is None else shed - self._shed_last
        self._shed_last = shed
        taken = []
        for pool in self._pools:
            n, load = self._signals(pool)
            if n == 0:
                continue   # the monitor's problem, not a scaling signal
            if shed_delta > 0:
                # shedding is overload: saturate the signal, so the hot
                # window opens even if the depth caught a trough
                load = max(load, self.up_depth)
            delta = self.decide(pool, n, load, now)
            if delta:
                self._apply(pool, delta, n, load)
                taken.append((pool.role, delta))
        return taken

    def _signals(self, pool):
        """(live replica count, raw load) for one pool — depth per live
        replica, with the per-role depth under disagg."""
        engines = [e for e in self.router.engines
                   if e._dead is None and not e._stopped.is_set()
                   and not e._draining]
        if pool.role is not None:
            engines = [e for e in engines if e.role == pool.role]
        n = len(engines)
        if n == 0:
            return 0, 0.0
        if pool.role == "decode":
            depth = sum(e.decode_depth() for e in engines)
        else:
            depth = sum(e.depth() for e in engines)
        return n, depth / float(n)

    def decide(self, pool, n, load, now):
        """The pure decision core: fold one (load, now) observation into
        ``pool``'s state and return +1 (scale up), -1 (scale down) or 0.
        EMA smoothing + full-window hysteresis + post-action cooldown +
        the min/max clamp (the no-flap contract, testable on synthetic
        streams)."""
        alpha = min(1.0, self.period / max(self.hysteresis_s, 1e-9))
        pool.ema = load if pool.ema is None else \
            pool.ema + alpha * (load - pool.ema)
        # the hot side reads max(ema, raw): a pool pinned exactly at
        # up_depth counts as hot (the EMA alone only approaches it); the
        # window below rejects a lone spike.  On the cold side both the
        # smoothed and the raw signal must be idle before the shrink
        # clock starts
        sig = max(pool.ema, load)
        # hot/cold regime windows: entering the opposite (or neutral)
        # regime resets the clock, so pressure must be sustained
        if sig >= self.up_depth:
            pool.cold_since = None
            if pool.hot_since is None:
                pool.hot_since = now
        elif sig <= self.down_depth:
            pool.hot_since = None
            if pool.cold_since is None:
                pool.cold_since = now
        else:
            pool.hot_since = None
            pool.cold_since = None
        if now < pool.cooldown_until:
            return 0
        if pool.hot_since is not None and \
                now - pool.hot_since >= self.hysteresis_s and \
                n < self.max_replicas:
            pool.hot_since = None
            pool.ema = None   # re-learn the signal at the new fleet size
            pool.cooldown_until = now + self.hysteresis_s
            return 1
        if pool.cold_since is not None and \
                now - pool.cold_since >= self.hysteresis_s and \
                n > self.min_replicas:
            pool.cold_since = None
            pool.ema = None
            pool.cooldown_until = now + self.hysteresis_s
            return -1
        return 0

    def _apply(self, pool, delta, n, load):
        role = pool.role
        try:
            if delta > 0:
                fresh = self.router.add_replica(role=role)
                telemetry.inc("serve.scale_ups")
                telemetry.record_event(
                    "serve_scale_up", replica=fresh.name, role=role,
                    n=n + 1, load=round(load, 2))
            else:
                gone = self.router.remove_replica(role=role)
                telemetry.inc("serve.scale_downs")
                telemetry.record_event(
                    "serve_scale_down", replica=gone, role=role,
                    n=n - 1, load=round(load, 2))
        except MXNetError as e:
            # a raced clamp (the last replica, a dead template) skips a
            # beat; the next window decides again
            logging.warning("autoscaler: scale %+d skipped: %s", delta, e)
            return
        self.actions.append((time.monotonic(), role, delta))
