"""Deterministic fault injection (chaos): the training clause and the
serving engine's clauses.

A port of `mxnet_tpu/chaos.py`: the ``MXNET_CHAOS`` spec with the JAX
package's whole grammar (comma-separated clauses), its deterministic
random state, and the hooks of the sites the port has::

    nan_grad:N[:inf]      poison the gradients of fused-update call #N in
                          this process with NaN (or +inf)
    decode_slow:P:MS      with probability P a serving decode step sleeps
                          MS ms before launching
    engine_crash:N[:NAME] serving replica NAME (default replica0) raises
                          `ChaosEngineCrash` at its Nth decode-bearing
                          step: a dead device, so the engine dies and a
                          `ReplicaRouter` fails its requests over
    launch_error:P        with probability P a serving prefill or decode
                          launch raises `ChaosError` before it runs (the
                          cache survives): a prefill hit quarantines its
                          request, a decode hit retries
    queue_flood:RATE[:TOTAL]  each serving step injects RATE synthetic
                          one-token requests (TOTAL cap, default 256)
                          through admission control
    block_exhaust:P       with probability P a paged K/V block allocation
                          is denied as if the pool were empty
    prefix_evict:P        with probability P a serving step evicts the
                          LRU parked prefix-cache block
    draft_junk:P          with probability P a speculative-decoding
                          round's draft proposals are corrupted, the
                          same way each time, before the verify: the
                          tokens must not change, only the accept rate

`optimizer.Optimizer.update_multi` calls `grad_poison` once a call, so
``nan_grad:N`` drives the nonfinite-gradient guard
(``MXNET_NONFINITE_GUARD``) and the lr backoff end to end;
`serving.ServingEngine` calls the ``serve_*`` hooks at the JAX engine's
sites.

The other clauses of the grammar (``rpc_drop``, ``rpc_delay``,
``server_crash``, and the serving and gateway clauses ``spill_fail``,
``handoff_fail``, ``restore_slow``, ``scale_corrupt``,
``client_disconnect``, ``slow_consumer``, ``conn_flood``) are parsed as
the JAX package parses them, and then refused with `MXNetError` naming
the clause: their sites (the parameter server, the host tier,
disaggregated serving, quantization, the gateway) are not in the port,
and a spec the port would ignore in part would inject fewer faults than
it says.

Draws come from a ``numpy.random.RandomState`` seeded with
``MXNET_CHAOS_SEED`` (default 0) mixed with the process role and rank
(``DMLC_ROLE``/``DMLC_RANK``/``DMLC_SERVER_ID``), as in the JAX package;
each serving clause draws from a stream of its own (the seed mixed again
with the clause's name, `_Spec.rng_for`), so one spec and seed draw the
same faults in both packages, and adding a clause does not move which
launches another clause hits.  Every hook re-reads ``MXNET_CHAOS``; the
parse is cached on the raw string, so a new value starts a fresh count.
"""
from __future__ import annotations

import logging
import os
import threading
import zlib

import numpy as np

from .base import MXNetError

__all__ = ["ChaosError", "ChaosEngineCrash", "enabled", "spec", "reset",
           "grad_poison", "serve_decode_slow", "serve_engine_crash",
           "serve_launch_error", "serve_queue_flood", "serve_block_exhaust",
           "serve_prefix_evict", "serve_draft_junk"]

# clauses whose injection site the port has
_PORTED = frozenset(("nan_grad", "decode_slow", "engine_crash",
                     "launch_error", "queue_flood", "block_exhaust",
                     "prefix_evict", "draft_junk"))


class ChaosError(OSError):
    """Injected transport or launch failure (an OSError, as a real socket
    error)."""


class ChaosEngineCrash(ChaosError):
    """Injected serving-replica death (`engine_crash:N`).  The engine's
    failure classifier treats it as a dead device: the scheduler dies and
    a router's failover takes over, where a plain `ChaosError` launch
    fault stays scoped to the triggering request or step."""


class _Spec:
    """Parsed MXNET_CHAOS spec + the per-process deterministic RNG and
    injection counters."""

    def __init__(self, raw):
        self.raw = raw
        self.rpc_drop = 0.0
        self.rpc_delay = (0.0, 0.0)       # (probability, milliseconds)
        self.server_crash = None          # (apply_count, server_id)
        self.nan_grad = None              # (call_index, np value)
        self.decode_slow = (0.0, 0.0)     # (probability, milliseconds)
        self.engine_crash = None          # (step_count, replica name)
        self.launch_error = 0.0           # probability per launch
        self.queue_flood = None           # (per-step rate, total cap)
        self.block_exhaust = 0.0          # probability per allocation
        self.prefix_evict = 0.0           # probability per scheduler step
        self.draft_junk = 0.0             # probability per spec round
        self.spill_fail = 0.0             # probability per spill attempt
        self.handoff_fail = 0.0           # probability per handoff transfer
        self.restore_slow = (0.0, 0.0)    # (probability, milliseconds)
        self.scale_corrupt = 0.0          # probability per scheduler step
        self.client_disconnect = 0.0      # probability per gateway stream
        self.slow_consumer = (0.0, 0.0)   # (probability, milliseconds)
        self.conn_flood = None            # (per-poll rate, total cap)
        unported = []
        for clause in filter(None, (c.strip() for c in raw.split(","))):
            parts = clause.split(":")
            kind = parts[0]
            if kind == "rpc_drop":
                self.rpc_drop = float(parts[1])
            elif kind == "rpc_delay":
                self.rpc_delay = (float(parts[1]),
                                  float(parts[2]) if len(parts) > 2 else 50.0)
            elif kind == "server_crash":
                self.server_crash = (int(parts[1]),
                                     int(parts[2]) if len(parts) > 2 else 0)
            elif kind == "nan_grad":
                val = np.inf if len(parts) > 2 and parts[2] == "inf" \
                    else np.nan
                self.nan_grad = (int(parts[1]), val)
            elif kind == "decode_slow":
                self.decode_slow = (float(parts[1]),
                                    float(parts[2]) if len(parts) > 2
                                    else 50.0)
            elif kind == "engine_crash":
                self.engine_crash = (int(parts[1]),
                                     parts[2] if len(parts) > 2
                                     else "replica0")
            elif kind == "launch_error":
                self.launch_error = float(parts[1])
            elif kind == "queue_flood":
                self.queue_flood = (int(parts[1]),
                                    int(parts[2]) if len(parts) > 2 else 256)
            elif kind == "block_exhaust":
                self.block_exhaust = float(parts[1])
            elif kind == "prefix_evict":
                self.prefix_evict = float(parts[1])
            elif kind == "draft_junk":
                self.draft_junk = float(parts[1])
            elif kind == "spill_fail":
                self.spill_fail = float(parts[1])
            elif kind == "handoff_fail":
                self.handoff_fail = float(parts[1])
            elif kind == "restore_slow":
                self.restore_slow = (float(parts[1]),
                                     float(parts[2]) if len(parts) > 2
                                     else 20.0)
            elif kind == "scale_corrupt":
                self.scale_corrupt = float(parts[1])
            elif kind == "client_disconnect":
                self.client_disconnect = float(parts[1])
            elif kind == "slow_consumer":
                self.slow_consumer = (float(parts[1]),
                                      float(parts[2]) if len(parts) > 2
                                      else 50.0)
            elif kind == "conn_flood":
                self.conn_flood = (int(parts[1]),
                                   int(parts[2]) if len(parts) > 2 else 256)
            else:
                raise ValueError(
                    "unknown MXNET_CHAOS clause %r (of %r)" % (clause, raw))
            if kind not in _PORTED:
                unported.append(clause)
        if unported:
            raise MXNetError(
                "MXNET_CHAOS=%r: clause(s) %s inject at sites the port does "
                "not have yet (only %s is ported); remove them"
                % (raw, ", ".join(repr(c) for c in unported),
                   ", ".join(sorted(_PORTED))))
        seed = int(os.environ.get("MXNET_CHAOS_SEED", "0"))
        role = os.environ.get("DMLC_ROLE", "local")
        rank = os.environ.get("DMLC_RANK", os.environ.get("DMLC_SERVER_ID",
                                                          "0"))
        self._seed = seed
        self._role_rank = "%s/%s" % (role, rank)
        mix = zlib.crc32(self._role_rank.encode())
        self.rng = np.random.RandomState((seed + mix) & 0x7FFFFFFF)
        self.fused_update_calls = 0
        self.engine_steps = {}            # replica name -> decode steps
        self.flooded = 0                  # synthetic requests injected
        self._clause_rng = {}
        self.lock = threading.Lock()

    def rng_for(self, clause):
        """The deterministic stream of one serving clause: seeded with
        (seed, role/rank, clause name), so its draws do not depend on
        which other clauses are in the spec."""
        rng = self._clause_rng.get(clause)
        if rng is None:
            mix = zlib.crc32(("%s/%s" % (self._role_rank, clause)).encode())
            rng = np.random.RandomState((self._seed + mix) & 0x7FFFFFFF)
            self._clause_rng[clause] = rng
        return rng


_CACHE = (None, None)   # (raw env string, _Spec)
_CACHE_LOCK = threading.Lock()


def spec():
    """The parsed spec for the current MXNET_CHAOS value, or None.  Cached
    on the raw string, so a new value gets a fresh parse (and fresh
    deterministic RNG and counters)."""
    global _CACHE
    raw = os.environ.get("MXNET_CHAOS")
    if not raw:
        return None
    cached_raw, cached = _CACHE
    if cached_raw == raw:
        return cached
    with _CACHE_LOCK:
        cached_raw, cached = _CACHE
        if cached_raw != raw:
            cached = _Spec(raw)
            _CACHE = (raw, cached)
    return cached


def enabled():
    return spec() is not None


def reset():
    """Drop the cached spec (tests): the next hook call re-parses the env
    and restarts the deterministic draw sequence."""
    global _CACHE
    with _CACHE_LOCK:
        _CACHE = (None, None)


def grad_poison():
    """Poison value for the CURRENT fused optimizer update call, or None.
    Each call to this function counts one fused update in this process
    (1-based), matching the ``nan_grad:N`` clause index."""
    s = spec()
    if s is None or s.nan_grad is None:
        return None
    with s.lock:
        s.fused_update_calls += 1
        at, val = s.nan_grad
        if s.fused_update_calls == at:
            logging.warning("chaos: poisoning gradients of fused update "
                            "call %d with %r", at, val)
            return val
    return None


# -- the serving engine's hooks ----------------------------------------------


def serve_decode_slow():
    """Milliseconds to stall the current decode step (`decode_slow:P:MS`),
    or None.  The engine sleeps on the host before launching."""
    s = spec()
    if s is None or s.decode_slow[0] <= 0:
        return None
    p, ms = s.decode_slow
    with s.lock:
        if s.rng_for("decode_slow").random_sample() < p:
            return ms
    return None


def serve_engine_crash(name):
    """Count one decode-bearing step of replica ``name``; True exactly
    when that replica reaches its ``engine_crash:N`` step.  The count is
    per replica name and goes on past N across a respawn, so a respawned
    replica does not crash again: one crash-and-recover cycle a spec."""
    s = spec()
    if s is None or s.engine_crash is None:
        return False
    at, target = s.engine_crash
    with s.lock:
        n = s.engine_steps.get(name, 0) + 1
        s.engine_steps[name] = n
    if name != target or n != at:
        return False
    logging.error("chaos: crashing serving replica %s at decode step %d "
                  "(MXNET_CHAOS=%s)", name, at, s.raw)
    return True


def serve_launch_error():
    """True when the current serving launch should fail with a
    `ChaosError` before it runs (`launch_error:P`): the cache is never
    written, so the engine scopes the fault to the request or step."""
    s = spec()
    if s is None or s.launch_error <= 0:
        return False
    with s.lock:
        return bool(s.rng_for("launch_error").random_sample()
                    < s.launch_error)


def serve_block_exhaust():
    """True when the current paged K/V block allocation should be denied
    (`block_exhaust:P`) without touching the free list."""
    s = spec()
    if s is None or s.block_exhaust <= 0:
        return False
    with s.lock:
        return bool(s.rng_for("block_exhaust").random_sample()
                    < s.block_exhaust)


def serve_prefix_evict():
    """True when the current serving step should evict the LRU parked
    prefix-cache block (`prefix_evict:P`)."""
    s = spec()
    if s is None or s.prefix_evict <= 0:
        return False
    with s.lock:
        return bool(s.rng_for("prefix_evict").random_sample()
                    < s.prefix_evict)


def serve_draft_junk():
    """True when the current speculative-decoding round's proposals
    should be corrupted (`draft_junk:P`): the verify accepts only tokens
    the target itself picks, so the output stays, at a lower accept
    rate."""
    s = spec()
    if s is None or s.draft_junk <= 0:
        return False
    with s.lock:
        return bool(s.rng_for("draft_junk").random_sample()
                    < s.draft_junk)


def serve_queue_flood():
    """Synthetic requests the current serving step injects through
    admission control (`queue_flood:RATE[:TOTAL]`); 0 when the clause is
    absent or its TOTAL is spent."""
    s = spec()
    if s is None or s.queue_flood is None:
        return 0
    rate, total = s.queue_flood
    with s.lock:
        n = min(rate, total - s.flooded)
        if n <= 0:
            return 0
        s.flooded += n
    return n
