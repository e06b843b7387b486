"""Typed serving errors: a port of `mxnet_tpu/serving/errors.py`.

Every way a `ServeRequest` can fail resolves to exactly one subclass of
`ServeError`, itself an `MXNetError`, so a client can branch on what went
wrong (retry a shed request, drop an expired one, page on an engine
death) instead of matching message strings.  The scopes:

* request-scoped: `ServeOverload`, `ServeDeadlineExceeded`,
  `ServeCancelled`, `ServeTimeout` (a client-side wait, nothing wrong on
  the server), `ServeBlocksExhausted` (at submit), `ServeQuarantined` (a
  request that poisoned its own launch), `ServeQuantError` (the
  quantization logit gate tripped twice);
* cache-scoped: `ServeCacheInvalidated` (a failed launch left the K/V
  cache half-written: every admitted sequence lost its context, the
  engine rebuilt the cache and went on serving its queue);
* engine-scoped: `ServeEngineDead` (the scheduler died, or the engine
  was stopped or is draining).
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServeError", "ServeTimeout", "ServeOverload",
           "ServeDeadlineExceeded", "ServeCancelled", "ServeQuarantined",
           "ServeBlocksExhausted", "ServeQuantError", "ServeCacheInvalidated",
           "ServeEngineDead"]


class ServeError(MXNetError):
    """Base of every typed serving failure."""


class ServeTimeout(ServeError):
    """`ServeRequest.result(timeout=...)` expired before the request
    finished.  Client-side only: the request may still complete."""


class ServeOverload(ServeError):
    """Admission control shed the request: the queue was at
    `MXNET_SERVE_QUEUE_MAX` under the `shed` overload policy (or past
    the 4x backstop under `degrade`).  Safe to retry elsewhere or
    later."""


class ServeDeadlineExceeded(ServeError):
    """The request's `deadline_ms` passed before it finished; the
    scheduler retired it at iteration granularity (a queued request never
    reaches a prefill, a running one leaves the next decode batch)."""


class ServeCancelled(ServeError):
    """`ServeRequest.cancel()` retired the request."""


class ServeQuarantined(ServeError):
    """This single request poisoned its own launch (bad shape escaping a
    bucket, an injected launch fault) and was quarantined; the rest of
    the batch kept decoding."""


class ServeBlocksExhausted(ServeError):
    """The paged K/V block pool can never hold this request: its
    worst-case footprint (prompt + max_new_tokens, clipped to the cache
    depth) exceeds the pool's usable blocks.  Raised at `submit`;
    transient pressure is not this error (the request queues, or a
    running one is preempted and replayed)."""


class ServeQuantError(ServeError):
    """The quantization logit gate tripped twice for this request:
    nonfinite or out-of-range logits under quantized weights or K/V
    (corrupted per-block scales, or a quantization blow-up).  The request
    was retried once over freshly quantized context and then
    quarantined: the engine never emits a token the gate flagged."""


class ServeCacheInvalidated(ServeError):
    """A failed launch consumed the K/V cache (in the port: wrote part of
    it in place, then raised), so every admitted sequence on the replica
    lost its context.  The engine rebuilt the cache and kept serving its
    queue."""


class ServeEngineDead(ServeError):
    """The owning scheduler died (dead device, repeated launch failures),
    or the engine was stopped or is draining, before the request
    finished."""
