"""Typed serving errors: the part of `mxnet_tpu/serving/errors.py` that
this slice of the port raises.

Every one subclasses `ServeError`, itself an `MXNetError`, so a client
can branch on what went wrong.  The deadline, overload, cancel,
quarantine, quantization and replica-death errors belong to engine
features a later slice ports.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServeError", "ServeTimeout", "ServeBlocksExhausted"]


class ServeError(MXNetError):
    """Base of every typed serving failure."""


class ServeTimeout(ServeError):
    """`ServeRequest.result(timeout=...)` expired before the request
    finished.  Client-side only: the request may still complete."""


class ServeBlocksExhausted(ServeError):
    """The paged K/V block pool can never hold this request: its
    worst-case footprint (prompt + max_new_tokens, clipped to the cache
    depth) exceeds the pool's usable blocks.  Raised at `submit`;
    transient pressure is not this error (the request queues, or a
    running one is preempted and replayed)."""
