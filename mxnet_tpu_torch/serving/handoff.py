"""Disaggregated prefill and decode: the handoff (``MXNET_SERVE_DISAGG``).

A port of `mxnet_tpu/serving/handoff.py`.  Under ``MXNET_SERVE_DISAGG=1``
a `ReplicaRouter` gives its replicas roles: a prefill replica runs
chunked prefill only and, once a prompt is cached and its first token
sampled, retires the sequence into a `HandoffTicket` instead of decoding
it; a decode replica receives the ticket, lands the K/V blocks in its own
pool and decodes from the ticket's resume state.  A decode replica never
runs a prefill chunk, so a storm of long prompts queues on the prefill
side while the decoding streams go on at their pace.

The transfer is the host tier's restore: the source gathers the
sequence's blocks into one run on the card (padded with the trash block
up to a restore bucket) and copies it, non-blocking, into one pinned host
buffer behind a CUDA event; the target copies that buffer to the card on
its side stream, after the event, under its current launches, and the
next iteration scatters it into fresh blocks with
`TransformerKVModel.write_block`, the restore's own landing.  The gather
is queued on the pool's stream before any later write to the source
blocks, so they go back to the source's allocator at once.

A ticket carries the request itself (sampling, seed, deadline: nothing
resets) and the resume tuple ``(ctx, last, pos, n_new)`` that preemption
and journal migration use, so a transfer that dies (the ``handoff_fail``
chaos clause, no live decode replica, a target that dies or rebuilds its
cache before the landing) falls back to the journal's exact replay on a
survivor: typed, never hung, never a token delivered twice.

``MXNET_SERVE_DISAGG=0`` (the default) is the colocated fleet: no roles,
no tickets.
"""
from __future__ import annotations

import os
import time

__all__ = ["HandoffTicket", "HandoffLanding", "disagg_enabled"]


def disagg_enabled(default="0"):
    """The ``MXNET_SERVE_DISAGG`` switch (default off)."""
    return os.environ.get("MXNET_SERVE_DISAGG", default).lower() \
        not in ("0", "false", "no")


class HandoffTicket:
    """One prefill-to-decode handoff: the request, its resume tuple and
    the packed K/V run.

    ``ctx`` is the token list cached at rows ``[0, pos)`` and ``last`` the
    sampled token that enters decode at ``pos``.  ``data`` is the pinned
    host run (``(num_layers, 2, kb, block_size, embed)``, or the (int8
    rows, f32 scales) pair under KV quant) whose first ``k`` blocks are
    the sequence's; ``ready`` is the CUDA event its device-to-host copy
    is behind (None on the CPU).  The rows of the partial tail block past
    ``pos`` are never read before the target overwrites them."""

    __slots__ = ("req", "ctx", "last", "pos", "n_new", "data", "k", "kb",
                 "src", "nbytes", "t_start", "ready", "trace", "parent")

    def __init__(self, req, ctx, last, pos, n_new, data, k, kb, src,
                 t_start=None, ready=None):
        self.req = req
        self.ctx = ctx            # tokens cached at rows [0, pos)
        self.last = last          # fed (never sampled again) at pos
        self.pos = pos
        self.n_new = n_new        # generated so far (0: a bootstrap)
        self.data = data          # the pinned host run (or quant pair)
        self.k = k                # real blocks in the run
        self.kb = kb              # the restore bucket the run pads to
        self.src = src            # the source replica's name
        self.nbytes = sum(int(a.nbytes) for a in data) \
            if isinstance(data, tuple) else int(data.nbytes)
        # stamped by the caller before the pack, so serve.handoff_wait_ms
        # spans pack, transfer and landing
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.ready = ready
        # the trace context (trace id, root span id) carried across the
        # role boundary: set from `tracing.context` at the pack, adopted
        # at `ServingEngine.receive_handoff`
        self.trace = None
        self.parent = None


class HandoffLanding:
    """A received ticket staged on the decode replica: a row and fresh
    blocks are held (ordinary refcounts, so every failure path releases
    them like any holder's), the run's copy to the card is in flight on
    the side stream behind ``ready`` (None on the CPU), and
    `ServingEngine._complete_landing` scatters ``staged`` into the blocks
    ``dst_d`` (trash-padded to the bucket) next iteration.  ``src`` holds
    the pinned source until the copy has passed."""

    __slots__ = ("ticket", "row", "blocks", "staged", "dst_d", "t_stage",
                 "src", "ready")

    def __init__(self, ticket, row, blocks, staged, dst_d, ready=None):
        self.ticket = ticket
        self.row = row
        self.blocks = blocks      # the target-side table, fresh blocks
        self.staged = staged      # the run on the card (copy in flight)
        self.dst_d = dst_d        # (kb,) destination ids, trash-padded
        self.t_stage = time.perf_counter()
        self.src = ticket.data
        self.ready = ready
