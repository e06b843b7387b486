"""Router-owned request journal: exact-replay durability for serving.

The port's own copy of `mxnet_tpu/serving/journal.py`.  A replica's death
loses its K/V cache, but not its requests: the preempt-resume formula
already rebuilds a sequence from ``(prompt + generated)[:pos]`` with no
effect on the output, and request-keyed, position-folded sampling makes
every continuation a deterministic function of (seed, context) at any
temperature.  The journal is the `ReplicaRouter`'s ledger of the live
requests it dispatched; a journal entry's durable state is the
`ServeRequest` handle itself (its immutable submission record, the
absolute deadline included, and ``req.tokens``, appended one token at a
time by the owning scheduler).  The two moments the journal reads a
handle (the death hook, which runs on the dying scheduler's thread, and
a drain, which joins the scheduler first) come after its writer has
quiesced, so the view is exact with no copy.

`replay_state` turns that record into the engine's resume tuple
``(ctx, last, pos, n_new)``, the one `ServingEngine._preempt` builds
from live state: the cache must hold rows ``[0, pos)`` = ``prompt +
generated[:-1]``, and the last generated token is fed, never sampled
again, at ``pos``.  A survivor admits the migrated request through its
ordinary resume path (chunked prefill of the replayed context, then
decode at the same position with the same request-keyed generator), so
the continuation is token for token the undisturbed run's.

``MXNET_SERVE_JOURNAL=0`` disables the journal: replica death then fails
the admitted requests typed (`ServeEngineDead`) and re-dispatches the
queued ones.
"""
from __future__ import annotations

import os
import threading

__all__ = ["RequestJournal", "journal_enabled"]

# lazy-prune threshold: entries of finished requests are swept whenever
# the ledger grows past this (submission is the only growth path, so the
# ledger stays O(live requests) without a finish callback)
_PRUNE_AT = 1024


def journal_enabled(default="1"):
    """The ``MXNET_SERVE_JOURNAL`` kill-switch (default on)."""
    return os.environ.get("MXNET_SERVE_JOURNAL", default).lower() \
        not in ("0", "false", "no")


class RequestJournal:
    """Ledger of the router's live requests + the exact-replay formula.

    The ledger itself is observability: `depth()` — exported as the
    ``serve.journal_depth`` gauge at every router submit — is the count
    of durable handles currently outstanding, i.e. how much in-flight
    work a full-fleet loss would cost.  Migration does not need it: the
    death hook hands over the request objects directly and
    `replay_state` is a pure function of one, which is also why
    requests submitted straight to an engine (bypassing the router)
    still migrate.

    Thread contract: `record`/`depth` take the journal lock (submitters
    race each other); `replay_state` is read-only over a request whose
    owning scheduler has quiesced (death hook / post-join drain) and
    needs no lock.  The live-count scan is O(entries) but entries are
    pruned of finished requests at the ``_PRUNE_AT`` bound, so the cost
    per submit stays bounded (and trivial next to a prefill launch).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}          # request id -> ServeRequest
        self.migrations = 0         # requests moved to a survivor
        # (the landing side — serve.replays — is counted by the engine
        # that actually re-prefills the migrated context)
        self.handoff_replays = 0    # migrations that were failed
        # disaggregated handoffs falling back to exact replay

    def record(self, req):
        """Enter ``req`` in the ledger; returns the live depth (one scan
        under one lock acquisition — the ``serve.journal_depth`` gauge
        value)."""
        with self._lock:
            if len(self._entries) >= _PRUNE_AT:
                for rid in [rid for rid, r in self._entries.items()
                            if r.done]:
                    del self._entries[rid]
            self._entries[req.id] = req
            return sum(1 for r in self._entries.values() if not r.done)

    def depth(self):
        """Live (unresolved) journaled requests."""
        with self._lock:
            return sum(1 for r in self._entries.values() if not r.done)

    @staticmethod
    def replay_state(req):
        """The uniform resume tuple ``(ctx, last, pos, n_new)`` for a
        request interrupted mid-flight, derived purely from the journal
        record — or None when nothing was generated yet (a plain
        re-dispatch replays the prompt from scratch; prefill will sample
        its first token exactly once, so nothing duplicates).

        The derivation matches `ServingEngine._preempt`'s live-state
        snapshot by construction: generated tokens [0..n-2] are cached
        (they were fed), the last one was sampled but not yet fed, so
        ``ctx = prompt + generated[:-1]`` and ``last`` re-enters decode
        at ``pos = len(ctx)``.  This holds at every interruption point —
        right after prefill, mid-decode, mid-speculation (only accepted
        tokens ever reach ``req.tokens``), or mid-re-prefill after an
        earlier preemption (where it reproduces the preserved
        ``req._resume`` exactly)."""
        toks = list(req.tokens)
        if not toks:
            return None
        ctx = list(req.prompt) + [int(t) for t in toks[:-1]]
        return (ctx, int(toks[-1]), len(ctx), len(toks))
