"""Continuous-batching serving engine, in PyTorch.

A port of the single-replica engine of `mxnet_tpu/serving/engine.py`
`ServingEngine`, with its request contract and prefix cache.
Iteration-level scheduling: the unit of work is one decode step over
whichever sequences are active; a request joins the batch after its
prefill and leaves the step it finishes.  Shapes come from a small fixed
set of buckets, as in the JAX engine: prompts right-pad to a prefill
bucket, the active set pads to a decode bucket with padding rows pointed
at a trash slot or the trash block.

The K/V cache is paged by default: a block pool updated in place, per-row
block tables and a host-side refcounted allocator (`paged.BlockAllocator`).
Admission allocates the prompt's blocks, the prompt streams through the
pool in bucket-sized chunks (one chunk per prefilling request per
iteration), and a row grows one block at a time.  ``paged=False`` is the
slot cache: one (S_max, embed) row per batch slot, prefilled through the
flash-attention kernel in one launch.

Prefix caching is on whenever the engine pages (``prefix=False``, or
``MXNET_SERVE_PREFIX=0``, restores single-owner paging): a radix index
over full-block token runs (`paged.PrefixCache`) maps each cached run to
the block already holding its K/V.  Admission acquires the longest cached
prefix and prefills only the suffix; a prompt the index covers completely
skips prefill and bootstraps through one decode of its last token.  A
writer about to touch a shared or registered block gets a private copy
first (copy-on-write, `TransformerKVModel.copy_block`).  Retired
registered blocks park in an LRU pool, evicted only under allocation
pressure or past ``prefix_pool``.  `leaked_blocks()` is the accounting
check: every usable block is free, held or parked.

A denied allocation preempts: the row's blocks are released, the request
requeues at the front with its generated tokens, and the re-admission
replays ``(prompt + generated)[:pos]`` exactly, so preemption never shows
in the output.  Anti-thrash guards are on by default: a resumed sequence
is exempt from another preemption until it advances ``min_progress``
tokens (a protected row whose growth is denied first preempts a younger
victim, and stalls out of the decode step if that frees too little), the
oldest in-flight request is never a victim, and ``thrash_trip``
preemptions without a completion cap new admissions at
``max_new_tokens // 4`` until a request completes.  ``min_progress=0``
preempts on every denial.

Every submitted request resolves, with its tokens or a typed
`ServeError`: a deadline (``deadline_ms``) or ``cancel()`` retires it at
iteration granularity, queued or running; a bounded queue
(``queue_max``) sheds, blocks or degrades new work (``overload``);
``stop()`` and a dead scheduler fail what is left with
`ServeEngineDead`; ``drain()`` closes admission, serves out what is here
and returns the stragglers.  The scheduler runs on the caller's thread
(`step`, `run_until_idle`) or on its own (`start`).

Launch failures are scoped as in the JAX engine (`_classify_failure`):
a request that poisons its own prefill is quarantined
(`ServeQuarantined`) while the batch goes on; a program that raised
after its first in-place write has left the cache half-written (the
model's write mark, `TransformerKVModel.cache_lost`, the port's
counterpart of a consumed donated buffer), so every admitted sequence
fails with `ServeCacheInvalidated`, the cache is reallocated and the
queue goes on being served; a scoped decode failure retries up to
``MXNET_SERVE_LAUNCH_RETRIES`` consecutive times (3) before the engine
dies; a dead device (chaos's `ChaosEngineCrash`, a device message, and
in the port any ``CUDA error:`` but out of memory, after which the CUDA
context is unusable) kills the scheduler.  A dying engine hands its
in-flight and queued requests to its router's failover hook
(`ReplicaRouter`), which migrates the admitted ones to a survivor by
exact replay of ``(prompt + generated)[:pos]`` (`journal.RequestJournal`)
and respawns the dead replica.  Chaos's serving clauses
(``decode_slow``, ``engine_crash``, ``launch_error``, ``block_exhaust``,
``prefix_evict``, ``queue_flood``) inject at the JAX engine's sites.

Telemetry (`mxnet_tpu_torch.telemetry`) gets the JAX engine's counters,
histograms, gauges and events under its names: ``serve.requests``,
``serve.prefills``, ``serve.tokens``, ``serve.decode_steps``,
``serve.quarantined``, ``serve.cache_rebuilds``, ``serve.launch_errors``,
``serve.shed``, ``serve.failovers`` and the rest, each per-replica
counter again as ``serve.<name>.<counter>``, the ``serve.latency_ms`` /
``serve.ttft_ms`` / ``serve.queue_age_ms`` histograms, the per-replica
gauges and the ``serve_quarantine``, ``serve_cache_rebuild``,
``serve_preempt``, ``serve_failover``, ``serve_migrate`` and
``serve_respawn`` events.  The JAX engine's ``serve.aot.*`` counters have
no counterpart: the port compiles no programs, so there is no AOT cache
to count.  `stats` keeps the engine's own accounting, the telemetry
counters ``shed``, ``expired``, ``cancelled``, ``degraded``,
``block_waits``, ``preempted``, ``stalled`` and ``drained`` among its
keys.

Sampling is `sampling.sample_tokens`, request-keyed by (seed, position)
like the JAX engine; an iteration whose rows are all greedy takes the
argmax alone, which is the same result.  PyTorch runs eagerly, so
``warmup`` runs each bucket's program once (the kernels build and load,
cuBLAS initialises) instead of compiling it.

Speculative decoding (``spec=True`` or ``MXNET_SERVE_SPEC=1``, paged
only): a drafter (`spec.NgramDrafter` or `spec.ModelDrafter`,
``spec_drafter`` / ``MXNET_SERVE_SPEC_DRAFTER``) proposes ``spec_k``
tokens a row (``MXNET_SERVE_SPEC_K``, 4), one `verify_paged` pass scores
them, and the row keeps the drafts equal to the target's own
request-keyed picks and the target's next token, then gives back the
blocks past what it kept (`_rewind_blocks`).  The tokens are plain
decode's; only the number of launches a token changes.  With no real
draft in the batch a round runs the plain program (the megastep, when
that is on too).  Megastep decode (``megastep=True`` or
``MXNET_SERVE_MEGASTEP=1``, paged only) runs ``megastep_steps``
(``MXNET_SERVE_MEGASTEP_STEPS``, 4) decode steps in one round, with
per-row stop masks on the device and one fetch; the round's host sweep
(deadlines, prefill chunks, admission) runs while it executes, and the
fetch waits on a CUDA event behind a non-blocking copy into pinned
memory.  Where the JAX package runs the m steps (and a model drafter's
k+1 steps) as one `lax.scan` launch, the port enqueues them back to back
with no host sync between.  ``submit(on_token=fn)`` and
`ServeRequest.stream` deliver each token once, in order, after every
iteration; preemption and journal migration never re-deliver or skip
one.  Decode-loop clocks (``wall_s``, ``host_s``, ``hidden_s``,
``fetch_wait_s`` in `stats`) feed the ``serve.<name>.host_frac`` gauge.

What the JAX engine has beyond this waits for later slices: the host
tier and sessions, quantization, MoE, sharded replicas
(`ReplicaRouter.from_mesh`), disaggregated prefill and decode (router
roles and handoffs), the gateway and autoscaling, and tracing (the JAX
engine's `tracing.dump`, `tracing.phase` and `tracing.add_span` calls
have no counterpart here).  Their keywords are not accepted, and an
``MXNET_CHAOS`` spec with a clause of theirs raises at construction
(`chaos`).  A prompt token outside
[-V, V) embeds as NaN, as in the JAX engine, and its request decodes
token 0 (the first NaN's index) while the scheduler goes on.
"""
from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import chaos, telemetry
from ..base import MXNetError
from ..context import resolve
from .errors import (ServeBlocksExhausted, ServeCacheInvalidated,
                     ServeCancelled, ServeDeadlineExceeded, ServeEngineDead,
                     ServeError, ServeOverload, ServeQuarantined,
                     ServeTimeout)
from .journal import RequestJournal, journal_enabled
from .paged import TRASH_BLOCK, BlockAllocator, PrefixCache
from .sampling import argmax, sample_tokens
from .spec import make_drafter

__all__ = ["ServeRequest", "ServingEngine", "ReplicaRouter"]

_OVERLOAD_POLICIES = ("shed", "block", "degrade")
# the JAX engine's telemetry counters that the port keeps in `stats` too
_STATS_COUNTERS = frozenset(("shed", "expired", "cancelled", "degraded",
                             "block_waits", "preempted", "stalled",
                             "drained"))


def _env_flag(name, default="1"):
    return os.environ.get(name, default).lower() not in ("0", "false", "no")


class _EngineFatal(Exception):
    """A dead-device-scoped failure: the scheduler cannot go on, and
    `step` must not absorb it as one request's poison."""


class ServeRequest:
    """One generation request: prompt in, tokens out, latency stamps.

    Greedy unless ``temperature > 0``; then top-k / top-p filtering and a
    draw keyed by ``seed`` (default: the request id) and each token's
    absolute position, so batch composition and preemption never change
    what a request samples.  Once ``t_submit + deadline_ms`` passes, the
    scheduler retires the request at its next iteration with
    `ServeDeadlineExceeded`, queued or running; ``cancel()`` retires it
    the same way with `ServeCancelled`.  `stream` yields the tokens as
    the scheduler publishes them."""

    _ids = [0]
    _ids_lock = threading.Lock()

    def __init__(self, prompt, max_new_tokens, eos_id=None, deadline_ms=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=None):
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("ServeRequest: empty prompt")
        with self._ids_lock:
            self._ids[0] += 1
            self.id = self._ids[0]
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        if self.temperature < 0:
            raise MXNetError("ServeRequest: temperature must be >= 0")
        if self.top_k < 0:
            raise MXNetError("ServeRequest: top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise MXNetError("ServeRequest: top_p must be in (0, 1]")
        self.seed = (self.id if seed is None else int(seed)) & 0x7FFFFFFF
        self._resume = None       # after preemption: (ctx, last, pos, n_new)
        self.tokens = []          # generated ids (includes eos if hit)
        self.error = None
        self.t_submit = time.perf_counter()
        self.t_deadline = None if not deadline_ms \
            else self.t_submit + float(deadline_ms) / 1e3
        self.t_first = None       # first token sampled
        self.t_done = None
        self._done = threading.Event()
        self._cancelled = False
        self._requeues = 0        # cache-loss retries already burned
        self._waker = None        # set by the owning engine at enqueue
        self._preempt_n_new = None  # n_new at the last preemption: exempt
        #                           from another one until it advances
        #                           min_progress tokens past it
        self._migrated = False    # journal migration pending its replay
        # streaming: `stream()` iterators wait on this condition, and
        # `_published` is the scheduler's delivery mark into `tokens`.
        # No resume path truncates or re-appends `tokens`, so positions
        # below the mark are final and new ones only appear above it
        self._stream_cond = threading.Condition()
        self._published = 0
        self._on_token = None     # submit(on_token=...)'s callback

    @property
    def done(self):
        return self._done.is_set()

    def expired(self, now=None):
        return self.t_deadline is not None and \
            (time.perf_counter() if now is None else now) > self.t_deadline

    def cancel(self):
        """Ask the scheduler to retire this request at its next iteration
        (`ServeCancelled`).  Idempotent; a no-op once finished."""
        self._cancelled = True
        waker = self._waker
        if waker is not None:
            waker()

    def result(self, timeout=None):
        """Block until finished; returns the generated token list.  Raises
        `ServeTimeout` if the wait expires, or the request's own typed
        `ServeError` if it failed."""
        if not self._done.wait(timeout):
            raise ServeTimeout("ServeRequest %d: timed out after %ss"
                               % (self.id, timeout))
        if self.error is not None:
            err = self.error
            cls = err.__class__ if isinstance(err, ServeError) else MXNetError
            msg = str(err)
            tag = "ServeRequest %d" % self.id
            raise cls(msg if tag in msg else "%s: %s" % (tag, msg))
        return list(self.tokens)

    def stream(self, timeout=None):
        """Iterate the generated tokens as the scheduler publishes them:
        each once, in order, after every iteration that produced it (a
        megastep or a verify round may publish several at once).
        Preemption and journal migration replay context, never output,
        so the iterator neither repeats nor skips a token.  It ends when
        the request finishes; a failed request raises its typed error
        after yielding what was delivered.  ``timeout`` bounds each wait
        for the next token (`ServeTimeout`), not the whole stream.  Any
        number of iterators each get the whole stream."""
        cursor = 0
        while True:
            with self._stream_cond:
                while len(self.tokens) <= cursor and not self._done.is_set():
                    if not self._stream_cond.wait(timeout):
                        raise ServeTimeout(
                            "ServeRequest %d: stream timed out after %ss"
                            % (self.id, timeout))
                batch = list(self.tokens[cursor:])
            for t in batch:
                cursor += 1
                yield int(t)
            if self._done.is_set() and cursor >= len(self.tokens):
                if self.error is not None:
                    self.result(timeout=0.001)  # raises the typed error
                return

    def _publish(self):
        """The scheduler's delivery point: wake `stream` iterators and
        call ``on_token`` for the tokens appended since the last call.
        A consumer's exception never reaches the scheduler."""
        with self._stream_cond:
            n = len(self.tokens)
            if n <= self._published:
                return
            lo, self._published = self._published, n
            self._stream_cond.notify_all()
        cb = self._on_token
        if cb is not None:
            for t in self.tokens[lo:n]:
                try:
                    cb(int(t))
                except Exception:  # noqa: BLE001 -- a consumer's bug
                    pass

    @property
    def ttft_ms(self):
        return None if self.t_first is None else \
            1e3 * (self.t_first - self.t_submit)

    @property
    def latency_ms(self):
        return None if self.t_done is None else \
            1e3 * (self.t_done - self.t_submit)

    def _finish(self, error=None):
        """Resolve the request, once: every retire, shed, cancel, deadline
        and engine death funnels through here."""
        if self._done.is_set():
            return
        # deliver first: the retiring iteration may have appended a last
        # token not yet published
        self._publish()
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()
        with self._stream_cond:
            self._stream_cond.notify_all()


class _Seq:
    """An active sequence: ``last`` is fed (and cached) at ``pos`` on the
    next decode step.  Paged only: ``blocks`` is its block list and
    ``ctx`` the tokens cached at rows [0, pos), what prefix registration
    and a preemption's replay read."""

    __slots__ = ("req", "last", "pos", "n_new", "blocks", "ctx")

    def __init__(self, req, last, pos, blocks=None, ctx=None):
        self.req = req
        self.last = last
        self.pos = pos
        self.n_new = 1  # the prefill already sampled token #1
        self.blocks = blocks
        self.ctx = ctx


class _Prefill:
    """A paged admission mid-stream: ``tokens`` must be cached before
    decode starts (the prompt, or after a preemption the replayed
    context), ``done`` of them are (a prefix hit starts it past the
    cached prefix); ``resume`` is (last, pos, n_new)."""

    __slots__ = ("req", "row", "tokens", "done", "blocks", "resume")

    def __init__(self, req, row, tokens, blocks, resume=None):
        self.req = req
        self.row = row
        self.tokens = tokens
        self.done = 0
        self.blocks = blocks
        self.resume = resume


class ServingEngine:
    """Single-replica continuous batcher over one device.

    model:  `TransformerKVModel`.
    params: ``{name: tensor}`` (moved to ``ctx``) or a JAX parameter dict
            of numpy arrays (carried across by `params_from_jax`).
    ctx:    the device, ``cuda:0`` by default; ``"cpu"`` runs the plain
            versions of the kernels.
    The other keywords and their defaults are the JAX engine's.  Those of
    the request contract and the prefix cache, left at None, read the
    JAX engine's pins: ``MXNET_SERVE_QUEUE_MAX`` (0, unbounded),
    ``MXNET_SERVE_OVERLOAD`` (shed), ``MXNET_SERVE_DEADLINE_MS`` (0,
    none), ``MXNET_SERVE_PREFIX`` (on, with paging),
    ``MXNET_SERVE_PREFIX_POOL`` (-1, no cap), ``MXNET_SERVE_MIN_PROGRESS``
    (4) and ``MXNET_SERVE_THRASH_TRIP`` (8; 0 never trips).
    ``MXNET_SERVE_LAUNCH_RETRIES`` (3) bounds the consecutive scoped
    decode failures before the engine dies.  Speculative and megastep
    decoding, left at None, read ``MXNET_SERVE_SPEC`` (off),
    ``MXNET_SERVE_SPEC_K`` (4), ``MXNET_SERVE_SPEC_DRAFTER`` (ngram),
    ``MXNET_SERVE_MEGASTEP`` (off) and ``MXNET_SERVE_MEGASTEP_STEPS`` (4);
    both need the paged cache.
    """

    def __init__(self, model, params, ctx=None, max_batch=8,
                 decode_buckets=None, prefill_buckets=None,
                 max_new_tokens=32, eos_id=None, paged=True, block_size=None,
                 n_blocks=None, chunk_prefill=True, sampling=True,
                 name="replica0", queue_max=None, overload=None,
                 deadline_ms=None, prefix=None, prefix_pool=None,
                 spec=None, spec_k=None, spec_drafter=None,
                 min_progress=None, thrash_trip=None, megastep=None,
                 megastep_steps=None):
        chaos.spec()  # a clause the port cannot inject raises here
        self.model = model
        self.name = name
        self.device = resolve(ctx)
        if all(isinstance(v, torch.Tensor) for v in params.values()):
            model.check_params(params)
            self._params = {k: v.to(self.device) for k, v in params.items()}
        else:
            self._params = model.params_from_jax(params, self.device)
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise MXNetError("ServingEngine: max_batch must be >= 1")
        decode_src = decode_buckets or _default_decode_buckets(self.max_batch)
        bad = sorted({int(b) for b in decode_src if b > self.max_batch})
        if bad:
            raise MXNetError("ServingEngine: decode buckets %s exceed "
                             "max_batch %d" % (bad, self.max_batch))
        self.decode_buckets = sorted({int(b) for b in decode_src}
                                     | {self.max_batch})
        prefill_src = prefill_buckets or \
            _default_prefill_buckets(model.seq_len)
        bad = sorted({int(s) for s in prefill_src if s > model.seq_len})
        if bad:
            raise MXNetError("ServingEngine: prefill buckets %s exceed "
                             "seq_len %d" % (bad, model.seq_len))
        self.prefill_buckets = sorted({int(s) for s in prefill_src})
        self.max_new_default = int(max_new_tokens)
        if self.max_new_default < 1:
            raise MXNetError("ServingEngine: max_new_tokens must be >= 1")
        self.eos_id = eos_id
        # admission control (0 = unbounded queue, policy moot)
        self._queue_max = int(os.environ.get("MXNET_SERVE_QUEUE_MAX", "0")
                              if queue_max is None else queue_max)
        self._overload = str(os.environ.get("MXNET_SERVE_OVERLOAD", "shed")
                             if overload is None else overload).lower()
        if self._overload not in _OVERLOAD_POLICIES:
            raise MXNetError("ServingEngine: overload policy %r not in %s"
                             % (self._overload, _OVERLOAD_POLICIES))
        dl = float(os.environ.get("MXNET_SERVE_DEADLINE_MS", "0")
                   if deadline_ms is None else deadline_ms)
        self._deadline_ms_default = dl if dl > 0 else None
        self._launch_retries = max(1, int(os.environ.get(
            "MXNET_SERVE_LAUNCH_RETRIES", "3")))
        self._paged = bool(paged)
        self._sampling = bool(sampling)
        self._prefix = None
        self._prefix_pool = -1
        if self._paged:
            self._chunk_prefill = bool(chunk_prefill)
            bs = 0 if block_size is None else int(block_size)
            if bs < 0:
                raise MXNetError("ServingEngine: block_size must be >= 1")
            if bs == 0:
                # auto: the largest divisor of every prefill bucket, at
                # most 16 (the JAX engine's rule)
                g = 0
                for s in self.prefill_buckets:
                    g = math.gcd(g, s)
                bs = max(d for d in range(1, min(16, g) + 1) if g % d == 0)
            bad = [s for s in self.prefill_buckets if s % bs]
            if bad:
                raise MXNetError(
                    "ServingEngine: block_size %d must divide every prefill "
                    "bucket (violated by %s)" % (bs, bad))
            self.block_size = bs
            self._n_table = -(-model.seq_len // bs)
            nb = 0 if n_blocks is None else int(n_blocks)
            if nb == 0:
                # the slot cache's rows (max_batch + 1 trash), in blocks
                nb = (self.max_batch + 1) * self._n_table
            self.n_blocks = nb
            self._alloc = BlockAllocator(nb, bs)
            self._cache = model.init_block_pool(nb, bs, device=self.device)
            # cross-request prefix sharing; the parked pool's cap, < 0 =
            # bounded only by allocation pressure
            self._prefix_pool = int(
                os.environ.get("MXNET_SERVE_PREFIX_POOL", "-1")
                if prefix_pool is None else prefix_pool)
            if _env_flag("MXNET_SERVE_PREFIX") if prefix is None \
                    else bool(prefix):
                self._prefix = PrefixCache(bs, self._prefix_pool)
        else:
            self._chunk_prefill = False
            self.block_size = None
            self.n_blocks = None
            self._alloc = None
            # slot max_batch is the trash slot padding rows write into
            self._cache = model.init_cache(self.max_batch + 1,
                                           device=self.device)
        # speculative decoding (off by default)
        self._spec = _env_flag("MXNET_SERVE_SPEC", "0") if spec is None \
            else bool(spec)
        self._spec_k = int(os.environ.get("MXNET_SERVE_SPEC_K", "4")
                           if spec_k is None else spec_k)
        self._drafter_arg = spec_drafter
        self._drafter = None
        if self._spec:
            if not self._paged:
                raise MXNetError(
                    "ServingEngine: speculative decoding needs the paged "
                    "cache (MXNET_SERVE_SPEC=1 with paged=False)")
            if self._spec_k < 1:
                raise MXNetError("ServingEngine: MXNET_SERVE_SPEC_K must "
                                 "be >= 1, got %d" % self._spec_k)
        # megastep decode (off by default): m decode steps a launch round,
        # finished rows parked on the trash block, which only paging has
        mega_on = _env_flag("MXNET_SERVE_MEGASTEP", "0") if megastep \
            is None else bool(megastep)
        self._mega_m = 0
        if mega_on:
            if not self._paged:
                raise MXNetError(
                    "ServingEngine: megastep decode needs the paged cache "
                    "(MXNET_SERVE_MEGASTEP=1 with paged=False): a finished "
                    "row runs on at the trash block, which only the paged "
                    "cache has")
            self._mega_m = int(
                os.environ.get("MXNET_SERVE_MEGASTEP_STEPS", "4")
                if megastep_steps is None else megastep_steps)
            if self._mega_m < 1:
                raise MXNetError(
                    "ServingEngine: MXNET_SERVE_MEGASTEP_STEPS must be "
                    ">= 1, got %d" % self._mega_m)
        # the per-replica telemetry names: engines share one registry
        self._gauge = "serve.%s." % self.name
        self._queue = deque()
        self._qlock = threading.Lock()
        self._qcond = threading.Condition(self._qlock)
        self._admitting = 0       # popped off _queue, admission in flight
        self._active = {}         # row -> _Seq (insertion-ordered)
        self._prefilling = {}     # row -> _Prefill (paged only)
        self._free = list(range(self.max_batch))
        self._stopped = threading.Event()
        self._draining = False    # drain(): admission closed
        self._wake = threading.Event()  # set by submit: work arrived
        self._thread = None
        self._dead = None         # scheduler-fatal error message, if any
        self._on_death = None     # router failover hook:
        #                           fn(engine, pending, inflight, msg)
        self._launch_fails = 0    # consecutive decode launch failures
        self.last_beat = time.monotonic()  # scheduler heartbeat
        # anti-thrash preemption: a resumed sequence is exempt from another
        # preemption until it advances min_progress tokens (0 = preempt on
        # every denial), the oldest in-flight request is never a victim,
        # and thrash_trip preemptions without a completion cap admissions
        # (0 = never trip)
        self._min_progress = int(
            os.environ.get("MXNET_SERVE_MIN_PROGRESS", "4")
            if min_progress is None else min_progress)
        self._thrash_trip = int(
            os.environ.get("MXNET_SERVE_THRASH_TRIP", "8")
            if thrash_trip is None else thrash_trip)
        self._stalled = set()     # rows sitting out this decode step
        self._preempts_since_retire = 0
        self._storm = False       # preemption storm: degrade admissions
        self._count_lock = threading.Lock()
        self.stats = {"decode_steps": 0, "decode_rows": 0,
                      "decode_padded": 0, "prefills": 0, "completed": 0,
                      "tokens": 0, "prefill_chunks": 0, "prefill_tokens": 0,
                      "preemptions": 0, "alloc_denied": 0,
                      "max_concurrent": 0,
                      "blocks_free_min": (self._alloc.free_blocks
                                          if self._paged else None),
                      # prefix caching (0s when off)
                      "prefix_hits": 0, "prefix_tokens": 0,
                      "prefix_lookup_tokens": 0, "prefix_bootstraps": 0,
                      "cow_copies": 0, "prefix_evictions": 0,
                      # anti-thrash, and migrated requests replayed here
                      "stalls": 0, "thrash_trips": 0, "replays": 0,
                      # speculative decoding (0s when off)
                      "verify_steps": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_rollbacks": 0,
                      "spec_junk_rounds": 0,
                      # megastep decode (0s when off) and the decode
                      # loop's clocks: hidden_s spans launch to fetch
                      # complete, host_s the rest of a decoding
                      # iteration's wall (host work no launch hid)
                      "megasteps": 0, "megastep_tokens": 0,
                      "ingraph_retired": 0, "wall_s": 0.0, "host_s": 0.0,
                      "hidden_s": 0.0, "fetch_wait_s": 0.0,
                      # the JAX engine's telemetry counters
                      "shed": 0, "expired": 0, "cancelled": 0,
                      "degraded": 0, "block_waits": 0, "preempted": 0,
                      "stalled": 0, "drained": 0}
        if self._spec:
            self._drafter = make_drafter(
                os.environ.get("MXNET_SERVE_SPEC_DRAFTER", "ngram")
                if spec_drafter is None else spec_drafter)
            self._drafter.bind(self)

    # -- device staging ----------------------------------------------------
    def _put(self, a):
        """``a`` on the engine's device.  To a card the copy goes through
        pinned memory without a host sync, so staging never waits for
        the launches already queued (a megastep in flight)."""
        if self.device.type != "cuda":
            return torch.as_tensor(a, device=self.device)
        return torch.as_tensor(a).pin_memory().to(self.device,
                                                  non_blocking=True)

    def _samp_device(self, reqs, b):
        """The sampling tensors (temperature, top_k, top_p, seed) of
        ``reqs`` padded to ``b`` greedy rows, on the device; () when
        every row is greedy (the argmax alone is the same result)."""
        if not (self._sampling and any(r.temperature > 0 for r in reqs)):
            return ()
        temp = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int64)
        top_p = np.ones((b,), np.float32)
        seed = np.zeros((b,), np.int64)
        for i, r in enumerate(reqs):
            temp[i], top_k[i], top_p[i], seed[i] = (r.temperature, r.top_k,
                                                    r.top_p, r.seed)
        return tuple(self._put(a) for a in (temp, top_k, top_p, seed))

    def _pick_dev(self, logits, samp, newpos):
        """Token ids of (b, V) ``logits`` on the device, no host sync:
        argmax, or `sample_tokens` with ``samp`` at the (b,) positions
        ``newpos`` the tokens will occupy."""
        if not samp:
            return argmax(logits)
        return sample_tokens(logits, *samp, newpos)

    def _pick(self, logits, reqs, newpos):
        """Host token ids for the first len(reqs) rows of ``logits``
        (`_pick_dev`, then one fetch)."""
        n = len(reqs)
        samp = self._samp_device(reqs, n)
        pos = self._put(np.asarray(newpos, np.int64)) if samp else None
        return self._pick_dev(logits[:n], samp, pos).tolist()

    # -- programs ----------------------------------------------------------
    def _table(self, rows, blocks):
        tables = np.full((rows, self._n_table), TRASH_BLOCK, np.int64)
        for i, bl in enumerate(blocks):
            tables[i, :len(bl)] = bl
        return self._put(tables)

    def _slot_inputs(self, tokens, slot):
        """The slot-cache prefill's operands on the device: ``tokens``
        right-padded to their bucket, their length, ``slot``."""
        s = self._bucket_for(len(tokens), self.prefill_buckets)
        toks = np.zeros((1, s), np.int64)
        toks[0, :len(tokens)] = tokens
        return (self._put(toks), self._put(np.array([len(tokens)], np.int64)),
                self._put(np.array([slot], np.int64)))

    def _prefill_slot(self, toks, length, slot):
        """The slot-cache prefill program: forward, write the K/V into
        ``slot``, return the last real token's logits."""
        logits, kv = self.model.prefill(self._params, toks, length)
        self.model.write_prefill(self._cache, kv, length, slot)
        return logits

    def _chunk_inputs(self, chunk, bucket, start, blocks):
        """One paged prefill chunk's operands on the device."""
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(chunk)] = chunk
        return (self._put(toks), self._put(np.array([start], np.int64)),
                self._put(np.array([len(chunk)], np.int64)),
                self._table(1, [blocks]))

    def _prefill_chunk(self, toks, start, length, table):
        """The paged prefill program over one chunk."""
        logits, _ = self.model.prefill_paged(self._params, self._cache, toks,
                                             start, length, table)
        return logits

    def _decode_inputs(self, b, seqs, slots):
        """The decode program's operands for bucket ``b`` (rows past
        len(seqs) are padding on the trash slot / trash block)."""
        token = np.zeros((b,), np.int64)
        pos = np.zeros((b,), np.int64)
        for i, seq in enumerate(seqs):
            token[i] = seq.last
            pos[i] = seq.pos
        if self._paged:
            where = self._table(b, [s.blocks for s in seqs])
        else:
            slot_ids = np.full((b,), self.max_batch, np.int64)
            slot_ids[:len(slots)] = slots
            where = self._put(slot_ids)
        return self._put(token), self._put(pos), where

    def _decode(self, token, pos, where):
        """The decode program: block tables ``where`` on the paged cache,
        slot ids on the slot cache."""
        program = self.model.decode_paged if self._paged \
            else self.model.decode
        logits, _ = program(self._params, self._cache, token, pos, where)
        return logits

    def _verify(self, tokens, pos, length, tables, samp):
        """The verify program: score a draft run (`verify_paged`), pick
        the target's token at every fed position (column j's token will
        occupy pos + j + 1, the key sequential decode would have used)
        and count the leading drafts equal to those picks.  Returns (b,
        c + 1) on the device: the picks, then the count."""
        logits, _ = self.model.verify_paged(self._params, self._cache,
                                            tokens, pos, length, tables)
        b, c, v = logits.shape
        newpos = pos.long()[:, None] + 1 + \
            torch.arange(c, device=logits.device)[None, :]
        samp_c = tuple(a.repeat_interleave(c) for a in samp)
        picked = self._pick_dev(logits.reshape(b * c, v), samp_c,
                                newpos.reshape(-1)).reshape(b, c)
        match = (picked[:, :-1] == tokens[:, 1:].long()).long()
        acc = torch.cumprod(match, dim=1).sum(dim=1)
        return torch.cat([picked, acc[:, None]], dim=1)

    def _megastep(self, token, pos, left, eos, tables, samp):
        """The megastep program: ``_mega_m`` decode steps enqueued back to
        back (`decode_megastep`); returns the (b, m) token grid on the
        device."""
        toks, _ = self.model.decode_megastep(
            self._params, self._cache, token, pos, left, eos, tables,
            self._mega_m, lambda logits, newpos: self._pick_dev(
                logits, samp, newpos))
        return toks

    def _to_host(self, t):
        """Start ``t``'s copy to the host: (pinned host tensor, CUDA
        event) on a card, (t, None) on the CPU.  `_fetch` waits."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        return host, done

    @staticmethod
    def _fetch(host, done):
        """`_to_host`'s result as numpy, once its copy has landed."""
        if done is not None:
            done.synchronize()
        return host.numpy()

    def warmup(self):
        """Run every bucket's program once against the trash slot / trash
        block (and, with the prefix cache, the block copy; with
        speculation the verify and the drafter's programs; with megastep
        the megastep), so kernels build and load, and libraries
        initialise, before the first request."""
        for s in self.prefill_buckets:
            if self._paged:
                logits = self._prefill_chunk(
                    *self._chunk_inputs([0], s, 0, []))
            else:
                logits = self._prefill_slot(
                    *self._slot_inputs([0], self.max_batch))
            logits.argmax(dim=-1).tolist()
        for b in self.decode_buckets:
            self._decode(*self._decode_inputs(b, [], [])).argmax(
                dim=-1).tolist()
        if self._sampling:
            one = self._put(np.ones((1,), np.float32))
            zero = self._put(np.zeros((1,), np.int64))
            sample_tokens(torch.zeros((1, self.model.vocab_size),
                                      device=self.device),
                          one, zero, one, zero, zero).tolist()
        if self._spec:
            c = self._spec_k + 1
            for b in self.decode_buckets:
                _, pos, tables = self._decode_inputs(b, [], [])
                self._verify(self._put(np.zeros((b, c), np.int64)), pos,
                             self._put(np.ones((b,), np.int64)), tables,
                             ()).tolist()
            self._drafter.warmup()
        if self._mega_m:
            for b in self.decode_buckets:
                token, pos, tables = self._decode_inputs(b, [], [])
                self._megastep(token, pos, pos, pos - 1, tables, ()).tolist()
        if self._prefix is not None:
            self.model.copy_block(self._cache, TRASH_BLOCK, TRASH_BLOCK)
        return {"prefill": list(self.prefill_buckets),
                "decode": list(self.decode_buckets),
                "cache": "paged" if self._paged else "slot",
                "block_size": self.block_size, "n_blocks": self.n_blocks,
                "prefix": self._prefix is not None,
                "spec": None if not self._spec else
                {"k": self._spec_k, "drafter": self._drafter.name},
                "megastep": None if not self._mega_m else
                {"m": self._mega_m}}

    def respawn(self, name=None):
        """A replacement engine for this (dead) replica: the same device,
        geometry, name and admission settings, the parameters shared (no
        copy), a fresh K/V cache and scheduler state.  ``name`` names a
        new replica templated off this one instead."""
        return ServingEngine(
            self.model, self._params, ctx=self.device,
            max_batch=self.max_batch,
            decode_buckets=list(self.decode_buckets),
            prefill_buckets=list(self.prefill_buckets),
            max_new_tokens=self.max_new_default, eos_id=self.eos_id,
            paged=self._paged, block_size=self.block_size,
            n_blocks=self.n_blocks, chunk_prefill=self._chunk_prefill,
            sampling=self._sampling,
            name=self.name if name is None else name,
            queue_max=self._queue_max, overload=self._overload,
            deadline_ms=self._deadline_ms_default,
            prefix=self._prefix is not None, prefix_pool=self._prefix_pool,
            spec=self._spec, spec_k=self._spec_k,
            spec_drafter=self._drafter_arg if self._drafter_arg is not None
            else (self._drafter.name if self._drafter is not None
                  else None),
            min_progress=self._min_progress, thrash_trip=self._thrash_trip,
            megastep=bool(self._mega_m),
            megastep_steps=self._mega_m or None)

    # -- submission and admission control ----------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, temperature=0.0, top_k=0, top_p=1.0,
               seed=None, on_token=None, _count_shed=True):
        """Queue a request; returns its `ServeRequest`.  ``on_token(t)``,
        if given, is called on the scheduler's thread with each generated
        token, once, in order."""
        if max_new_tokens is None:
            max_new_tokens = self.max_new_default
        elif int(max_new_tokens) < 1:
            raise MXNetError("ServingEngine: max_new_tokens must be >= 1, "
                             "got %s" % max_new_tokens)
        if deadline_ms is None:
            deadline_ms = self._deadline_ms_default
        if temperature and not self._sampling:
            raise MXNetError("ServingEngine: sampling is disabled "
                             "(sampling=False) — temperature > 0 unsupported")
        req = ServeRequest(prompt, max_new_tokens,
                           self.eos_id if eos_id is None else eos_id,
                           deadline_ms=deadline_ms, temperature=temperature,
                           top_k=top_k, top_p=top_p, seed=seed)
        req._on_token = on_token
        if not (self._paged and self._chunk_prefill) and \
                len(req.prompt) > self.prefill_buckets[-1]:
            raise MXNetError(
                "ServingEngine: prompt length %d exceeds the largest "
                "prefill bucket %d" % (len(req.prompt),
                                       self.prefill_buckets[-1]))
        if len(req.prompt) >= self.model.seq_len:
            raise MXNetError(
                "ServingEngine: prompt length %d leaves no room to "
                "generate (seq_len %d)" % (len(req.prompt),
                                           self.model.seq_len))
        if self._paged:
            # a worst case past the whole pool could only end in a
            # preemption livelock: refuse it at the door
            worst = min(len(req.prompt) + req.max_new_tokens,
                        self.model.seq_len)
            need = self._alloc.blocks_for(worst)
            if need > self._alloc.capacity:
                telemetry.inc("serve.blocks_rejected")
                raise ServeBlocksExhausted(
                    "ServingEngine %s: request needs up to %d cache blocks "
                    "but the pool only has %d usable (n_blocks=%d, "
                    "block_size=%d)" % (self.name, need, self._alloc.capacity,
                                        self.n_blocks, self.block_size))
        telemetry.inc("serve.sampled_requests" if req.temperature > 0
                      else "serve.greedy_requests")
        if self._queue_max > 0 and self._overload == "block":
            self._enqueue_blocking(req)
        else:
            self._enqueue(req, count_shed_global=_count_shed)
        # counted at the submit door only: failover re-dispatch and chaos
        # floods reuse _enqueue but are not new offered requests
        telemetry.inc("serve.requests")
        return req

    def _count(self, what, n=1):
        """Bump the telemetry counter ``serve.<what>`` and its per-replica
        ``serve.<name>.<what>``, and the `stats` key of the same name
        where the port keeps one; the submitting thread and the scheduler
        can both call it."""
        telemetry.inc("serve.%s" % what, n)
        telemetry.inc(self._gauge + what, n)
        if what in _STATS_COUNTERS:
            with self._count_lock:
                self.stats[what] += n

    def _admission_shed(self, depth, count_global=True):
        """Overload decision for one enqueue at queue depth ``depth``:
        a degrade cap on max_new_tokens, None, or `ServeOverload` raised.
        Called under `_qlock`.  ``count_global=False`` (a router's
        dispatch and redispatch, which try other replicas) counts only
        the per-replica shed: ``serve.shed`` counts requests finally
        refused."""
        if self._queue_max <= 0 or depth < self._queue_max:
            return None
        if self._overload == "degrade" and depth < 4 * self._queue_max:
            # cap generation length under pressure instead of shedding;
            # the 4x backstop bounds the queue even under a flood
            return max(1, self.max_new_default // 4)
        with self._count_lock:
            self.stats["shed"] += 1
        telemetry.inc(self._gauge + "shed")
        if count_global:
            telemetry.inc("serve.shed")
        raise ServeOverload(
            "ServingEngine %s: queue full (%d >= %d, policy %s)"
            % (self.name, depth, self._queue_max, self._overload))

    def _check_alive_locked(self):
        """Raise `ServeEngineDead` on a dead, draining or stopped engine.
        Runs under `_qlock`, the lock `_die`/`stop` drain the queue under,
        so no request slips in after the drain and hangs."""
        if self._dead is not None:
            raise ServeEngineDead("ServingEngine %s: scheduler died: %s"
                                  % (self.name, self._dead))
        if self._draining:
            raise ServeEngineDead("ServingEngine %s: draining for restart"
                                  % self.name)
        if self._stopped.is_set():
            raise ServeEngineDead("ServingEngine %s: engine stopped"
                                  % self.name)

    def _post_enqueue(self, req, depth):
        req._waker = self._wake.set
        self._wake.set()
        telemetry.set_gauge(self._gauge + "queue_depth", depth)
        return req

    def _enqueue(self, req, count_shed_global=True):
        """Admission under the shed and degrade policies (also a router's
        failover redispatch and the chaos flood, which must never block a
        scheduler thread)."""
        with self._qlock:
            self._check_alive_locked()
            cap = self._admission_shed(len(self._queue),
                                       count_global=count_shed_global)
            if cap is None and self._storm:
                # preemption storm: admit new work at the degrade cap, so
                # shorter answers shrink the churning footprint
                cap = max(1, self.max_new_default // 4)
            if cap is not None and req.max_new_tokens > cap \
                    and req._resume is None and not req._migrated:
                # never degrade a resumed or migrated request: its output
                # is already promised, and a cap would cut its replay
                # short
                req.max_new_tokens = cap
                self._count("degraded")
            self._queue.append(req)
            depth = len(self._queue)
        return self._post_enqueue(req, depth)

    def _enqueue_blocking(self, req):
        """`block` policy: wait for queue room, bounded by the request's
        own deadline (unbounded without one) and by `cancel()`; both
        resolve the wait typed."""
        waited = False
        with self._qcond:
            while True:
                self._check_alive_locked()
                if req._cancelled:
                    self._count("cancelled")
                    raise ServeCancelled(
                        "ServeRequest %d: cancelled while blocked at "
                        "admission (%s queue full)" % (req.id, self.name))
                if req.expired():
                    self._count("expired")
                    raise ServeDeadlineExceeded(
                        "ServeRequest %d: deadline passed while blocked at "
                        "admission (%s queue full)" % (req.id, self.name))
                if len(self._queue) < self._queue_max:
                    self._queue.append(req)
                    depth = len(self._queue)
                    break
                waited = True
                self._qcond.wait(0.05)
        if waited:
            self._count("block_waits")
        return self._post_enqueue(req, depth)

    def depth(self):
        """Queued + mid-admission + prefilling + running requests."""
        with self._qlock:
            return len(self._queue) + self._admitting + \
                len(self._prefilling) + len(self._active)

    # -- scheduling --------------------------------------------------------
    def _bucket_for(self, n, buckets):
        for b in buckets:
            if b >= n:
                return b
        raise MXNetError("ServingEngine %s: no bucket >= %d in %s"
                         % (self.name, n, buckets))

    # -- failure scoping ---------------------------------------------------
    def _cache_lost(self):
        return self.model.cache_lost(self._cache)

    def _classify_failure(self, exc):
        """Scope of a failed launch:

        * ``device``: the card itself is gone (or chaos says so):
          scheduler-fatal, the router fails over.  In the port this
          includes any ``CUDA error:`` but out of memory (an illegal
          address, a launch failure, a device-side assert), after which
          the CUDA context is unusable.
        * ``cache``: the program raised after its first in-place write
          (the model's write mark): every admitted sequence lost its
          context, but the engine rebuilds the cache and keeps serving
          its queue.
        * ``scoped``: the cache is untouched, so the fault is local to the
          launch (a poisoned request at prefill, a transient error at
          decode)."""
        if isinstance(exc, chaos.ChaosEngineCrash):
            return "device"
        if self._cache_lost():
            return "cache"
        msg = str(exc).lower()
        # allocation pressure names the device but the device is healthy:
        # a scoped retry (a respawn would allocate another whole cache
        # into the same pressure)
        if isinstance(exc, torch.cuda.OutOfMemoryError) or any(
                k in msg for k in ("resource_exhausted", "out of memory",
                                   "oom")):
            return "scoped"
        if "cuda error:" in msg:
            return "device"
        # \bdead\b: "dead device" yes, a transient DEADLINE_EXCEEDED no
        if any(k in msg for k in ("device", "data_loss", "disconnected")) \
                or re.search(r"\bdead\b", msg):
            return "device"
        return "scoped"

    def _quarantine(self, req, msg):
        """Fail one poisoned request with `ServeQuarantined`; the batch
        keeps decoding and the scheduler stays up."""
        self._count("quarantined")
        telemetry.record_event("serve_quarantine", replica=self.name,
                               request=req.id, error=msg[:200])
        req._finish(error=ServeQuarantined(msg[:500]))

    def _requeue_once(self, req, what, reason):
        """A request whose cached context died with the cache: back to
        the queue front for one retry against the fresh cache, then
        quarantined."""
        if req._requeues < 1:
            req._requeues += 1
            with self._qlock:
                self._queue.appendleft(req)
        else:
            self._quarantine(req, what % reason[:200])

    def _rebuild_cache(self, reason):
        """A failed launch left the cache half-written: every admitted
        sequence lost its context (`ServeCacheInvalidated`), the cache is
        reallocated, and the engine keeps serving its queue.  Paged, the
        pool and every block table go: the allocator resets, the prefix
        index clears, and mid-prefill requests requeue for one retry
        against the fresh pool."""
        err = ServeCacheInvalidated(
            "ServingEngine %s: K/V cache invalidated (%s)"
            % (self.name, reason[:300]))
        for row, seq in list(self._active.items()):
            seq.blocks = None  # the pool they pointed into is gone
            self._retire_error(row, seq, err)
        if self._paged:
            for row, pf in list(self._prefilling.items()):
                del self._prefilling[row]
                self._free.append(row)
                pf.blocks = None
                self._requeue_once(pf.req, "prefill lost to a cache rebuild "
                                   "twice: %s", reason)
            if self._prefix is not None:
                self._prefix.clear()  # the pool its nodes point at is gone
            self._alloc.reset()
            self._cache = self.model.init_block_pool(
                self.n_blocks, self.block_size, device=self.device)
            if self._drafter is not None:
                self._drafter.on_cache_rebuild()
            self._block_gauges()
        else:
            self._cache = self.model.init_cache(self.max_batch + 1,
                                                device=self.device)
        self._count("cache_rebuilds")
        telemetry.record_event("serve_cache_rebuild", replica=self.name,
                               reason=reason[:200])

    def _launch_failed(self, e, req, cleanup):
        """The prefill failure ladder of a launch that raised: a dead
        device fails the request and raises `_EngineFatal`; a lost cache
        rebuilds it (the request requeues with the other mid-prefill
        ones, or, on the slot path, here); anything else quarantines the
        request.  ``cleanup`` returns the request's row (and blocks)."""
        kind = self._classify_failure(e)
        if kind == "device":
            cleanup()
            req._finish(error=ServeEngineDead(
                "prefill launch failed: %s" % str(e)[:400]))
            raise _EngineFatal("prefill launch failed: %s" % e) from e
        if kind == "cache":
            if not self._paged:
                cleanup()
            self._rebuild_cache("prefill launch failed: %s" % e)
            if not self._paged:
                # this request's prefill was lost with the cache: one
                # retry against the fresh one, then quarantine
                self._requeue_once(req, "prefill launch failed twice "
                                   "across a cache rebuild: %s", str(e))
            return
        cleanup()
        self._quarantine(req, "prefill launch failed: %s" % e)

    def _admit_one(self, req):
        """Admit one queued request.  Returns False only when a paged
        block allocation was denied (the request went back to the queue
        front: stop admitting this iteration)."""
        if self._paged:
            return self._admit_one_paged(req)
        slot = self._free.pop()
        plen = len(req.prompt)
        try:
            inputs = self._slot_inputs(req.prompt, slot)
            if chaos.serve_launch_error():
                raise chaos.ChaosError("chaos: injected prefill launch "
                                       "error")
        except Exception as e:  # noqa: BLE001 -- nothing launched
            self._free.append(slot)
            self._quarantine(req, "prefill setup failed: %s" % e)
            return True
        try:
            logits = self._prefill_slot(*inputs)
            first = self._pick(logits, [req], [plen])[0]
        except Exception as e:  # noqa: BLE001 -- scoped in _launch_failed
            self._launch_failed(e, req, lambda: self._free.append(slot))
            return True
        telemetry.observe("serve.queue_age_ms",
                          1e3 * (time.perf_counter() - req.t_submit))
        req.t_first = time.perf_counter()
        req.tokens.append(first)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += plen
        self.stats["tokens"] += 1
        telemetry.inc("serve.prefills")
        telemetry.inc("serve.tokens")
        seq = _Seq(req, first, plen)
        if self._seq_finished(seq, first):
            self._retire(slot, seq, enter=False)
        else:
            self._active[slot] = seq
        req._publish()
        return True

    # -- block lifetime ----------------------------------------------------
    def _release_blocks(self, holder):
        """Drop a sequence's or prefill's block refs exactly once: every
        path by which a holder leaves the cache funnels through here."""
        if self._paged and holder.blocks is not None:
            self._drop_refs(holder.blocks)
            holder.blocks = None
            self._block_gauges()

    def _drop_refs(self, blocks):
        """Release; a block whose count reaches 0 parks if the prefix
        index registered it and goes back to the free list otherwise.
        The one refcount-drop site, so a double drop raises in the
        allocator."""
        for b in self._alloc.release(blocks):
            parked = None if self._prefix is None else self._prefix.park(b)
            if parked is None:
                self._alloc.reclaim([b])
            elif parked:
                # the prefix_pool cap evicted the LRU tail
                self._alloc.reclaim(parked)
                self._count_evictions(len(parked))

    def _count_evictions(self, n):
        self.stats["prefix_evictions"] += n
        self._count("prefix_evictions", n)

    def _alloc_blocks(self, n):
        """`BlockAllocator.alloc`, evicting parked prefix blocks LRU-first
        when the free list alone cannot serve; None when live blocks fill
        the pool, or when the allocator refused with enough free blocks
        on hand (then the cache is kept)."""
        got = self._alloc.alloc(n)
        if got is not None or self._prefix is None:
            return got
        if self._alloc.can_serve(n):
            return None
        evicted = self._prefix.evict(n - self._alloc.free_blocks)
        if not evicted:
            return None
        self._alloc.reclaim(evicted)
        self._count_evictions(len(evicted))
        return self._alloc.alloc(n)

    def leaked_blocks(self):
        """Blocks neither free, nor held by a live sequence, nor parked
        in the prefix pool: 0 after any drain."""
        if not self._paged:
            return 0
        parked = 0 if self._prefix is None else self._prefix.parked_count
        return self._alloc.capacity - self._alloc.free_blocks - \
            self._alloc.used_blocks - parked

    def _register_prefix(self, tokens, blocks, n_tokens):
        """Register a sequence's full blocks in the prefix index, eagerly:
        a concurrent request may share them while the writer still
        decodes (copy-on-write guards the block it writes)."""
        if self._prefix is not None:
            self._prefix.insert(tokens, blocks,
                                int(n_tokens) // self.block_size)

    def _block_gauges(self, full=False):
        """The pool gauges at every allocator touch, as the JAX engine's:
        the ``blocks_free_min`` low-water mark, ``serve.<name>.blocks_free``
        and ``.blocks_shared``; with ``full`` (once an iteration) also the
        fragmentation (``blocks_frag``: each physical block's written rows
        counted once), ``blocks_parked`` and ``prefix_hit_rate``."""
        if not self._paged:
            return
        free = self._alloc.free_blocks
        self.stats["blocks_free_min"] = min(self.stats["blocks_free_min"],
                                            free)
        telemetry.set_gauge(self._gauge + "blocks_free", free)
        telemetry.set_gauge(self._gauge + "blocks_shared",
                            self._alloc.shared_blocks)
        if not full:
            return
        bs = self.block_size
        filled = {}
        for holder, n in [(s.blocks, s.pos) for s in self._active.values()] \
                + [(p.blocks, p.done) for p in self._prefilling.values()]:
            if holder is None:
                continue
            for i, b in enumerate(holder):
                rows = min(bs, max(0, n - i * bs))
                if rows > filled.get(b, 0):
                    filled[b] = rows
        parked = 0 if self._prefix is None else self._prefix.parked_count
        telemetry.set_gauge(self._gauge + "blocks_frag", round(
            self._alloc.fragmentation(sum(filled.values()) + parked * bs,
                                      cached_blocks=parked), 4))
        if self._prefix is not None:
            telemetry.set_gauge(self._gauge + "blocks_parked", parked)
            looked = self.stats["prefix_lookup_tokens"]
            if looked:
                telemetry.set_gauge(
                    self._gauge + "prefix_hit_rate",
                    round(self.stats["prefix_tokens"] / float(looked), 4))

    # -- paged admission and chunked prefill -------------------------------
    def _admit_one_paged(self, req):
        """Acquire the longest cached prefix, allocate fresh blocks for the
        uncached suffix and the first decode write, then stream only the
        suffix through the pool.  A denied allocation requeues the
        request at the front."""
        row = self._free.pop()
        tokens = req.prompt if req._resume is None else req._resume[0]
        shared = [] if self._prefix is None else self._prefix.lookup(tokens)
        matched = len(shared) * self.block_size
        # acquire before allocating: live refs pin the matched blocks, so
        # the allocation's eviction under pressure cannot reclaim them
        self._alloc.acquire(shared)
        if self._prefix is not None:
            self._prefix.unpark(shared)
        fresh = self._alloc_blocks(
            self._alloc.blocks_for(len(tokens) + 1) - len(shared))
        if fresh is None:
            self._drop_refs(shared)
            self._free.append(row)
            self.stats["alloc_denied"] += 1
            self._count("alloc_denied")
            with self._qlock:
                self._queue.appendleft(req)
            return False
        # hits count only for admissions that land: a denied one retries
        # its lookup every iteration
        if self._prefix is not None:
            self.stats["prefix_lookup_tokens"] += len(tokens)
            if matched:
                self._count_prefix_hit(matched)
        blocks = shared + fresh
        self._block_gauges()
        if req._migrated:
            # a journal-migrated request's replay admission landed on this
            # survivor: counted once, here
            req._migrated = False
            self.stats["replays"] += 1
            self._count("replays")
        self._enter_decode_or_prefill(req, row, list(tokens), blocks, matched)
        return True

    def _count_prefix_hit(self, matched_tokens):
        self.stats["prefix_hits"] += 1
        self.stats["prefix_tokens"] += matched_tokens
        self._count("prefix_hits")
        telemetry.inc("serve.prefix_tokens", matched_tokens)

    def _enter_decode_or_prefill(self, req, row, tokens, blocks, covered):
        """Route an admission whose cache rows [0, covered) are already
        valid: a full cover bootstraps straight into the decode set,
        anything else streams its uncached suffix through chunked
        prefill."""
        if covered >= len(tokens):
            # nothing to prefill: feed the last cached token at its own
            # position.  A fresh admission has sampled nothing (n_new 0,
            # t_first stamps at its first decode); a resumed one carries
            # on with its own counters
            self.stats["prefix_bootstraps"] += 1
            self._count("prefix_bootstraps")
            if req._resume is None:
                last, pos, n_new = int(tokens[-1]), len(tokens) - 1, 0
                telemetry.observe(
                    "serve.queue_age_ms",
                    1e3 * (time.perf_counter() - req.t_submit))
            else:
                last, pos, n_new = req._resume[1:]
                req._resume = None
                if self._drafter is not None and n_new:
                    # the replayed generation seeds the drafter, so its
                    # accept rate holds from the first round on
                    self._drafter.on_resume(list(tokens) + [last])
            seq = _Seq(req, last, pos, blocks=blocks, ctx=list(tokens[:pos]))
            seq.n_new = n_new
            self._active[row] = seq
            return
        pf = _Prefill(req, row, tokens, blocks,
                      resume=None if req._resume is None
                      else req._resume[1:])
        pf.done = covered
        self._prefilling[row] = pf
        self._advance_chunk(pf)

    def _drop_prefill(self, pf):
        """Remove a mid-stream prefill: row and blocks return to their
        pools; the caller resolves the request."""
        self._prefilling.pop(pf.row, None)
        self._free.append(pf.row)
        self._release_blocks(pf)

    def _advance_prefills(self):
        """Advance every mid-stream prefill by one chunk."""
        for pf in list(self._prefilling.values()):
            if self._prefilling.get(pf.row) is pf:
                self._advance_chunk(pf)

    def _advance_chunk(self, pf):
        """Launch one prefill chunk; the last one moves the sequence to
        the active set (sampling its first token, or resuming a
        preempted generation where it stopped).  Failures are scoped as
        on the slot path: a setup or scoped fault quarantines the
        request, a lost cache rebuilds the pool (requeueing every
        mid-prefill request, this one included), a dead device is
        scheduler-fatal."""
        req = pf.req
        total = len(pf.tokens)
        remaining = total - pf.done
        largest = self.prefill_buckets[-1]
        bucket = largest if remaining > largest else \
            self._bucket_for(remaining, self.prefill_buckets)
        chunk = min(remaining, bucket)
        final = pf.done + chunk >= total and pf.resume is None
        try:
            inputs = self._chunk_inputs(pf.tokens[pf.done:pf.done + chunk],
                                        bucket, pf.done, pf.blocks)
            if chaos.serve_launch_error():
                raise chaos.ChaosError("chaos: injected prefill launch "
                                       "error")
        except Exception as e:  # noqa: BLE001 -- nothing launched
            self._drop_prefill(pf)
            self._quarantine(req, "prefill setup failed: %s" % e)
            return
        try:
            logits = self._prefill_chunk(*inputs)
            first = self._pick(logits, [req], [total])[0] if final else None
        except Exception as e:  # noqa: BLE001 -- scoped in _launch_failed
            self._launch_failed(e, req, lambda: self._drop_prefill(pf))
            return
        if self._drafter is not None:
            # the draft cache prefills in lockstep, over the same operands
            self._drafter.on_prefill_chunk(*inputs)
        pf.done += chunk
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += chunk
        telemetry.inc("serve.prefill_chunks")
        # publish the newly full blocks (``done`` counts real tokens only,
        # so a block whose tail holds the bucket's padding stays private)
        self._register_prefix(pf.tokens, pf.blocks, pf.done)
        if pf.done < total:
            return
        del self._prefilling[pf.row]
        blocks, pf.blocks = pf.blocks, None
        self.stats["prefills"] += 1
        telemetry.inc("serve.prefills")
        if pf.resume is None:
            # fresh admissions only: a resumed one's wait was decode time
            telemetry.observe("serve.queue_age_ms",
                              1e3 * (time.perf_counter() - req.t_submit))
        if pf.resume is not None:
            # the cache rows are rebuilt: continue from the token the
            # preemption interrupted (nothing is sampled again)
            last, pos, n_new = pf.resume
            req._resume = None
            seq = _Seq(req, last, pos, blocks=blocks, ctx=pf.tokens)
            seq.n_new = n_new
            if self._drafter is not None and n_new:
                self._drafter.on_resume(list(pf.tokens) + [last])
            self._active[pf.row] = seq
            return
        req.t_first = time.perf_counter()
        req.tokens.append(first)
        self.stats["tokens"] += 1
        telemetry.inc("serve.tokens")
        seq = _Seq(req, first, total, blocks=blocks, ctx=pf.tokens)
        if self._seq_finished(seq, first):
            self._retire(pf.row, seq, enter=False)
        else:
            self._active[pf.row] = seq
        req._publish()

    # -- growth, copy-on-write and preemption ------------------------------
    def _grow_active(self):
        """Before a decode step every active row must own, exclusively,
        the blocks its writes land in: a row past its last block grows,
        and a row about to write into a block that is shared or
        registered gets a private copy first (copy-on-write), so the
        cached original keeps serving its other readers.  A step writes
        one position, a verify k+1 (the fed token and k drafts), a
        megastep up to m, all before the host sees any of them, so the
        whole span is covered up front.  A denied allocation preempts or
        stalls the row (`_grow_alloc`)."""
        span = self._spec_k + 1 if self._spec else 1
        if self._mega_m:
            span = max(span, self._mega_m)
        self._stalled.clear()
        oldest = self._oldest_inflight()
        for row, seq in list(self._active.items()):
            if row not in self._active:
                continue  # preempted as an earlier row's victim
            last_write = min(seq.pos + span, self.model.seq_len) - 1
            need = last_write // self.block_size + 1
            if need > len(seq.blocks):
                got = self._grow_alloc(row, seq, need - len(seq.blocks),
                                       oldest)
                if got is None:
                    continue  # preempted or stalled out of this step
                seq.blocks.extend(got)
                self._block_gauges()
            for idx in range(seq.pos // self.block_size, need):
                if row not in self._active or row in self._stalled:
                    break
                wb = seq.blocks[idx]
                if self._alloc.exclusive(wb) and \
                        (self._prefix is None
                         or not self._prefix.contains(wb)):
                    continue  # sole unregistered owner: write in place
                got = self._grow_alloc(row, seq, 1, oldest)
                if got is None:
                    break
                if not self._cow(seq, idx, got[0]):
                    return  # the cache was rebuilt: every row is gone

    def _oldest_inflight(self):
        """Id of the oldest admitted request (active or mid-prefill): the
        one the anti-thrash policy never preempts, so under sustained
        pressure one request always runs to completion."""
        reqs = [s.req for s in self._active.values()] + \
               [p.req for p in self._prefilling.values()]
        if not reqs:
            return None
        return min(reqs, key=lambda r: (r.t_submit, r.id)).id

    def _protected(self, seq, oldest):
        """Whether ``seq`` is exempt from preemption: the oldest in-flight
        request always, and a resumed sequence until it has advanced
        ``min_progress`` tokens past its last preemption.  0 disables
        both."""
        if self._min_progress <= 0:
            return False
        if seq.req.id == oldest:
            return True
        base = seq.req._preempt_n_new
        return base is not None and seq.n_new - base < self._min_progress

    def _grow_alloc(self, row, seq, n, oldest):
        """``n`` blocks for an active row's growth or copy, or None after
        preempting or stalling the row.  An unprotected row is preempted.
        Against real exhaustion a protected row first preempts a younger
        unprotected victim, and with no victim to yield it preempts itself
        rather than deadlock a sole sequence.  When the room is still
        denied (the victim freed too little, or the allocator refused with
        free blocks on hand) the row stalls: it keeps its blocks and
        context, sits out this decode step and retries next iteration,
        with no replay burned."""
        got = self._alloc_blocks(n)
        if got is not None:
            return got
        if not self._protected(seq, oldest):
            self._preempt(row, seq)
            return None
        if not self._alloc.can_serve(n):
            if not self._preempt_victim(row, oldest):
                self._preempt(row, seq)
                return None
            got = self._alloc_blocks(n)
            if got is not None:
                return got
        self._stall(row)
        return None

    def _preempt_victim(self, protect_row, oldest):
        """Free room for a protected row by preempting the cheapest
        younger holder: a fresh mid-prefill admission first (nothing
        sampled, and its cached part is already in the prefix index),
        then the youngest unprotected active sequence; never the oldest
        in-flight request.  True when a victim yielded."""
        for pf in reversed(list(self._prefilling.values())):
            r = pf.req
            if r.id == oldest or r._preempt_n_new is not None:
                continue  # resumed prefills are protected like seqs
            self._preempt_prefill(pf)
            return True
        cands = [(row, s) for row, s in self._active.items()
                 if row != protect_row and not self._protected(s, oldest)]
        if not cands:
            return False
        row, seq = max(cands, key=lambda rs: (rs[1].req.t_submit,
                                              rs[1].req.id))
        self._preempt(row, seq)
        return True

    def _preempt_prefill(self, pf):
        """Preempt a mid-prefill admission: its partial context is
        released exactly once and the request requeues at the front (a
        resuming one still carries ``_resume``, so it replays the same
        context)."""
        del self._prefilling[pf.row]
        self._free.append(pf.row)
        req = pf.req
        req._preempt_n_new = pf.resume[2] if pf.resume is not None else 0
        self._release_blocks(pf)
        self.stats["preemptions"] += 1
        self._count("preempted")
        self._note_preempt()
        telemetry.record_event("serve_preempt", replica=self.name,
                               request=req.id, pos=pf.done, prefill=True)
        with self._qlock:
            self._queue.appendleft(req)

    def _stall(self, row):
        """Sit ``row`` out of this decode step: its blocks and context
        stay, the allocation retries next step."""
        self._stalled.add(row)
        self.stats["stalls"] += 1
        self._count("stalled")

    def _note_preempt(self):
        """Preemption-storm detector: ``thrash_trip`` preemptions with no
        completion in between cap new admissions at max_new_tokens // 4
        until a request completes."""
        self._preempts_since_retire += 1
        if self._thrash_trip > 0 and not self._storm and \
                self._preempts_since_retire >= self._thrash_trip:
            self._storm = True
            self.stats["thrash_trips"] += 1
            self._count("thrash_trips")
            telemetry.record_event(
                "serve_thrash_trip", replica=self.name,
                preempts=self._preempts_since_retire)

    def _cow(self, seq, idx, dst):
        """Copy block ``seq.blocks[idx]`` into ``dst`` and repoint the
        table; the original loses this reader.  Returns False when the
        copy raised after writing (the cache was rebuilt: every table is
        void); a scoped failure preempts the row (its replay rebuilds the
        context; the shared block is never written); a dead device
        raises."""
        src = seq.blocks[idx]
        try:
            self.model.copy_block(self._cache, src, dst)
        except Exception as e:  # noqa: BLE001 -- classified below
            kind = self._classify_failure(e)
            if kind == "device":
                raise _EngineFatal("cow copy failed: %s" % e) from e
            self._drop_refs([dst])
            if kind == "cache":
                self._rebuild_cache("cow copy failed: %s" % e)
                return False
            for row, s in list(self._active.items()):
                if s is seq:
                    self._preempt(row, seq)
            return True
        if self._drafter is not None:
            # the draft rows live at the same (block, offset) coordinates
            self._drafter.on_cow(src, dst)
        seq.blocks[idx] = dst
        self._drop_refs([src])
        self.stats["cow_copies"] += 1
        self._count("cow_copies")
        self._block_gauges()
        return True

    def _vacate_row(self, row, seq):
        """Take an active row out for a later exact replay: leave the
        decode set, free the row, capture ``(ctx, last, pos, n_new)``
        (the cache holds rows [0, pos), exactly ``ctx``) and release the
        blocks once."""
        del self._active[row]
        self._free.append(row)
        req = seq.req
        req._resume = (list(seq.ctx), seq.last, seq.pos, seq.n_new)
        req._preempt_n_new = seq.n_new
        self._release_blocks(seq)
        return req

    def _preempt(self, row, seq):
        """Vacate a row and requeue its request at the front."""
        req = self._vacate_row(row, seq)
        self.stats["preemptions"] += 1
        self._count("preempted")
        self._note_preempt()
        telemetry.record_event("serve_preempt", replica=self.name,
                               request=req.id, pos=seq.pos)
        with self._qlock:
            self._queue.appendleft(req)

    # -- retirement ----------------------------------------------------------
    def _seq_finished(self, seq, token):
        if seq.req.eos_id is not None and token == seq.req.eos_id:
            return True
        if seq.n_new >= seq.req.max_new_tokens:
            return True
        # `last` is fed at `pos` on the next decode, so the last decodable
        # position is seq_len - 1
        return seq.pos >= self.model.seq_len

    def _retire(self, row, seq, enter=True):
        if enter:
            del self._active[row]
        self._free.append(row)
        if self._drafter is not None and seq.ctx is not None:
            # a finished stream is an exact oracle for the next identical
            # request (deterministic decoding)
            self._drafter.on_retire(seq.ctx + [seq.last])
        self._release_blocks(seq)
        seq.req._finish()
        self.stats["completed"] += 1
        # a completion proves the pool drains: reset the storm detector
        self._preempts_since_retire = 0
        self._storm = False
        telemetry.inc("serve.completed")
        telemetry.observe("serve.latency_ms", seq.req.latency_ms)
        if seq.req.ttft_ms is not None:
            telemetry.observe("serve.ttft_ms", seq.req.ttft_ms)

    def _retire_error(self, row, seq, err):
        """Retire an active row with the typed error ``err``."""
        del self._active[row]
        self._free.append(row)
        self._release_blocks(seq)
        seq.req._finish(error=err)

    def _finish_dropped(self, req, now=None):
        """Resolve a cancelled or expired request with its typed error."""
        if req._cancelled:
            self._count("cancelled")
            req._finish(error=ServeCancelled(
                "ServeRequest %d: cancelled" % req.id))
        else:
            now = time.perf_counter() if now is None else now
            self._count("expired")
            req._finish(error=ServeDeadlineExceeded(
                "ServeRequest %d: deadline exceeded after %.0f ms"
                % (req.id, 1e3 * (now - req.t_submit))))

    def _sweep(self):
        """Retire expired and cancelled requests at iteration granularity:
        queued ones never reach a prefill, running ones leave the next
        decode batch."""
        now = time.perf_counter()
        dropped = []
        with self._qlock:
            if any(r._cancelled or r.expired(now) for r in self._queue):
                keep = deque()
                for r in self._queue:
                    if r._cancelled or r.expired(now):
                        dropped.append(r)
                    else:
                        keep.append(r)
                self._queue = keep
                self._qcond.notify_all()
        for row, seq in list(self._active.items()):
            r = seq.req
            if r._cancelled or r.expired(now):
                dropped.append(r)
                del self._active[row]
                self._free.append(row)
                self._release_blocks(seq)
        for pf in list(self._prefilling.values()):
            r = pf.req
            if r._cancelled or r.expired(now):
                dropped.append(r)
                self._drop_prefill(pf)
        for r in dropped:
            self._finish_dropped(r, now)

    # -- decode --------------------------------------------------------------
    def _advance_one(self, seq, t):
        """Advance a sequence by one emitted token; True when it finished."""
        if seq.req.t_first is None:
            # a bootstrap admission skipped prefill: this is its first token
            seq.req.t_first = time.perf_counter()
        seq.req.tokens.append(t)
        if seq.ctx is not None:
            seq.ctx.append(seq.last)  # the token cached at the old pos
        seq.last = t
        seq.pos += 1
        seq.n_new += 1
        if self._prefix is not None and seq.pos % self.block_size == 0:
            # the block behind `pos` just filled with real rows
            self._register_prefix(seq.ctx, seq.blocks, seq.pos)
        return self._seq_finished(seq, t)

    def _decode_plain(self):
        """One single-token decode launch over the active rows that are
        not stalled (also speculation's round when no row has a real
        draft).  A failed launch goes through `_handle_launch_failure`."""
        rows = [r for r in self._active if r not in self._stalled]
        n = len(rows)
        if n == 0:
            # every row is stalled on a denied allocation: back off briefly
            # instead of spinning while room (or a deadline) arrives
            time.sleep(0.001)
            return
        b = self._bucket_for(n, self.decode_buckets)
        seqs = [self._active[r] for r in rows]
        inputs = self._decode_inputs(b, seqs, rows)
        t_launch = time.perf_counter()
        try:
            if chaos.serve_launch_error():
                raise chaos.ChaosError("chaos: injected decode launch error")
            logits = self._decode(*inputs)
            t_fetch = time.perf_counter()
            nxt = self._pick(logits, [s.req for s in seqs],
                             [s.pos + 1 for s in seqs])
        except Exception as e:  # noqa: BLE001 -- scoped below
            # scoped or transient: the cache is intact, so the same decode
            # retries next iteration; escalates after N in a row
            self._handle_launch_failure(e, "decode")
            return
        now = time.perf_counter()
        self.stats["fetch_wait_s"] += now - t_fetch
        self.stats["hidden_s"] += now - t_launch
        self._launch_fails = 0
        self.stats["decode_steps"] += 1
        self.stats["decode_rows"] += n
        self.stats["decode_padded"] += b - n
        self.stats["tokens"] += n
        telemetry.inc("serve.decode_steps")
        telemetry.inc("serve.tokens", n)
        telemetry.inc("serve.decode_padded", b - n)
        telemetry.set_gauge(self._gauge + "batch_occupancy", n / float(b))
        for row, seq, t in zip(rows, seqs, nxt):
            finished = self._advance_one(seq, t)
            if not finished and self._drafter is not None \
                    and seq.ctx is not None:
                # a plain round still feeds a learning drafter
                self._drafter.observe(seq.ctx + [seq.last], 1)
            if finished:
                self._retire(row, seq)
            seq.req._publish()

    def _handle_launch_failure(self, e, what):
        """The decode failure ladder: a dead device raises `_EngineFatal`,
        a lost cache rebuilds it, and a scoped or transient fault counts
        toward ``MXNET_SERVE_LAUNCH_RETRIES`` consecutive failures, past
        which the engine dies; below it the decode retries next
        iteration."""
        kind = self._classify_failure(e)
        if kind == "device":
            raise _EngineFatal("%s launch failed: %s" % (what, e)) from e
        if kind == "cache":
            self._rebuild_cache("%s launch failed: %s" % (what, e))
            return
        self._launch_fails += 1
        self._count("launch_errors")
        if self._launch_fails >= self._launch_retries:
            raise _EngineFatal(
                "%s launch failed %d consecutive times (last: %s)"
                % (what, self._launch_fails, e)) from e

    def _inject_flood(self):
        """`queue_flood` chaos: synthetic one-token requests through the
        same admission control as real traffic (a shed flood counts in
        ``serve.shed``)."""
        for _ in range(chaos.serve_queue_flood()):
            req = ServeRequest([1], 1, deadline_ms=self._deadline_ms_default)
            telemetry.inc("serve.chaos_flooded")
            try:
                self._enqueue(req)
            except ServeError:
                pass  # shed: the pressure the clause probes

    def step(self):
        """One scheduler iteration (`_step`, or with megastep and no
        speculation `_step_mega`), timed for the ``host_frac`` gauge: of
        the wall time of the iterations that decoded, the share outside
        any launch-to-fetch span, host work no launch hid.  Returns the
        number of sequences still in flight (0 = idle)."""
        t0 = time.perf_counter()
        h0 = self.stats["hidden_s"]
        if self._mega_m and not self._spec:
            n = self._step_mega()
        else:
            n = self._step()
        dh = self.stats["hidden_s"] - h0
        if dh > 0:
            wall = time.perf_counter() - t0
            self.stats["wall_s"] += wall
            self.stats["host_s"] += max(0.0, wall - dh)
            telemetry.set_gauge(
                self._gauge + "host_frac",
                round(self.stats["host_s"] / self.stats["wall_s"], 4))
        return n

    def _chaos_step(self):
        """Chaos's per-iteration faults: the queue flood and, with the
        prefix cache, `prefix_evict` (the LRU parked block goes as if
        allocation pressure claimed it)."""
        self.last_beat = time.monotonic()
        if chaos.enabled():
            self._inject_flood()
            if self._prefix is not None and chaos.serve_prefix_evict():
                evicted = self._prefix.evict(1)
                if evicted:
                    self._alloc.reclaim(evicted)
                    self._count_evictions(len(evicted))

    def _admit_queued(self):
        """Admit queued requests while a row is free; then the active
        set's gauges."""
        while self._free:
            with self._qlock:
                req = self._queue.popleft() if self._queue else None
                if req is not None:
                    self._admitting += 1
                    self._qcond.notify_all()
            if req is None:
                break
            try:
                if req._cancelled or req.expired():
                    # expired or cancelled since the sweep
                    self._finish_dropped(req)
                    continue
                if self._admit_one(req) is False:
                    break
            finally:
                with self._qlock:
                    self._admitting -= 1
        with self._qlock:
            telemetry.set_gauge(self._gauge + "queue_depth",
                                len(self._queue))

    def _count_active(self):
        n = len(self._active)
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"], n)
        telemetry.set_gauge(self._gauge + "active", n)
        return n

    def _chaos_decode(self):
        """Chaos's faults at a decode-bearing iteration: `engine_crash`
        (a dead device) and `decode_slow`."""
        if chaos.enabled():
            if chaos.serve_engine_crash(self.name):
                raise chaos.ChaosEngineCrash(
                    "chaos: engine_crash killed replica %s" % self.name)
            ms = chaos.serve_decode_slow()
            if ms:
                time.sleep(ms / 1e3)

    def _step(self):
        """Inject chaos's faults, sweep deadlines and cancellations,
        advance mid-stream prefills, admit while there is room, grow (and
        copy) blocks, then one decode step (or speculation round) over
        the active set."""
        self._chaos_step()
        self._sweep()
        if self._paged:
            self._advance_prefills()
        self._admit_queued()
        if self._paged:
            self._grow_active()
            self._block_gauges(full=True)
        if self._count_active():
            self._chaos_decode()
            if self._spec:
                self._decode_spec()
            else:
                self._decode_plain()
        return len(self._active) + len(self._prefilling)

    # -- megastep decode -----------------------------------------------------
    def _step_mega(self):
        """One megastep iteration: grow the active rows' blocks over the
        m-span, launch the megastep, then run the host sweep (deadlines,
        prefill chunks, admission) while it executes, and only then wait
        for its token grid.  The card runs one stream in order, so a
        prefill queued in the window runs after the megastep's writes;
        `_finish_mega` skips a row swept or preempted in the window (its
        tokens in flight drop, and a replay resumes from the position
        before the megastep)."""
        self._chaos_step()
        inflight = None
        if self._active:
            self._grow_active()
            self._block_gauges(full=True)
            inflight = self._launch_mega()
        self._sweep()
        self._advance_prefills()
        self._admit_queued()
        self._count_active()
        if inflight is not None:
            # a crash here kills the replica with the megastep in flight:
            # its tokens were never fetched, so no request holds them
            self._chaos_decode()
            self._finish_mega(inflight)
        elif self._active:
            time.sleep(0.001)   # every row is stalled on a denial
        return len(self._active) + len(self._prefilling)

    def _launch_mega(self):
        """Launch one megastep over the active rows that are not stalled
        and start the copy of its token grid to the host, without
        waiting.  Returns the in-flight handle, or None when nothing
        launched (every row stalled, or the launch failed and took the
        retry ladder)."""
        rows = [r for r in self._active if r not in self._stalled]
        n = len(rows)
        if n == 0:
            return None
        b = self._bucket_for(n, self.decode_buckets)
        seqs = [self._active[r] for r in rows]
        token, pos, tables = self._decode_inputs(b, seqs, rows)
        left = np.zeros((b,), np.int64)
        eos = np.full((b,), -1, np.int64)
        for i, seq in enumerate(seqs):
            left[i] = max(0, seq.req.max_new_tokens - seq.n_new)
            if seq.req.eos_id is not None:
                eos[i] = int(seq.req.eos_id)
        samp = self._samp_device([s.req for s in seqs], b)
        t_launch = time.perf_counter()
        try:
            if chaos.serve_launch_error():
                raise chaos.ChaosError(
                    "chaos: injected megastep launch error")
            grid = self._megastep(token, pos, self._put(left),
                                  self._put(eos), tables, samp)
            host, done = self._to_host(grid)
        except Exception as e:  # noqa: BLE001 -- scoped below
            self._handle_launch_failure(e, "megastep")
            return None
        self._launch_fails = 0
        return rows, seqs, host, done, n, b, t_launch

    def _finish_mega(self, inflight):
        """Wait for a megastep's (b, m) token grid and walk it row by row
        through `_advance_one`, the bookkeeping plain decode and
        speculation use.  A -2 is a row that had retired on the device
        (or was launched finished)."""
        rows, seqs, host, done, n, b, t_launch = inflight
        t_fetch = time.perf_counter()
        try:
            out = self._fetch(host, done)   # the megastep's one fetch
        except Exception as e:  # noqa: BLE001 -- an asynchronous fault
            self._handle_launch_failure(e, "megastep")
            return
        now = time.perf_counter()
        self.stats["fetch_wait_s"] += now - t_fetch
        # the launch-to-fetch span: host work inside it ran while the
        # megastep executed
        self.stats["hidden_s"] += now - t_launch
        m = self._mega_m
        self.stats["megasteps"] += 1
        self.stats["decode_rows"] += n
        self.stats["decode_padded"] += b - n
        telemetry.inc("serve.megasteps")
        telemetry.inc("serve.decode_padded", b - n)
        telemetry.set_gauge(self._gauge + "batch_occupancy", n / float(b))
        emitted = retired = 0
        for i, (row, seq) in enumerate(zip(rows, seqs)):
            if self._active.get(row) is not seq:
                continue  # swept, preempted or vacated in the window
            adv = 0
            finished = False
            for j in range(m):
                t = int(out[i, j])
                if t == -2:
                    break
                finished = self._advance_one(seq, t)
                adv += 1
                if finished:
                    break
            emitted += adv
            if finished:
                retired += 1   # its stop rule fired on the device
                self._retire(row, seq)
            elif adv and self._drafter is not None \
                    and seq.ctx is not None:
                self._drafter.observe(seq.ctx + [seq.last], adv)
            seq.req._publish()
        self.stats["tokens"] += emitted
        self.stats["megastep_tokens"] += emitted
        self.stats["ingraph_retired"] += retired
        telemetry.inc("serve.tokens", emitted)
        telemetry.inc("serve.megastep_tokens", emitted)
        if retired:
            telemetry.inc("serve.ingraph_retired", retired)

    def _decode_mega(self):
        """A megastep launched and fetched at once: speculation's round
        when no row has a real draft and megastep is on too."""
        inflight = self._launch_mega()
        if inflight is None:
            if self._active:
                time.sleep(0.001)
            return
        self._finish_mega(inflight)

    # -- speculative decoding ------------------------------------------------
    def _rewind_blocks(self, seq):
        """Give back the blocks past the accepted frontier: the row keeps
        those covering its cached rows 0..pos-1, and every block beyond
        (rejected drafts' rows) goes through `_drop_refs`, which drops
        exactly this row's one reference.  A tail block another request
        shares keeps its other holder, and one the prefix index
        registered parks, so a rewind never frees a block someone still
        reads."""
        keep = max(1, self._alloc.blocks_for(seq.pos))
        if len(seq.blocks) <= keep:
            return
        tail = seq.blocks[keep:]
        del seq.blocks[keep:]
        self._drop_refs(tail)
        self.stats["spec_rollbacks"] += len(tail)
        self._count("spec.rollbacks", len(tail))
        self._block_gauges()

    def _decode_spec(self):
        """One draft, verify and accept round over the active rows that
        are not stalled.  The drafter proposes k tokens a row; one verify
        feeds [last, d_1..d_k] at pos..pos+k (the span `_grow_active`
        covered) and returns the target's pick at each position and the
        count of leading drafts equal to them.  The accepted drafts and
        the target's next token then go one at a time through
        `_advance_one`, so stopping and prefix registration are plain
        decode's; the rows past the kept ones hold garbage the next round
        overwrites before attending, and their blocks rewind."""
        rows = [r for r in self._active if r not in self._stalled]
        n = len(rows)
        if n == 0:
            time.sleep(0.001)  # every row stalled: retry next iteration
            return
        b = self._bucket_for(n, self.decode_buckets)
        k = self._spec_k
        c = k + 1
        seqs = [self._active[r] for r in rows]
        token = np.zeros((b, c), np.int64)
        pos = np.zeros((b,), np.int64)
        length = np.ones((b,), np.int64)
        tables = np.full((b, self._n_table), TRASH_BLOCK, np.int64)
        for i, seq in enumerate(seqs):
            token[i, 0] = seq.last
            pos[i] = seq.pos
            length[i] = min(c, self.model.seq_len - seq.pos)
            tables[i, :len(seq.blocks)] = seq.blocks
        pos_d = self._put(pos)
        tables_d = self._put(tables)
        samp = self._samp_device([s.req for s in seqs], b)
        tok0 = token[:, 0].copy()
        dev = (self._put(tok0), pos_d, tables_d) \
            if self._drafter.needs_device else None
        drafts = self._drafter.propose(seqs, k, b, host=(tok0, pos, tables),
                                       dev=dev, samp=samp)
        if isinstance(drafts, tuple):
            drafts, confident = drafts
            if not np.asarray(confident)[:n].any():
                # no real draft anywhere: a verify could only advance one
                # token a row, so run the cheaper plain round
                if self._mega_m:
                    return self._decode_mega()
                return self._decode_plain()
        if chaos.enabled() and chaos.serve_draft_junk():
            # `draft_junk:P`: corrupt the round's proposals, the same way
            # each time; the tokens must hold, the accept rate drops
            drafts = (np.asarray(drafts, np.int64) + 1
                      + np.arange(k, dtype=np.int64)[None]) \
                % self.model.vocab_size
            self.stats["spec_junk_rounds"] += 1
            telemetry.inc("serve.chaos_draft_junk")
        token[:, 1:] = np.asarray(drafts, np.int64)[:b]
        t_launch = time.perf_counter()
        try:
            if chaos.serve_launch_error():
                raise chaos.ChaosError("chaos: injected verify launch "
                                       "error")
            out = self._verify(self._put(token), pos_d, self._put(length),
                               tables_d, samp)
            t_fetch = time.perf_counter()
            out = out.cpu().numpy()   # (b, k + 2): the picks, the count
        except Exception as e:  # noqa: BLE001 -- scoped below
            self._handle_launch_failure(e, "verify")
            return
        self._launch_fails = 0
        now = time.perf_counter()
        self.stats["fetch_wait_s"] += now - t_fetch
        self.stats["hidden_s"] += now - t_launch
        self.stats["verify_steps"] += 1
        self.stats["decode_rows"] += n
        self.stats["decode_padded"] += b - n
        telemetry.inc("serve.verify_steps")
        telemetry.inc("serve.decode_padded", b - n)
        telemetry.set_gauge(self._gauge + "batch_occupancy", n / float(b))
        emitted = 0
        for i, (row, seq) in enumerate(zip(rows, seqs)):
            n_new0 = seq.n_new
            # drafts past the row's span (clipped at the cache end) went
            # to the trash block and are never emitted
            n_acc = min(int(out[i, c]), int(length[i]) - 1)
            self.stats["spec_proposed"] += k
            self._count("spec.proposed", k)
            finished = False
            for j in range(n_acc + 1):
                emitted += 1
                if self._advance_one(seq, int(out[i, j])):
                    finished = True
                    break
            self.stats["spec_accepted"] += n_acc
            if n_acc:
                self._count("spec.accepted", n_acc)
            if finished:
                self._retire(row, seq)
            else:
                # a learning drafter sees this row's fresh tokens now, so
                # a concurrent twin drafts off them next round
                self._drafter.observe(seq.ctx + [seq.last],
                                      seq.n_new - n_new0)
                self._rewind_blocks(seq)
            seq.req._publish()
        self.stats["tokens"] += emitted
        telemetry.inc("serve.tokens", emitted)
        if self.stats["spec_proposed"]:
            telemetry.set_gauge(
                self._gauge + "spec_accept_rate",
                round(self.stats["spec_accepted"]
                      / float(self.stats["spec_proposed"]), 4))

    # -- the scheduler thread and the engine's lifetime ----------------------
    def start(self):
        """Run the scheduler on a background thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stopped.clear()
        self._thread = threading.Thread(
            target=self._loop, name="serve-%s" % self.name, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stopped.is_set():
            try:
                n = self.step()
            except Exception as e:  # noqa: BLE001
                # per-request poison and a lost cache are absorbed inside
                # step(); anything that escapes is device-scoped: die, and
                # hand the requests to the router's failover
                telemetry.inc("serve.engine_failures")
                self._die(str(e)[:500])
                return
            self.last_beat = time.monotonic()
            if n == 0:
                # idle: wait for a submit instead of spinning.  Clear
                # first, then re-check the queue, so a submit landing in
                # between leaves the event set
                self._wake.clear()
                with self._qlock:
                    queued = bool(self._queue)
                if not queued and not self._stopped.is_set():
                    self._wake.wait(0.05)

    def _die(self, msg):
        """Scheduler death: release every admitted request's blocks, mark
        the engine dead, and hand the admitted (in-flight) and the queued
        requests to the router's failover hook (``_on_death``).  A
        router with a journal migrates the in-flight ones to survivors by
        exact replay; without a router (or when the hook raises) they
        fail with `ServeEngineDead`."""
        err = ServeEngineDead("ServingEngine %s: scheduler died: %s"
                              % (self.name, msg))
        inflight = self._sweep_inflight()
        with self._qlock:
            # mark dead and drain atomically: _enqueue checks _dead under
            # this lock
            self._dead = msg
            pending = list(self._queue)
            self._queue.clear()
            self._qcond.notify_all()
        handler = self._on_death
        if handler is not None:
            try:
                handler(self, pending, inflight, msg)
                return
            except Exception:  # noqa: BLE001 -- never strand a request
                pass
        for req in inflight + pending:
            req._finish(error=err)

    def _sweep_inflight(self):
        """Remove every admitted sequence and mid-stream prefill, release
        their blocks once, and return their requests unresolved."""
        inflight = []
        for row, seq in list(self._active.items()):
            del self._active[row]
            self._free.append(row)
            self._release_blocks(seq)
            inflight.append(seq.req)
        for pf in list(self._prefilling.values()):
            del self._prefilling[pf.row]
            self._free.append(pf.row)
            self._release_blocks(pf)
            inflight.append(pf.req)
        return inflight

    def _join_thread(self):
        """Stop and join the scheduler thread; afterwards the caller owns
        every piece of scheduler state."""
        self._stopped.set()
        self._wake.set()
        with self._qcond:
            self._qcond.notify_all()  # unblock `block`-policy submitters
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            if t.is_alive():
                # keep the reference, so a later start() cannot run a
                # second scheduler over the same state
                raise MXNetError(
                    "ServingEngine %s: scheduler thread did not stop "
                    "within 30s" % self.name)
            self._thread = None

    def stop(self):
        """Stop the scheduler; every request still queued or admitted
        resolves with `ServeEngineDead`, and later submits raise it."""
        self._join_thread()
        err = ServeEngineDead("ServingEngine %s: engine stopped" % self.name)
        with self._qlock:
            stranded = list(self._queue)
            self._queue.clear()
        for req in self._sweep_inflight():
            req._finish(error=err)
        for req in stranded:
            req._finish(error=err)

    def drain(self, deadline_ms=None):
        """Close admission (new submits raise `ServeEngineDead`), serve out
        the work already here until it finishes or ``deadline_ms``
        passes (default ``MXNET_SERVE_DRAIN_MS``; 0 or None waits for
        idle), then stop the scheduler and return the stragglers
        unresolved, in-flight ones first, then the queued tail: the
        caller resubmits or fails them."""
        if deadline_ms is None:
            dl = float(os.environ.get("MXNET_SERVE_DRAIN_MS", "0"))
            deadline_ms = dl if dl > 0 else None
        with self._qcond:
            self._draining = True
            self._qcond.notify_all()  # blocked submitters resolve typed
        self._wake.set()
        telemetry.record_event("serve_drain_begin", replica=self.name,
                               depth=self.depth())
        t0 = time.monotonic()
        budget_s = None if deadline_ms is None else float(deadline_ms) / 1e3
        while not self._stopped.is_set():
            with self._qlock:
                if self._dead is not None:
                    break
            if self._thread is not None and self._thread.is_alive():
                if self.depth() == 0:
                    break
                time.sleep(0.005)
            else:
                try:
                    n = self.step()
                except Exception as e:  # noqa: BLE001 — as in _loop
                    telemetry.inc("serve.engine_failures")
                    self._die(str(e)[:500])
                    break
                if n == 0:
                    with self._qlock:
                        if not self._queue:
                            break
            if budget_s is not None and time.monotonic() - t0 > budget_s:
                break
        self._join_thread()
        stragglers = self._sweep_inflight()
        with self._qlock:
            stragglers.extend(self._queue)
            self._queue.clear()
            self._qcond.notify_all()
        self._count("drained")
        telemetry.record_event("serve_drain", replica=self.name,
                               stragglers=len(stragglers),
                               waited_ms=round(1e3 * (time.monotonic()
                                                      - t0), 1))
        return stragglers

    def run_until_idle(self, timeout=None):
        """Drive the scheduler until the queue and the active set drain;
        returns the steps taken.  Steps on this thread when no scheduler
        thread owns the engine, polls for the drain when one does, and
        returns at once on a dead engine.  Raises `ServeTimeout` past
        ``timeout`` seconds."""
        t0 = time.perf_counter()
        steps = 0
        while True:
            with self._qlock:
                if self._dead is not None:
                    return steps
            if self._thread is not None and self._thread.is_alive():
                if self.depth() == 0:
                    return steps
                time.sleep(0.005)
            else:
                with self._qlock:
                    queued = len(self._queue)
                if self.step() == 0 and queued == 0:
                    with self._qlock:
                        if not self._queue:
                            return steps
                steps += 1
            if timeout is not None and time.perf_counter() - t0 > timeout:
                raise ServeTimeout(
                    "run_until_idle: timed out after %.1fs (%d steps, "
                    "depth %d)" % (timeout, steps, self.depth()))


def _default_decode_buckets(max_batch):
    """Powers of two up to max_batch (+ max_batch itself)."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return sorted(set(out))


def _default_prefill_buckets(seq_len):
    """Powers of two from 16 up to seq_len (+ seq_len itself)."""
    out, s = [], 16
    while s < seq_len:
        out.append(s)
        s *= 2
    out.append(seq_len)
    return sorted(set(out))


# what a router keyword or method of the JAX package's waits on, by the
# ROADMAP.md item that brings it
_SHARDED = ("sharded replicas (ROADMAP.md queue 1, item 2: "
            "`param_shardings`, `kv_shardings` with torch.distributed)")
_DISAGG = ("disaggregated prefill/decode (ROADMAP.md queue 1, item 2: "
           "`handoff.py`)")
_SESSIONS = ("sessions (ROADMAP.md queue 1, item 2: the host tier and "
             "sessions, `tiers.py`)")


class ReplicaRouter:
    """Least-depth dispatch over engine replicas, with health monitoring,
    failover and respawn: the port of `mxnet_tpu/serving/engine.py`
    `ReplicaRouter`, on replicas that are whole engines (each on one
    device; on one card, all on the same one).

    When a replica's scheduler dies, its admitted in-flight requests
    migrate to survivors by exact replay through the request journal
    (``MXNET_SERVE_JOURNAL=0`` fails them typed instead), its queued ones
    re-dispatch, and a background monitor (`start`) respawns a
    replacement behind a capped exponential backoff (``respawn=False`` or
    ``MXNET_SERVE_RESPAWN=0`` turns respawn off).  `drain` is the planned
    restart: a replica serves out its work, its stragglers migrate the
    same way, and a replacement takes its place.  The JAX router's
    replacement warms from a shared AOT cache and compiles nothing; the
    port compiles nothing in the first place, so a replacement's warmup
    only runs each program once.  Not ported: `from_mesh` (sharded
    replicas), roles and handoffs (``disagg``) and the migration of
    sessions, each raising `MXNetError` that names its ROADMAP item.
    """

    _MONITOR_PERIOD = 0.2
    _BREAKER_RESET_S = 10.0   # healthy this long clears the breaker

    def __init__(self, engines, respawn=None, journal=None, disagg=None,
                 prefill_replicas=None):
        if not engines:
            raise MXNetError("ReplicaRouter: need at least one engine")
        if disagg or prefill_replicas or (disagg is None and _env_flag(
                "MXNET_SERVE_DISAGG", "0")):
            raise MXNetError("ReplicaRouter: %s is not ported yet" % _DISAGG)
        self.engines = list(engines)
        self._lock = threading.Lock()
        if respawn is None:
            respawn = _env_flag("MXNET_SERVE_RESPAWN")
        self._respawn = bool(respawn)
        if journal is None:
            journal = journal_enabled()
        self.journal = RequestJournal() if journal else None
        self._stopped = False
        self._monitor = None
        self._mon_stop = threading.Event()
        self._breaker = {}   # replica name -> (fails, next_try monotonic)
        for e in self.engines:
            self._wire(e)

    def _wire(self, engine):
        """Attach one engine to this router: its death hook."""
        engine._on_death = self._handle_death

    @classmethod
    def from_mesh(cls, *args, **kw):
        raise MXNetError("ReplicaRouter.from_mesh: %s is not ported yet"
                         % _SHARDED)

    def warmup(self):
        return [e.warmup() for e in self.engines]

    # -- failover ----------------------------------------------------------
    def _live_engines(self, exclude=None):
        with self._lock:
            engines = list(self.engines)
        return [e for e in engines
                if e is not exclude and e._dead is None
                and not e._stopped.is_set() and not e._draining]

    def _handle_death(self, engine, pending, inflight, msg):
        """An engine's death hook (runs on the dying scheduler's thread):
        migrate its admitted in-flight requests to survivors by exact
        replay (typed failure without a journal), and re-dispatch its
        queued ones.  Each request resolves on its own: a surprise midway
        must not fail the requests already moved."""
        try:
            telemetry.inc("serve.failovers")
            telemetry.inc("serve.%s.failover" % engine.name)
            telemetry.record_event("serve_failover", replica=engine.name,
                                   pending=len(pending),
                                   inflight=len(inflight), error=msg[:200])
        except Exception:  # noqa: BLE001 -- accounting must not abort it
            pass
        err = ServeEngineDead("ServingEngine %s: scheduler died: %s"
                              % (engine.name, msg))
        for req in inflight:
            try:
                if not self._migrate(req, exclude=engine):
                    req._finish(error=err)
            except Exception:  # noqa: BLE001
                req._finish(error=err)
        err = ServeEngineDead(
            "ServingEngine %s: scheduler died: %s (no live replica to "
            "fail over to)" % (engine.name, msg))
        for req in pending:
            try:
                if not self._redispatch(req, exclude=engine):
                    req._finish(error=err)
            except Exception:  # noqa: BLE001
                req._finish(error=err)

    def _migrate(self, req, exclude=None):
        """Move an admitted in-flight request off a dead or draining
        replica, token for token: the journal rebuilds its resume state
        ``(prompt + generated)[:pos]``, the request (the same object, so
        its deadline and latency stamps never reset) enqueues on the
        least-loaded survivor, whose resume admission prefills the
        replayed context and decodes on at the same position with the
        same request-keyed sampler.  Returns the engine that took it (a
        request already resolved returns True), or False when nothing
        can: no journal, no paged survivor, or every survivor shed."""
        if self.journal is None:
            return False  # in-flight context dies with the replica
        if req.done:
            return True
        state = self.journal.replay_state(req)
        survivors = self._live_engines(exclude=exclude)
        if state is not None:
            # exact replay rides the paged resume path
            survivors = [e for e in survivors if e._paged]
        if not survivors:
            return False
        if state is not None:
            req._resume = state
            req._migrated = True
        for eng in sorted(survivors, key=lambda e: e.depth()):
            try:
                eng._enqueue(req, count_shed_global=False)
            except ServeError:
                continue  # died or shed in the window: try the next
            self.journal.migrations += 1
            telemetry.inc("serve.migrated")
            telemetry.record_event(
                "serve_migrate", request=req.id, target=eng.name,
                pos=0 if state is None else state[2],
                generated=len(req.tokens))
            return eng
        req._migrated = False
        req._resume = None if state is not None else req._resume
        return False

    def _redispatch(self, req, exclude=None):
        """Move a request that was never admitted (the same object) to
        the least-loaded survivor."""
        for eng in sorted(self._live_engines(exclude=exclude),
                          key=lambda e: e.depth()):
            try:
                eng._enqueue(req, count_shed_global=False)
            except ServeError:
                continue
            telemetry.inc("serve.redispatched")
            return True
        return False

    def _monitor_loop(self):
        """Replica health: the heartbeat-age gauges, and the respawn of
        dead replicas behind a capped exponential backoff."""
        while not self._mon_stop.wait(self._MONITOR_PERIOD):
            with self._lock:
                engines = list(self.engines)
            now = time.monotonic()
            for e in engines:
                telemetry.set_gauge("serve.%s.beat_age_s" % e.name,
                                    round(now - e.last_beat, 3))
                if e._dead is None:
                    # a replacement healthy past the reset window clears
                    # its breaker, so rare independent faults over a long
                    # life do not climb toward the backoff cap
                    fails, next_try = self._breaker.get(e.name, (0, 0.0))
                    if fails and now - next_try > self._BREAKER_RESET_S:
                        self._breaker.pop(e.name, None)
                if e._dead is None or not self._respawn or self._stopped:
                    continue
                fails, next_try = self._breaker.get(e.name, (0, 0.0))
                if now < next_try:
                    continue
                # the breaker advances whether or not the respawn works
                self._breaker[e.name] = (
                    fails + 1, now + min(0.05 * (2 ** fails), 5.0))
                try:
                    fresh = e.respawn()
                    self._wire(fresh)
                    fresh.warmup()
                    fresh.start()
                except Exception as ex:  # noqa: BLE001
                    telemetry.record_event("serve_respawn_failed",
                                           replica=e.name,
                                           error=str(ex)[:200])
                    continue
                with self._lock:
                    try:
                        self.engines[self.engines.index(e)] = fresh
                    except ValueError:   # raced with a concurrent swap
                        fresh.stop()
                        continue
                telemetry.inc("serve.respawns")
                telemetry.record_event("serve_respawn", replica=e.name,
                                       attempt=fails + 1)

    # -- dispatch ----------------------------------------------------------
    def submit(self, prompt, **kw):
        """Submit to the least-deep live replica; a replica that dies or
        sheds in the window passes the request on.  Returns the
        `ServeRequest`, entered in the journal."""
        if self._stopped:
            raise ServeEngineDead("ReplicaRouter: router stopped")
        if kw.get("session") is not None:
            raise MXNetError("ReplicaRouter.submit: %s are not ported yet"
                             % _SESSIONS)
        with self._lock:
            fleet = len(self.engines)
        telemetry.set_gauge("serve.replicas", fleet)
        last_err = None
        # two rounds: a replica dying (or respawning) between the snapshot
        # and the submit re-routes instead of failing the request
        for _ in range(2):
            live = self._live_engines()
            if not live:
                break
            shed = 0
            order = sorted(live, key=lambda e: e.depth())
            for eng in order:
                try:
                    req = eng.submit(prompt, _count_shed=False, **kw)
                    if self.journal is not None:
                        telemetry.set_gauge("serve.journal_depth",
                                            self.journal.record(req))
                    return req
                except ServeOverload as e:
                    last_err = e
                    shed += 1
                except ServeEngineDead as e:
                    last_err = e  # died in the window: try the next
                except MXNetError as e:
                    if eng._dead is None:
                        raise  # a bad request, not a dead replica
                    last_err = e
            if shed == len(order):
                telemetry.inc("serve.shed")
                raise ServeOverload(
                    "ReplicaRouter: all %d live candidate replicas shed "
                    "(%s)" % (shed, last_err))
        raise ServeEngineDead(
            "ReplicaRouter: no live replica among %d (%s)"
            % (fleet, last_err))

    def _resolve_engine(self, replica):
        """An engine by object, index or replica name."""
        with self._lock:
            engines = list(self.engines)
        if isinstance(replica, ServingEngine):
            if replica in engines:
                return replica
            raise MXNetError("ReplicaRouter: engine %s is not (or no "
                             "longer) one of this router's replicas"
                             % replica.name)
        if isinstance(replica, int):
            if not 0 <= replica < len(engines):
                raise MXNetError(
                    "ReplicaRouter: replica index %d out of range "
                    "(have %d replicas)" % (replica, len(engines)))
            return engines[replica]
        for e in engines:
            if e.name == replica:
                return e
        raise MXNetError("ReplicaRouter: no replica named %r (have %s)"
                         % (replica, [e.name for e in engines]))

    def drain(self, replica, deadline_ms=None, respawn=True):
        """Restart one replica gracefully: close its admission, let its
        in-flight work finish within ``deadline_ms``, migrate the
        stragglers to survivors by exact replay, stop it and (by default)
        swap in a respawned replacement, so draining every replica in
        turn restarts the fleet with no failed request.  Returns the
        replacement (None with ``respawn=False``)."""
        eng = self._resolve_engine(replica)
        stragglers = eng.drain(deadline_ms=deadline_ms)  # counts drained
        err = ServeEngineDead(
            "ServingEngine %s: drained for restart with no live replica "
            "to migrate to" % eng.name)
        for req in stragglers:
            if req.done:
                continue
            try:
                if self._migrate(req, exclude=eng):
                    continue
                # no journal (or no paged survivor): a straggler with no
                # generated tokens needs no replay, so it redispatches
                # losslessly; only in-flight progress fails typed
                if not req.tokens and self._redispatch(req, exclude=eng):
                    continue
                req._finish(error=err)
            except Exception:  # noqa: BLE001
                req._finish(error=err)
        fresh = None
        if respawn and not self._stopped:
            try:
                fresh = eng.respawn()
                self._wire(fresh)
                fresh.warmup()
            except Exception as ex:  # noqa: BLE001
                # do not leave the fleet a replica short: mark the drained
                # engine dead so the monitor's respawn retries it
                eng._dead = "drain respawn failed: %s" % str(ex)[:300]
                telemetry.record_event("serve_respawn_failed",
                                       replica=eng.name,
                                       error=str(ex)[:200])
                fresh = None
            if fresh is not None:
                with self._lock:
                    try:
                        self.engines[self.engines.index(eng)] = fresh
                    except ValueError:  # raced with a concurrent swap
                        fresh.stop()
                        fresh = None
                if fresh is not None and self._monitor is not None \
                        and self._monitor.is_alive():
                    fresh.start()
        return fresh

    def _migrate_sessions(self, *args, **kw):
        raise MXNetError("ReplicaRouter: %s are not ported yet" % _SESSIONS)

    def _next_name(self):
        """A fresh replicaN name (the caller holds ``_lock``)."""
        names = {e.name for e in self.engines}
        idx = len(self.engines)
        while "replica%d" % idx in names:
            idx += 1
        return "replica%d" % idx

    def add_replica(self, role=None, name=None, template=None):
        """Grow the fleet by one replica templated off a live one (the
        parameters shared), warmed and started.  Returns it."""
        if role is not None:
            raise MXNetError("ReplicaRouter.add_replica: %s is not ported "
                             "yet" % _DISAGG)
        if self._stopped:
            raise MXNetError("ReplicaRouter: router stopped")
        with self._lock:
            if template is None:
                template = next((e for e in self.engines if e._dead is None
                                 and not e._stopped.is_set()
                                 and not e._draining), None)
            if template is None:
                raise MXNetError("ReplicaRouter: no live replica to "
                                 "template a scale-up from")
            if name is None:
                name = self._next_name()
        fresh = template.respawn(name=name)
        self._wire(fresh)
        fresh.warmup()
        with self._lock:
            self.engines.append(fresh)
            fleet = len(self.engines)
        fresh.start()
        telemetry.set_gauge("serve.replicas", fleet)
        return fresh

    def remove_replica(self, replica=None, deadline_ms=None, role=None):
        """Shrink the fleet by one replica: `drain` it (its stragglers
        migrate), then drop it.  With no ``replica`` the least-loaded
        live one goes.  Refuses to remove the last replica.  Returns the
        removed engine's name."""
        if role is not None:
            raise MXNetError("ReplicaRouter.remove_replica: %s is not "
                             "ported yet" % _DISAGG)
        with self._lock:
            engines = list(self.engines)
        if replica is None:
            pool = [e for e in engines if e._dead is None
                    and not e._stopped.is_set() and not e._draining]
            if not pool:
                raise MXNetError("ReplicaRouter: no removable replica")
            eng = min(pool, key=lambda e: e.depth())
        else:
            eng = self._resolve_engine(replica)
        with self._lock:
            if not [e for e in self.engines if e is not eng]:
                raise MXNetError(
                    "ReplicaRouter: refusing to remove %s: it is the last "
                    "replica" % eng.name)
        self.drain(eng, deadline_ms=deadline_ms, respawn=False)
        with self._lock:
            try:
                self.engines.remove(eng)
            except ValueError:
                pass   # raced with a concurrent removal
            fleet = len(self.engines)
        telemetry.set_gauge("serve.replicas", fleet)
        return eng.name

    def start(self):
        """Start every replica's scheduler and the health monitor."""
        self._stopped = False
        with self._lock:
            engines = list(self.engines)
        for e in engines:
            e.start()
        if self._monitor is None or not self._monitor.is_alive():
            self._mon_stop.clear()
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="serve-router-monitor",
                daemon=True)
            self._monitor.start()
        return self

    def stop(self):
        """Refuse new submits, stop the monitor (so no respawn races the
        stop), then stop every engine, raising after all are stopped if
        any failed to."""
        self._stopped = True
        self._mon_stop.set()
        m = self._monitor
        if m is not None:
            m.join(timeout=10)
            self._monitor = None
        errs = []
        with self._lock:
            engines = list(self.engines)
        for e in engines:
            try:
                e.stop()
            except MXNetError as err:
                errs.append(str(err))
        if errs:
            raise MXNetError(
                "ReplicaRouter: %d engine(s) failed to stop: %s"
                % (len(errs), "; ".join(errs)))

    def run_until_idle(self, timeout=None):
        """Drive every replica until it is idle (on this thread where no
        scheduler thread owns it); ``timeout`` bounds the whole drive
        (`ServeTimeout`)."""
        t0 = time.perf_counter()
        steps = []
        with self._lock:
            engines = list(self.engines)
        for e in engines:
            remaining = None if timeout is None else \
                max(0.0, timeout - (time.perf_counter() - t0))
            if timeout is not None and remaining <= 0 and e.depth() > 0:
                raise ServeTimeout(
                    "ReplicaRouter.run_until_idle: timed out after %.1fs "
                    "with %s still holding %d request(s)"
                    % (timeout, e.name, e.depth()))
            steps.append(e.run_until_idle(timeout=remaining))
        return steps

    def depth(self):
        with self._lock:
            engines = list(self.engines)
        return sum(e.depth() for e in engines)
