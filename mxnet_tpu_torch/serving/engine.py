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

Memory tiering (``tier=True`` or ``MXNET_SERVE_TIER=1``, paged with the
prefix cache only): a parked block the prefix LRU evicts spills to a
bounded host pool (`tiers.HostBlockTier`, ``host_blocks`` /
``MXNET_SERVE_HOST_BLOCKS``, 256) instead of being forgotten, by a
non-blocking copy on the pool's stream, so it lands before any later
write to the freed block.  An admission whose prefix match runs onto
host-resident blocks allocates fresh blocks, packs the run into one
pinned buffer and copies it to the card on a side stream behind an
event (at most ``restore_ahead`` / ``MXNET_SERVE_RESTORE_AHEAD``, 2,
restores in flight; past that it admits on the device match alone);
the next iteration's scatter (`TransformerKVModel.write_block`, which
sets the write mark) waits on the event and the request proceeds as if
the run had stayed on the card.  ``MXNET_SERVE_TIER=0`` (the default) is
the engine without a tier.  Sessions: ``submit(session=key)`` prepends
the key's stored history (the last completed turn's prompt and tokens),
so the prefix lookup reattaches its blocks, on the card or through the
tier, and only the new suffix prefills; a turn submitted while the
previous one is unresolved raises, and ``MXNET_SERVE_SESSION_CAP`` (512)
bounds the keys kept.  `ReplicaRouter` sends a session's turns to the
replica that holds it and moves sessions off a dead or drained replica.

Quantization (``quant=`` / ``MXNET_SERVE_QUANT``, int8 or fp8 weights;
``kv_quant=`` / ``MXNET_SERVE_KV_QUANT``, an int8 paged pool, int8 by
default whenever weight quant is on and the engine pages): the weights
are quantized once at load (`TransformerKVModel.quantize_params`) and
the programs run scaled matmuls and quantize-on-write.  With either on,
every token pick goes through a logit gate on the device: a row whose
logits are nonfinite or above ``MXNET_SERVE_QUANT_LOGIT_MAX`` (1e4)
picks the sentinel -1 instead, which the engine turns into one requeue
by exact replay (scrubbing the row's blocks from the prefix index) and,
the second time, `ServeQuantError`: never a token the gate flagged.
The gate reads the logits on the card, so it adds no host sync.
Chaos's ``spill_fail``, ``restore_slow`` and ``scale_corrupt`` inject
at the JAX engine's sites.

MoE: with a model of ``moe_experts > 0`` every program records its
per-expert routed row counts, padding rows included, as one (E,) row on
the card a launch; a non-blocking copy takes it to pinned memory, the
scheduler folds the landed copies each iteration without waiting
(`_drain_moe`), the ``serve.<name>.expert_load.<i>`` gauges follow, and
`expert_load()` waits for all of them.  The model drafter counts nothing.

Disaggregated prefill and decode (`handoff`): under a `ReplicaRouter`
built with ``disagg`` a prefill replica packs a prefilled sequence's
blocks into a `HandoffTicket` (`_maybe_handoff`) and a decode replica
lands it as a restore (`receive_handoff`, `_stage_handoffs`,
`_complete_landing`); a failed transfer takes the journal's exact replay
(``handoff_fail`` is the chaos clause).  `autoscale.AutoScaler` resizes a
fleet through `ReplicaRouter.add_replica` / `remove_replica`, and
`gateway.ServeGateway` serves a fleet over HTTP with server-sent events.

Sub-mesh replicas (``ctx=`` a `parallel.mesh.Mesh`): one engine shards
its parameters and K/V buffers over the devices of one mesh axis
(``MXNET_SERVE_SHARDED_AXIS``, "model") and runs the partitioned programs
of `sharded.ShardedKVModel` from one host thread; block tables, the
allocator, the prefix cache and all scheduling stay replica-global, so
the router, failover, the journal, drain and respawn treat it as one
replica.  ``MXNET_SERVE_SHARDED=0`` degrades a Mesh ctx to its first
device.  `memory_footprint` reports the JAX engine's accounting, and
`ReplicaRouter.from_mesh` builds a fleet of such replicas.

Request tracing (`mxnet_tpu_torch.tracing`, on unless
``MXNET_SERVE_TRACING=0``): the JAX engine's spans at its call sites, a
root ``request`` span per request closed at `ServeRequest._finish`,
interval phases that tile submit to done, the prefill-chunk and handoff
leaves, the replica-scoped ``megastep``, ``host_sweep`` and
``spec_round`` spans from the scheduler's existing stamps, and a
flight-recorder dump on a quarantine, a cache rebuild, a failed handoff
and scheduler death.  Host clocks only: tracing adds no launch and no
sync.  A prompt token outside
[-V, V) embeds as NaN, as in the JAX engine, and its request decodes
token 0 (the first NaN's index) while the scheduler goes on.
"""
from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import chaos, telemetry, tracing
from ..base import MXNetError
from ..context import resolve
from ..parallel.mesh import Mesh, submeshes
from ..quant.codec import resolve as quant_resolve
from .handoff import HandoffLanding, HandoffTicket, disagg_enabled
from .errors import (ServeBlocksExhausted, ServeCacheInvalidated,
                     ServeCancelled, ServeDeadlineExceeded, ServeEngineDead,
                     ServeError, ServeOverload, ServeQuantError,
                     ServeQuarantined, ServeTimeout)
from .journal import RequestJournal, journal_enabled
from .paged import TRASH_BLOCK, BlockAllocator, PrefixCache
from .sampling import argmax, sample_tokens
from .sharded import ShardedKVModel, ShardedParams
from .spec import make_drafter
from .tiers import HostBlockTier, pack_block_run

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
                 temperature=0.0, top_k=0, top_p=1.0, seed=None,
                 session=None):
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("ServeRequest: empty prompt")
        with self._ids_lock:
            self._ids[0] += 1
            self.id = self._ids[0]
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        # the session key; ``prompt`` is then the stored history plus
        # this turn's tokens
        self.session = session
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
        self._no_handoff = False  # its one handoff failed: the replay
        #                           decodes wherever it lands (roles are
        #                           dispatch policy, not a capability)
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
        # every resolution funnels through here exactly once: close the
        # request's trace and fold its phases into serve.attr.*
        tracing.on_finish(self)


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


class _Restore:
    """A tier-aware admission waiting for its host-to-device copy: the
    prefix match covered ``done`` tokens on the card and the host-resident
    ``nodes`` after them; fresh blocks ``dst`` (the leading fresh blocks
    of ``blocks``, the whole table, held at ordinary refcounts) take the
    run.  ``staged`` is the run packed into one buffer on the device,
    copied from the pinned ``src`` on a side stream behind ``ready`` (a
    CUDA event; None on the CPU), ``dst_d`` the destination ids padded to
    the bucket ``kb`` with the trash block.  `_complete_restore` lands it
    at the next iteration."""

    __slots__ = ("req", "row", "tokens", "done", "blocks", "nodes",
                 "handles", "staged", "dst_d", "dst", "kb", "t_stage",
                 "src", "ready")

    def __init__(self, req, row, tokens, blocks, done, nodes, handles,
                 staged, dst_d, dst, kb, t_stage, src=None, ready=None):
        self.req = req
        self.row = row
        self.tokens = tokens
        self.done = done          # device-matched tokens
        self.blocks = blocks
        self.nodes = nodes        # host-resident _PrefixNodes, in order
        self.handles = handles    # their host-tier handles
        self.staged = staged
        self.dst_d = dst_d
        self.dst = dst
        self.kb = kb
        self.t_stage = t_stage
        self.src = src            # the pinned source, held until ready
        self.ready = ready


class _SessionClaim:
    """The live entry of a session between a submit passing the
    unresolved-turn guard and its admission: never ``done``, so a racing
    second submit of the same session raises.  Resolves to the admitted
    request (`_session_record`) or back to ``prev`` (`_session_unclaim`,
    the shed path)."""

    __slots__ = ("prev", "id", "done")

    def __init__(self, prev):
        self.prev = prev
        self.id = 0 if prev is None else prev.id
        self.done = False


class ServingEngine:
    """Single-replica continuous batcher over one device.

    model:  `TransformerKVModel`.
    params: ``{name: tensor}`` (moved to ``ctx``) or a JAX parameter dict
            of numpy arrays (carried across by `params_from_jax`).
    ctx:    the device, ``cuda:0`` by default; ``"cpu"`` runs the plain
            versions of the kernels; a `Mesh` makes a sub-mesh replica
            over one of its axes (``MXNET_SERVE_SHARDED``,
            ``MXNET_SERVE_SHARDED_AXIS``).
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
    both need the paged cache.  The tier and quantization, left at None,
    read ``MXNET_SERVE_TIER`` (off), ``MXNET_SERVE_HOST_BLOCKS`` (256),
    ``MXNET_SERVE_RESTORE_AHEAD`` (2), ``MXNET_SERVE_QUANT`` (off) and
    ``MXNET_SERVE_KV_QUANT`` (int8 with weight quant on a paged engine,
    else off); ``MXNET_SERVE_SESSION_CAP`` (512) and
    ``MXNET_SERVE_QUANT_LOGIT_MAX`` (1e4) are read at construction.
    """

    def __init__(self, model, params, ctx=None, max_batch=8,
                 decode_buckets=None, prefill_buckets=None,
                 max_new_tokens=32, eos_id=None, paged=True, block_size=None,
                 n_blocks=None, chunk_prefill=True, sampling=True,
                 name="replica0", queue_max=None, overload=None,
                 deadline_ms=None, prefix=None, prefix_pool=None,
                 spec=None, spec_k=None, spec_drafter=None,
                 min_progress=None, thrash_trip=None, megastep=None,
                 megastep_steps=None, tier=None, host_blocks=None,
                 restore_ahead=None, quant=None, kv_quant=None):
        chaos.spec()  # a clause the port cannot inject raises here
        self.name = name
        # a sub-mesh replica: a Mesh ctx shards the params and the K/V
        # buffers over one axis (`sharded.ShardedKVModel`) while every
        # host-side structure stays replica-global, so the router treats
        # it as one replica.  MXNET_SERVE_SHARDED=0 degrades the mesh to
        # its first device
        self._mesh = None
        self._mesh_axis = None
        self._kv_shard = None
        if isinstance(ctx, Mesh):
            if _env_flag("MXNET_SERVE_SHARDED"):
                self._mesh = ctx
                ax = os.environ.get("MXNET_SERVE_SHARDED_AXIS", "model")
                self._mesh_axis = ax if ax in ctx.axis_names \
                    else ctx.axis_names[0]
            ctx = ctx.devices.reshape(-1)[0]
        self.device = resolve(ctx)
        self._paged = bool(paged)
        # post-training quantization: weights quantized once at load,
        # the paged pool int8 by default whenever weight quant is on
        self._quant = quant_resolve(
            os.environ.get("MXNET_SERVE_QUANT", "0") if quant is None
            else quant)
        kvq = os.environ.get("MXNET_SERVE_KV_QUANT", "") \
            if kv_quant is None else kv_quant
        if kvq in ("", None):
            kvq = "int8" if (self._quant is not None
                             and self._paged) else "0"
        self._kv_quant = quant_resolve(kvq)
        if self._kv_quant is not None and not self._paged:
            raise MXNetError(
                "ServingEngine: quantized KV blocks need the paged cache "
                "(MXNET_SERVE_KV_QUANT set with paged=False)")
        self._quant_gate = (self._quant is not None
                            or self._kv_quant is not None)
        self._quant_logit_max = float(os.environ.get(
            "MXNET_SERVE_QUANT_LOGIT_MAX", "1e4"))
        self.model = model = model.with_quant(self._quant, self._kv_quant)
        self._base_model = model  # what a respawn builds from
        sharded_in = isinstance(params, ShardedParams)
        if self._quant is not None and not sharded_in:
            # idempotent: a respawn passes already quantized params
            params = model.quantize_params(params)
        if self._mesh is not None:
            self._kv_shard = model.kv_shardings(self._mesh, self._mesh_axis)
            self.model = model = ShardedKVModel(model, self._mesh,
                                                self._mesh_axis)
            # a respawn passes the dead replica's shards: no bytes move
            self._params = model.shard_params(params)
        elif sharded_in:
            raise MXNetError("ServingEngine: sharded parameters need a Mesh "
                             "ctx (MXNET_SERVE_SHARDED=0 wants a dict)")
        elif all(isinstance(v, torch.Tensor) for v in params.values()):
            model.check_params(params)
            self._params = {k: v.to(self.device) for k, v in params.items()}
        else:
            self._params = model.params_from_jax(params, self.device)
        # per-expert routing telemetry (serve.<name>.expert_load.<i>): an
        # MoE program's launch leaves one (E,) count on the device, copied
        # to pinned memory behind an event; `_drain_moe` folds the copies
        # that have landed into the host total, so the scheduler never
        # waits on a count
        self._moe = bool(getattr(model, "moe_experts", 0))
        self._moe_pending = []    # (host tensor, event or None) a launch
        self._moe_load = (np.zeros((model.moe_experts,), np.int64)
                          if self._moe else None)
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
        self._sampling = bool(sampling)
        self._prefix = None
        self._prefix_pool = -1
        self._tier = None
        self._host_blocks = 0
        self._restore_ahead = 0
        self._restoring = {}      # row -> _Restore (insertion-ordered)
        self._side = None         # the restores' and landings' copy
        #                           stream on a card
        self._landed_src = []     # (event, pinned source) of landed
        #                           restores whose copy may still run
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
            prefix_on = _env_flag("MXNET_SERVE_PREFIX") if prefix is None \
                else bool(prefix)
            # the host-DRAM tier rides the prefix index (without it there
            # is nothing to spill), so prefix off forces it off
            tier_on = (_env_flag("MXNET_SERVE_TIER", "0") if tier is None
                       else bool(tier)) and prefix_on
            self._host_blocks = int(
                os.environ.get("MXNET_SERVE_HOST_BLOCKS", "256")
                if host_blocks is None else host_blocks)
            self._restore_ahead = int(
                os.environ.get("MXNET_SERVE_RESTORE_AHEAD", "2")
                if restore_ahead is None else restore_ahead)
            if tier_on and self._host_blocks > 0:
                # one block of the pool's layout sizes the tier's slots
                # (the unsharded layout, a sub-mesh replica's spills too)
                tmpl = model.block_run_placeholder(1, bs)
                self._tier = HostBlockTier(
                    self._host_blocks,
                    tuple(t[:, :, 0] for t in tmpl)
                    if isinstance(tmpl, tuple) else tmpl[:, :, 0],
                    pin=self.device.type == "cuda")
            if self.device.type == "cuda":
                # host-to-card copies of restores and handoff landings
                self._side = torch.cuda.Stream(self.device)
            if prefix_on:
                self._prefix = PrefixCache(
                    bs, self._prefix_pool,
                    spill_hook=self._spill_block if self._tier is not None
                    else None,
                    host_drop_hook=self._host_dropped
                    if self._tier is not None else None)
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
        # disaggregated prefill/decode: a router sets the role and the
        # hooks before warmup (a decode replica warms the landing's
        # scatter); None is the colocated engine
        self.role = None          # None | "prefill" | "decode"
        self._handoff_sink = None      # router: fn(ticket), stages it on
        #                                a live decode replica or raises
        self._handoff_fallback = None  # router: fn(req) -> bool, the
        #                                journal's exact replay
        self._handoff_inbox = deque()  # tickets received, not yet staged
        self._landing = {}        # row -> HandoffLanding (insertion-ordered)
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
        # sessions: key -> (full history of the last completed turn, its
        # live request or claim), LRU-capped.  The caller's submit and the
        # scheduler's retire both touch it, under _slock
        self._sessions = OrderedDict()
        self._session_cap = max(1, int(os.environ.get(
            "MXNET_SERVE_SESSION_CAP", "512")))
        self._slock = threading.Lock()
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
                      # memory tiering and sessions (0s when off)
                      "spilled": 0, "restored": 0, "restored_tokens": 0,
                      "spill_fails": 0, "restore_fails": 0,
                      "session_hits": 0, "session_turns": 0,
                      # quantization (0s when off)
                      "quant_trips": 0, "scale_corrupts": 0,
                      # disaggregated prefill/decode (0s when off)
                      "handoffs": 0, "handoffs_in": 0, "handoff_fails": 0,
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
        ``newpos`` the tokens will occupy; through the quantization logit
        gate when quantization is on."""
        if not samp:
            picked = argmax(logits)
        else:
            picked = sample_tokens(logits, *samp, newpos)
        return self._quant_guard(logits, picked)

    def _quant_guard(self, logits, picked):
        """The quantization logit gate: with quant on, a row whose logits
        are nonfinite or larger than ``MXNET_SERVE_QUANT_LOGIT_MAX``
        (corrupted scales, a quantization blow-up) picks the sentinel -1,
        which the scheduler turns into a requeue or `ServeQuantError`
        (`_quant_trip_req`), never a token.  On the device, before the
        one fetch the pick already had."""
        if not self._quant_gate:
            return picked
        bad = ~torch.isfinite(logits).all(dim=-1) | \
            (logits.abs().amax(dim=-1) > self._quant_logit_max)
        return torch.where(bad, torch.full_like(picked, -1), picked)

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
        tape = [] if self._moe else None
        logits, kv = self.model.prefill(self._params, toks, length,
                                        moe_tape=tape)
        self.model.write_prefill(self._cache, kv, length, slot)
        self._moe_out(tape)
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
        tape = [] if self._moe else None
        logits, _ = self.model.prefill_paged(self._params, self._cache, toks,
                                             start, length, table,
                                             moe_tape=tape)
        self._moe_out(tape)
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
        tape = [] if self._moe else None
        logits, _ = program(self._params, self._cache, token, pos, where,
                            moe_tape=tape)
        self._moe_out(tape)
        return logits

    def _verify(self, tokens, pos, length, tables, samp):
        """The verify program: score a draft run (`verify_paged`), pick
        the target's token at every fed position (column j's token will
        occupy pos + j + 1, the key sequential decode would have used)
        and count the leading drafts equal to those picks.  Returns (b,
        c + 1) on the device: the picks, then the count."""
        tape = [] if self._moe else None
        logits, _ = self.model.verify_paged(self._params, self._cache,
                                            tokens, pos, length, tables,
                                            moe_tape=tape)
        self._moe_out(tape)
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
        tape = [] if self._moe else None
        toks, _ = self.model.decode_megastep(
            self._params, self._cache, token, pos, left, eos, tables,
            self._mega_m, lambda logits, newpos: self._pick_dev(
                logits, samp, newpos), moe_tape=tape)
        self._moe_out(tape)
        return toks

    # -- MoE routing telemetry -----------------------------------------------
    def _moe_out(self, tape):
        """Record an MoE launch's routed-row counts: the tape's entries
        summed into ONE (E,) row on the device, whose copy to the host
        starts now without a wait (the JAX engine's extra program output,
        diverted by `_unpack`).  A dense model records nothing."""
        if not self._moe or not tape:
            return
        self._moe_pending.append(self._to_host(torch.stack(tape).sum(dim=0)))

    def _drain_moe(self, keep_last=True):
        """Fold pending launch counts into the host total and publish the
        ``serve.<name>.expert_load.<i>`` gauges.  ``keep_last`` (the
        scheduler's call, once an iteration) folds only the counts whose
        copy has landed, in launch order, and never waits, so a launch
        still in flight (a megastep) keeps its overlap; False waits for
        every one."""
        if not self._moe:
            return
        pend = self._moe_pending
        n = 0
        for host, done in pend:
            if done is not None:
                if keep_last and not done.query():
                    break
                if not keep_last:
                    done.synchronize()
            self._moe_load += host.numpy().astype(np.int64)
            n += 1
        if n == 0:
            return
        del pend[:n]
        for i, v in enumerate(self._moe_load):
            telemetry.set_gauge(self._gauge + "expert_load.%s" % i, int(v))

    def expert_load(self):
        """The cumulative per-expert routed row counts (padding rows
        included) as a host array, or None for a dense model.  Waits for
        every pending count: a report surface, not a scheduler call."""
        if not self._moe:
            return None
        self._drain_moe(keep_last=False)
        return self._moe_load.copy()

    def memory_footprint(self):
        """Device-memory accounting of the params and the K/V buffers, the
        JAX engine's keys: ``total_bytes`` (the whole replica),
        ``per_device_bytes`` (the largest share one device of the group
        holds, counted by shard position, so it shrinks with the shard
        count on one card too) and ``devices`` (shard positions; 1 for an
        unsharded engine).  Beside them ``per_shard_bytes`` and
        ``physical_device_bytes``: the bytes each distinct device really
        holds (shards that share a card add up there)."""
        if self._mesh is not None:
            return self.model.footprint(self._params, self._cache)
        total = sum(t.numel() * t.element_size() for t in
                    list(self._params.values())
                    + self.model.cache_leaves(self._cache))
        return {"total_bytes": int(total), "per_device_bytes": int(total),
                "devices": 1, "per_shard_bytes": [int(total)],
                "physical_device_bytes": {str(self.device): int(total)}}

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
        if self._tier is not None or (self._paged and self.role == "decode"):
            # the restore's scatter, which a decode replica's handoff
            # landings take too
            staged, ready = self._stage_run(self.model.block_run_placeholder(
                1, self.block_size, pin=self._side is not None))
            self._await_staged(staged, ready)
            self.model.write_block(self._cache, self._put(
                np.full((1,), TRASH_BLOCK, np.int64)), staged)
        # the JAX engine compiles its programs without running them: its
        # pool starts zeroed and its routing counts at zero.  Warmup wrote
        # only the trash block (or slot), which a finished row's megastep
        # steps read: zero the cache again, so they route as the JAX
        # engine's do, and drop warmup's counts
        for t in self.model.cache_leaves(self._cache):
            t.zero_()
        self._moe_pending.clear()
        return {"prefill": list(self.prefill_buckets),
                "decode": list(self.decode_buckets),
                "cache": "paged" if self._paged else "slot",
                "block_size": self.block_size, "n_blocks": self.n_blocks,
                "prefix": self._prefix is not None,
                "tier": None if self._tier is None else
                {"host_blocks": self._tier.capacity,
                 "restore_ahead": self._restore_ahead},
                "spec": None if not self._spec else
                {"k": self._spec_k, "drafter": self._drafter.name},
                "megastep": None if not self._mega_m else
                {"m": self._mega_m},
                "quant": None if not self._quant_gate else
                {"weights": None if self._quant is None
                 else self._quant.name,
                 "kv": None if self._kv_quant is None
                 else self._kv_quant.name}}

    def respawn(self, name=None):
        """A replacement engine for this (dead) replica: the same device,
        geometry, name and admission settings, the parameters shared (no
        copy), a fresh K/V cache and scheduler state.  ``name`` names a
        new replica templated off this one instead."""
        return ServingEngine(
            self._base_model, self._params,
            ctx=self.device if self._mesh is None else self._mesh,
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
            megastep_steps=self._mega_m or None,
            tier=self._tier is not None, host_blocks=self._host_blocks,
            restore_ahead=self._restore_ahead,
            quant=self._quant if self._quant is not None else "0",
            kv_quant=self._kv_quant if self._kv_quant is not None else "0")

    # -- sessions ------------------------------------------------------------
    def has_session(self, key):
        """Whether this engine holds session ``key``'s history (the
        router's affinity signal: the K/V is likely still here, on the
        card or in the host tier)."""
        with self._slock:
            return key in self._sessions

    def _session_prompt(self, key, prompt):
        """Session ``key``'s stored history followed by this turn's
        ``prompt`` (unchanged for a first turn).  A turn submitted while
        the previous one is unresolved raises.  Passing the guard claims
        the turn under the lock (a `_SessionClaim` becomes the live
        entry), so of two racing submits the second raises; `submit`
        resolves the claim (`_session_record` on admission,
        `_session_unclaim` when admission sheds or raises)."""
        with self._slock:
            ent = self._sessions.get(key)
            if ent is None:
                return prompt
            hist, prev = ent
            if prev is not None and not prev.done:
                raise MXNetError(
                    "ServingEngine %s: session %r has an unresolved turn "
                    "(request %d) — wait for its result before submitting "
                    "the next turn" % (self.name, key, prev.id))
            self._sessions[key] = (hist, _SessionClaim(prev))
            self._sessions.move_to_end(key)
            hist = list(hist)
        return hist + [int(t) for t in np.asarray(prompt).reshape(-1)]

    def _session_record(self, key, req):
        """The claimed turn was admitted: the request becomes the
        session's live entry (history advances only at
        `_session_store`).  Follow-up hits count here, at admission, so a
        shed submit never counts one."""
        with self._slock:
            ent = self._sessions.get(key)
            hist = ent[0] if ent is not None else []
            self._sessions[key] = (hist, req)
            self._sessions.move_to_end(key)
            self.stats["session_turns"] += 1
            if hist:
                self.stats["session_hits"] += 1
            self._trim_sessions_locked()
        if hist:
            self._count("session_hits")

    def _session_unclaim(self, key):
        """Admission shed or raised after the claim: the previous turn is
        the live entry again, so the conversation stays retryable."""
        with self._slock:
            ent = self._sessions.get(key)
            if ent is not None and isinstance(ent[1], _SessionClaim):
                self._sessions[key] = (ent[0], ent[1].prev)

    def _session_store(self, req):
        """A session turn completed: its full history (the expanded
        prompt and every generated token) is what the next turn builds
        on.  The K/V needs no copy: its full blocks are in the prefix
        index, park at release and spill under pressure.  Runs on the
        scheduler thread before `_finish` sets done, so the guard never
        admits a follow-up against a missing history."""
        with self._slock:
            self._sessions[req.session] = (
                list(req.prompt) + [int(t) for t in req.tokens], req)
            self._sessions.move_to_end(req.session)
            self._trim_sessions_locked()

    def _trim_sessions_locked(self):
        """Hold ``MXNET_SERVE_SESSION_CAP`` (the caller holds `_slock`)."""
        while len(self._sessions) > self._session_cap:
            self._sessions.popitem(last=False)

    # -- submission and admission control ----------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, temperature=0.0, top_k=0, top_p=1.0,
               seed=None, session=None, on_token=None, _count_shed=True):
        """Queue a request; returns its `ServeRequest`.  ``on_token(t)``,
        if given, is called on the scheduler's thread with each generated
        token, once, in order.  ``session`` continues that conversation:
        its stored history goes before ``prompt``."""
        if session is None:
            return self._submit(prompt, max_new_tokens, eos_id, deadline_ms,
                                temperature, top_k, top_p, seed, None,
                                on_token, _count_shed)
        prompt = self._session_prompt(session, prompt)  # claims the turn
        try:
            return self._submit(prompt, max_new_tokens, eos_id, deadline_ms,
                                temperature, top_k, top_p, seed, session,
                                on_token, _count_shed)
        except BaseException:
            # refused after the claim: the session is as it was
            self._session_unclaim(session)
            raise

    def _submit(self, prompt, max_new_tokens, eos_id, deadline_ms,
                temperature, top_k, top_p, seed, session, on_token,
                _count_shed):
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
                           top_k=top_k, top_p=top_p, seed=seed,
                           session=session)
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
        if session is not None:
            # only an admitted request becomes the session's live turn
            self._session_record(session, req)
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
        # every enqueue (submit, redispatch, migration, handoff replay)
        # opens the trace (idempotent: a requeued request keeps its root
        # and its t_submit) and flips its interval phase to queue_wait
        tracing.open_trace(req.id, self.name, t=req.t_submit)
        tracing.phase(req.id, "queue_wait", self.name, depth=depth)
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
                len(self._prefilling) + len(self._restoring) + \
                len(self._active) + len(self._landing) + \
                len(self._handoff_inbox)

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
        tracing.dump(self.name, "quarantine", request=req.id)
        req._finish(error=ServeQuarantined(msg[:500]))

    def _requeue_once(self, req, what, reason):
        """A request whose cached context died with the cache: back to
        the queue front for one retry against the fresh cache, then
        quarantined."""
        if req._requeues < 1:
            req._requeues += 1
            with self._qlock:
                self._queue.appendleft(req)
            tracing.phase(req.id, "queue_wait", self.name,
                          requeue="cache_rebuild")
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
            for row, rs in list(self._restoring.items()):
                # a staged restore's target blocks died with the pool:
                # the same one retry as a mid-stream prefill
                del self._restoring[row]
                self._free.append(row)
                rs.blocks = None
                self._release_src(rs)
                self._requeue_once(rs.req, "restore lost to a cache rebuild "
                                   "twice: %s", reason)
            for row, ld in list(self._landing.items()):
                # a staged landing's target blocks died with the pool: the
                # request takes the journal's exact replay
                del self._landing[row]
                self._free.append(row)
                ld.blocks = None
                self._release_src(ld)
                self._handoff_lost(ld.ticket.req, "handoff landing lost to "
                                   "a cache rebuild: %s" % reason[:200])
            if self._prefix is not None:
                self._prefix.clear()  # the pool its nodes point at is gone
            if self._tier is not None:
                # the host copies are unreachable without the index
                self._tier.clear()
                telemetry.set_gauge(self._gauge + "host_blocks_used", 0)
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
        tracing.dump(self.name, "cache_rebuild", detail=reason[:200])

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
        tracing.phase(req.id, "prefill", self.name, prompt_len=plen)
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
        if first < 0:
            # the quantization gate (no token emitted yet: the retry
            # replays the whole prompt; the slot cache has no blocks or
            # index to scrub)
            self._free.append(slot)
            self._quant_trip_req(req, "prefill")
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
            tracing.phase(req.id, "decode", self.name, pos=plen)
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

    def leaked_host_blocks(self):
        """Host-tier blocks no prefix node references: 0 whenever the
        scheduler is quiet (every tier entry belongs to exactly one radix
        node; a staged restore holds device copies, not handles)."""
        if self._tier is None:
            return 0
        return self._tier.used - self._prefix.host_count

    # -- the host-DRAM tier ------------------------------------------------
    def _spill_block(self, block, tokens, node):
        """`PrefixCache` eviction hook: copy the evicted block's K/V to
        the host tier so the prefix survives below the card.  Returns the
        host handle, or None (`spill_fail` chaos, or a failed copy), upon
        which the cache detaches the node as an engine without a tier
        would.  On a card the tier copies non-blocking into its
        page-locked slab on the pool's stream, so the copy runs before any
        later write to the freed block, and the tier waits on its event
        before a read."""
        if self._tier is None:
            return None
        if chaos.enabled() and chaos.serve_spill_fail():
            self.stats["spill_fails"] += 1
            self._count("spill_fails")
            return None
        try:
            handle, evicted = self._tier.put(
                self.model.slice_block(self._cache, block))
        except Exception as e:  # noqa: BLE001 -- degrade, never escalate
            self.stats["spill_fails"] += 1
            self._count("spill_fails")
            telemetry.record_event("serve_spill_failed", replica=self.name,
                                   block=int(block), error=str(e)[:200])
            return None
        for h in evicted:
            # the tier's own LRU forgot its oldest blocks: detach them
            for orphan in self._prefix.drop_host(h):
                self._tier.free(orphan)
        self.stats["spilled"] += 1
        self._count("spilled")
        telemetry.set_gauge(self._gauge + "host_blocks_used",
                            self._tier.used)
        return handle

    def _host_dropped(self, handle):
        """`PrefixCache` host-drop hook: the index dropped its reference,
        so the tier drops the block."""
        if self._tier is not None:
            self._tier.free(handle)
            telemetry.set_gauge(self._gauge + "host_blocks_used",
                                self._tier.used)

    def _drop_host_node(self, node):
        """Drop one host-resident node and its host subtree from the
        index and the tier: after a failed restore the retry takes the
        prefill road instead of the same restore."""
        if node.tier != "host":
            return
        handle = node.block
        orphans = self._prefix.drop_host(handle)
        self._tier.free(handle)
        for h in orphans:
            self._tier.free(h)
        telemetry.set_gauge(self._gauge + "host_blocks_used",
                            self._tier.used)

    def _restore_buckets(self):
        """Power-of-two restore run lengths up to the table width."""
        out, k = [], 1
        while k < self._n_table:
            out.append(k)
            k *= 2
        return out + [self._n_table]

    def _restore_bucket(self, n):
        for k in self._restore_buckets():
            if k >= n:
                return k
        raise MXNetError(
            "ServingEngine %s: restore run %d exceeds the table width %d"
            % (self.name, n, self._n_table))

    def _stage_run(self, data, after=None):
        """Start a packed block run's copy to the device: on a card a
        non-blocking copy from pinned memory on the side stream, behind
        an event the landing scatter waits on (so it overlaps the
        current iteration's launches); on the CPU a plain copy.  ``after``
        is an event the copy must wait for (a handoff's device-to-host
        copy into ``data``).  Returns (staged, ready)."""
        leaves = data if isinstance(data, tuple) else (data,)
        if self._side is None:
            staged = tuple(t.to(self.device) for t in leaves)
            return (staged if isinstance(data, tuple) else staged[0]), None
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        if after is not None:
            self._side.wait_event(after)
        with torch.cuda.stream(self._side):
            staged = tuple(t.to(self.device, non_blocking=True)
                           for t in leaves)
            ready = torch.cuda.Event()
            ready.record(self._side)
        return (staged if isinstance(data, tuple) else staged[0]), ready

    def _await_staged(self, staged, ready):
        """Order the pool's stream behind a staged run's copy: it waits on
        the copy's event on the device (no host sync), and the staged
        tensors, allocated on the side stream, are marked as used on this
        one so the allocator does not hand their memory out early."""
        if ready is None:
            return
        main = torch.cuda.current_stream(self.device)
        main.wait_event(ready)
        for t in (staged if isinstance(staged, tuple) else (staged,)):
            t.record_stream(main)

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
                + [(p.blocks, p.done) for p in self._prefilling.values()] \
                + [(r.blocks, r.done) for r in self._restoring.values()] \
                + [(ld.blocks, ld.ticket.pos)
                   for ld in self._landing.values()]:
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
        if self._prefix is None:
            shared, host_nodes = [], []
        else:
            shared, host_nodes = self._prefix.lookup_plan(tokens)
            if host_nodes and (self._tier is None or len(self._restoring)
                               >= self._restore_ahead):
                # no restore slot: the miss path never waits behind a
                # restore, so admit on the device match alone; the host
                # blocks are touched so a prefix that keeps matching
                # cannot age out of the host LRU unused
                if self._tier is not None:
                    for node in host_nodes:
                        self._tier.touch(node.block)
                host_nodes = []
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
        # stage the host run's copy (restore, then acquire): packed into
        # one buffer, copied now under this iteration's launches, landed
        # next iteration (_advance_restores).  A handle the tier forgot in
        # the window cuts the run short: coverage must be contiguous
        t_stage = time.perf_counter()
        nodes, handles, arrs, dst = [], [], [], []
        for node in host_nodes:
            arr = self._tier.get(node.block)
            if arr is None:
                break
            nodes.append(node)
            handles.append(node.block)
            arrs.append(arr)
            dst.append(fresh[len(nodes) - 1])
        # hits count only for admissions that land: a denied one retries
        # its lookup every iteration, and a restore counts at its landing
        if self._prefix is not None and not nodes:
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
        if nodes:
            kb = self._restore_bucket(len(nodes))
            data = pack_block_run(self.model, self.block_size, arrs, kb,
                                  pin=self._side is not None)
            dsts = np.full((kb,), TRASH_BLOCK, np.int64)
            dsts[:len(dst)] = dst
            staged, ready = self._stage_run(data)
            self._restoring[row] = _Restore(
                req, row, list(tokens), blocks, matched, nodes, handles,
                staged, self._put(dsts), dst, kb, t_stage, src=data,
                ready=ready)
            tracing.phase(req.id, "restore_wait", self.name, t=t_stage,
                          blocks=len(nodes))
            return True
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
            if self._maybe_handoff(req, row, tokens, blocks, last, pos,
                                   n_new):
                return
            if self._drafter is not None and n_new:
                # the replayed generation seeds the drafter, so its
                # accept rate holds from the first round on
                self._drafter.on_resume(list(tokens) + [last])
            seq = _Seq(req, last, pos, blocks=blocks, ctx=list(tokens[:pos]))
            seq.n_new = n_new
            tracing.phase(req.id, "decode", self.name, pos=pos,
                          bootstrap=True)
            self._active[row] = seq
            return
        # a resumed admission re-prefills context it already generated
        # once: attributed as `replay`, not `prefill`
        tracing.phase(req.id,
                      "replay" if req._resume is not None else "prefill",
                      self.name, covered=covered, total=len(tokens))
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

    # -- host-tier restore landing -------------------------------------------
    def _drop_restore(self, rs):
        """Remove a staged restore: its row and blocks go back (the staged
        copy never joined the pool); the caller resolves the request."""
        self._restoring.pop(rs.row, None)
        self._free.append(rs.row)
        self._release_blocks(rs)
        self._release_src(rs)

    def _release_src(self, rs):
        """Let go of a restore's pinned source once its copy has passed:
        until then it waits in `_landed_src`, pruned at every release."""
        if rs.ready is not None:
            self._landed_src = [(e, t) for e, t in self._landed_src
                                if not e.query()]
            self._landed_src.append((rs.ready, rs.src))
        rs.src = rs.ready = None

    def _advance_restores(self):
        """Land every restore staged in an earlier iteration (its copy
        rode under that iteration's launches).  Runs before the prefill
        chunks, so a restore with an uncached suffix advances its first
        chunk in this same iteration."""
        for rs in list(self._restoring.values()):
            if self._restoring.get(rs.row) is rs:
                self._complete_restore(rs)

    def _complete_restore(self, rs):
        """Scatter one staged restore into the pool and route the
        admission on.  Failure scoping as at a prefill chunk: a dead
        device is fatal; a half-written pool (the scatter's write mark)
        rebuilds, requeueing every staged restore; a scoped fault drops
        the host entries involved and requeues the request, whose retry
        prefills what the restore would have copied.  Never a hang, never
        a leak in either tier."""
        req = rs.req
        ms = chaos.serve_restore_slow()
        if ms:
            time.sleep(ms / 1e3)
        try:
            if chaos.serve_launch_error():
                raise chaos.ChaosError(
                    "chaos: injected restore launch error")
            self._await_staged(rs.staged, rs.ready)
            self._write_restore(rs)
        except Exception as e:
            kind = self._classify_failure(e)
            if kind == "device":
                self._drop_restore(rs)
                req._finish(error=ServeEngineDead(
                    "restore launch failed: %s" % str(e)[:400]))
                raise _EngineFatal("restore launch failed: %s" % e) from e
            if kind == "cache":
                self._rebuild_cache("restore launch failed: %s" % e)
                return
            self.stats["restore_fails"] += 1
            self._count("restore_fails")
            telemetry.record_event("serve_restore_failed", replica=self.name,
                                   request=req.id, error=str(e)[:200])
            self._drop_restore(rs)
            for node in rs.nodes:
                self._drop_host_node(node)
            with self._qlock:
                self._queue.appendleft(req)
            tracing.phase(req.id, "queue_wait", self.name,
                          requeue="restore_failed")
            return
        # landed: the nodes flip back to device residency (keeping their
        # host copies); one upgraded or dropped in the window leaves its
        # restored block the sequence's own
        for node, handle, dstb in zip(rs.nodes, rs.handles, rs.dst):
            self._prefix.restore_landed(node, handle, dstb)
        n_host = len(rs.nodes)
        covered = rs.done + n_host * self.block_size
        self.stats["prefix_lookup_tokens"] += len(rs.tokens)
        self._count_prefix_hit(covered)
        self.stats["restored"] += n_host
        self._count("restored", n_host)
        self.stats["restored_tokens"] += n_host * self.block_size
        telemetry.observe("serve.restore_wait_ms",
                          1e3 * (time.perf_counter() - rs.t_stage))
        telemetry.set_gauge(self._gauge + "host_blocks_used",
                            self._tier.used)
        del self._restoring[rs.row]
        self._release_src(rs)
        if self._drafter is not None and self._drafter.mirrors_pool:
            # the drafter's mirrored pool follows: draft-prefill the span
            # the target just got back as bytes
            self._drafter_restore_span(rs.tokens, rs.blocks, rs.done,
                                       covered)
        self._enter_decode_or_prefill(req, rs.row, rs.tokens, rs.blocks,
                                      covered)

    def _drafter_restore_span(self, tokens, blocks, start, end):
        """Feed a restored block-aligned span to the drafter as prefill
        chunks of the engine's bucket shapes."""
        pos = start
        largest = self.prefill_buckets[-1]
        while pos < end:
            remaining = end - pos
            bucket = largest if remaining > largest else \
                self._bucket_for(remaining, self.prefill_buckets)
            chunk = min(remaining, bucket)
            self._drafter.on_restore_span(*self._chunk_inputs(
                tokens[pos:pos + chunk], bucket, pos, blocks))
            pos += chunk

    def _write_restore(self, rs):
        """The restore's scatter (`TransformerKVModel.write_block`): the
        staged run into its destination blocks, the trash block taking
        the bucket's padding."""
        self.model.write_block(self._cache, rs.dst_d, rs.staged)

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
        t_chunk = time.perf_counter()
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
        tracing.add_span(req.id, "prefill_chunk", self.name, t_chunk,
                         time.perf_counter(), start=pf.done - chunk,
                         tokens=chunk)
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
            if self._maybe_handoff(req, pf.row, pf.tokens, blocks, last, pos,
                                   n_new):
                return
            seq = _Seq(req, last, pos, blocks=blocks, ctx=pf.tokens)
            seq.n_new = n_new
            if self._drafter is not None and n_new:
                self._drafter.on_resume(list(pf.tokens) + [last])
            tracing.phase(req.id, "decode", self.name, pos=pos,
                          resumed=True)
            self._active[pf.row] = seq
            return
        if first < 0:
            # the quantization gate on the prompt's final chunk: scrub the
            # blocks it read (a shared prefix with bad scales must not be
            # acquired again by the retry), release them, requeue once
            self._free.append(pf.row)
            self._scrub_quant(blocks)
            self._drop_refs(blocks)
            self._block_gauges()
            self._quant_trip_req(req, "prefill")
            return
        req.t_first = time.perf_counter()
        req.tokens.append(first)
        self.stats["tokens"] += 1
        telemetry.inc("serve.tokens")
        seq = _Seq(req, first, total, blocks=blocks, ctx=pf.tokens)
        if self._seq_finished(seq, first):
            self._retire(pf.row, seq, enter=False)
        elif not self._maybe_handoff(req, pf.row, pf.tokens, blocks, first,
                                     total, 1):
            tracing.phase(req.id, "decode", self.name, pos=total)
            self._active[pf.row] = seq
        # the first token publishes from the source, once; the decode side
        # resumes at n_new 1
        req._publish()

    # -- disaggregated prefill/decode handoff --------------------------------
    def _pack_run(self, blocks, kb):
        """The handoff's pack: the pool rows of ``blocks`` (every layer, K
        and V, and under KV quant their scales), gathered on the device
        into one run padded with the trash block to ``kb`` blocks, copied
        into one pinned host buffer (`block_run_placeholder`), non-blocking
        on a card.  The gather is queued on the pool's stream after the
        prefill's last write and before any later one, so the blocks may
        go back to the allocator at once.  Returns (host run, the event
        its copy is behind, None on the CPU)."""
        idx = self._put(np.asarray(list(blocks) + [TRASH_BLOCK]
                                   * (kb - len(blocks)), np.int64))
        run = self.model.gather_blocks(self._cache, idx)
        if self.device.type != "cuda":
            return run, None
        data = self.model.block_run_placeholder(kb, self.block_size, pin=True)
        for h, d in zip(data if isinstance(data, tuple) else (data,),
                        run if isinstance(run, tuple) else (run,)):
            h.copy_(d, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return data, ready

    def _maybe_handoff(self, req, row, tokens, blocks, last, pos, n_new):
        """On a prefill replica, retire a sequence whose context is cached
        into a handoff instead of decoding it: pack its block run, hand a
        `HandoffTicket` to the router's sink and free the row and blocks
        here.  True when the sequence was consumed (handed off, or failed
        over to the journal's replay): the caller must not decode it.  A
        colocated engine (role None) returns False at once."""
        if self._handoff_sink is None or self.role != "prefill" \
                or not self._paged or req._no_handoff or pos <= 0:
            return False
        t_pack = time.perf_counter()  # the handoff's wait opens here
        try:
            if chaos.enabled() and chaos.serve_handoff_fail():
                raise chaos.ChaosError(
                    "chaos: injected handoff transfer death")
            k = (pos + self.block_size - 1) // self.block_size
            kb = self._restore_bucket(k)
            data, ready = self._pack_run(blocks[:k], kb)
            ticket = HandoffTicket(req, list(tokens[:pos]), last, pos, n_new,
                                   data, k, kb, self.name, t_start=t_pack,
                                   ready=ready)
            ctx = tracing.context(req.id)
            if ctx is not None:
                # the ticket carries (trace id, root span id) across the
                # role boundary; the decode side adopts it at receive
                ticket.trace, ticket.parent = ctx
        except Exception as e:  # noqa: BLE001 -- degrade to replay
            self._free.append(row)
            self._drop_refs(blocks)
            self._block_gauges()
            self._handoff_lost(req, "handoff pack failed: %s" % e)
            return True
        # the source is done with the sequence whatever happens next: the
        # run is on its way to the host and the resume tuple in the ticket
        self._free.append(row)
        self._drop_refs(blocks)
        self._block_gauges()
        # handoff_wait opens at the pack's start: the attributed wait
        # covers pack, transfer and landing, as serve.handoff_wait_ms does
        tracing.phase(req.id, "handoff_wait", self.name, t=t_pack,
                      blocks=ticket.k, nbytes=ticket.nbytes)
        tracing.add_span(req.id, "handoff_pack", self.name, t_pack,
                         time.perf_counter(), blocks=ticket.k,
                         nbytes=ticket.nbytes)
        try:
            self._handoff_sink(ticket)
        except Exception as e:  # noqa: BLE001 -- no live decode replica
            self._handoff_lost(req, "handoff dispatch failed: %s" % e)
            return True
        self.stats["handoffs"] += 1
        self._count("handoffs")
        telemetry.inc("serve.handoff_bytes", ticket.nbytes)
        return True

    def _handoff_lost(self, req, msg):
        """A handoff died (pack, dispatch, chaos, a dead target, a cache
        rebuild under a staged landing): count it and hand the request to
        the router's exact replay; only when that road is closed too does
        it fail, typed."""
        self.stats["handoff_fails"] += 1
        self._count("handoff_fails")
        telemetry.record_event("serve_handoff_fail", replica=self.name,
                               request=req.id, error=str(msg)[:200])
        tracing.dump(self.name, "handoff_fail", request=req.id,
                     error=str(msg)[:200])
        ok = False
        if self._handoff_fallback is not None:
            try:
                ok = self._handoff_fallback(req)
            except Exception:  # noqa: BLE001 -- fall through to typed
                ok = False
        if not ok and not req.done:
            req._finish(error=ServeEngineDead(
                "handoff failed with no replay road: %s" % str(msg)[:300]))

    def receive_handoff(self, ticket):
        """Accept one ticket into this decode replica's inbox (any
        thread).  Raises `ServeEngineDead` on a dead, draining or stopped
        replica, so the router redirects the ticket instead of racing
        the admission close."""
        if not self._paged:
            raise MXNetError("receive_handoff: paged serving only")
        # adopt the carried trace context before queueing: this replica's
        # spans parent under the root the prefill side opened
        tracing.adopt(ticket.trace, ticket.parent, replica=self.name)
        with self._qlock:
            self._check_alive_locked()
            self._handoff_inbox.append(ticket)
        self._wake.set()

    def _stage_handoffs(self):
        """Stage received tickets (scheduler thread): take a row and fresh
        blocks and start the run's copy to the card, which rides under
        this iteration's launches; `_advance_landings` lands it next
        iteration.  A denied allocation leaves the ticket queued."""
        while self._free:
            with self._qlock:
                if not self._handoff_inbox:
                    return
                ticket = self._handoff_inbox.popleft()
            req = ticket.req
            if req.done:
                continue
            row = self._free.pop()
            fresh = self._alloc_blocks(self._alloc.blocks_for(ticket.pos + 1))
            if fresh is None:
                self._free.append(row)
                self.stats["alloc_denied"] += 1
                self._count("alloc_denied")
                with self._qlock:
                    self._handoff_inbox.appendleft(ticket)
                return
            dsts = np.full((ticket.kb,), TRASH_BLOCK, np.int64)
            dsts[:ticket.k] = fresh[:ticket.k]
            staged, ready = self._stage_run(ticket.data, after=ticket.ready)
            self._landing[row] = HandoffLanding(ticket, row, fresh, staged,
                                                self._put(dsts), ready=ready)
            self._block_gauges()

    def _drop_landing(self, ld):
        """Remove a staged landing: its row and blocks go back; the caller
        resolves the request."""
        self._landing.pop(ld.row, None)
        self._free.append(ld.row)
        self._release_blocks(ld)
        self._release_src(ld)

    def _advance_landings(self):
        """Land every handoff staged in an earlier iteration."""
        for ld in list(self._landing.values()):
            if self._landing.get(ld.row) is ld:
                self._complete_landing(ld)

    def _complete_landing(self, ld):
        """Scatter one staged run into its blocks (the restore's
        `write_block`), register the context's full blocks in this
        replica's prefix index and enter decode at the ticket's resume
        tuple.  Failure scoping as at a restore: a dead device is fatal,
        a half-written pool rebuilds, a scoped fault drops the run and
        falls back to the journal's replay."""
        t = ld.ticket
        req = t.req
        t_land = time.perf_counter()
        try:
            if chaos.serve_launch_error():
                raise chaos.ChaosError(
                    "chaos: injected handoff landing launch error")
            self._await_staged(ld.staged, ld.ready)
            self.model.write_block(self._cache, ld.dst_d, ld.staged)
        except Exception as e:
            kind = self._classify_failure(e)
            if kind == "device":
                self._drop_landing(ld)
                req._finish(error=ServeEngineDead(
                    "handoff landing failed: %s" % str(e)[:400]))
                raise _EngineFatal("handoff landing failed: %s" % e) from e
            if kind == "cache":
                self._rebuild_cache("handoff landing failed: %s" % e)
                return
            self._drop_landing(ld)
            self._handoff_lost(req, "handoff landing failed: %s" % e)
            return
        # the context's full blocks publish here, where decode happens (a
        # session's follow-up turn shares them)
        self._register_prefix(t.ctx, ld.blocks, t.pos)
        self.stats["handoffs_in"] += 1
        self._count("handoffs_in")
        now = time.perf_counter()
        telemetry.observe("serve.handoff_wait_ms", 1e3 * (now - t.t_start))
        tracing.add_span(req.id, "handoff_land", self.name, t_land, now,
                         blocks=t.k, src=t.src)
        tracing.phase(req.id, "decode", self.name, pos=t.pos,
                      handoff=t.src)
        del self._landing[ld.row]
        self._release_src(ld)
        if self._drafter is not None and t.n_new:
            self._drafter.on_resume(list(t.ctx) + [t.last])
        seq = _Seq(req, t.last, t.pos, blocks=ld.blocks, ctx=list(t.ctx))
        seq.n_new = t.n_new
        self._active[ld.row] = seq
        self._block_gauges()

    def _pending_work(self):
        """Admitted work not yet decoding: mid-stream prefills, staged
        restores and landings, received tickets.  A scheduler iteration
        is idle only when these and the active set are empty."""
        return len(self._prefilling) + len(self._restoring) + \
            len(self._landing) + len(self._handoff_inbox)

    def decode_depth(self):
        """Decode load for the router's handoff targeting: active rows and
        the handoffs this replica owes (staged or in its inbox)."""
        with self._qlock:
            return len(self._active) + len(self._landing) + \
                len(self._handoff_inbox)

    def prefill_backlog(self):
        """Prompt tokens queued or mid-stream here: the dispatch key of
        prefill replicas (queue depth alone starves short prompts behind a
        storm).  A load signal read without the scheduler's state lock."""
        with self._qlock:
            t = sum(len(r.prompt) for r in self._queue)
            for pf in list(self._prefilling.values()):
                t += max(0, len(pf.tokens) - pf.done)
        return t

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
        tracing.phase(req.id, "queue_wait", self.name, requeue="preempt",
                      pos=pf.done)

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

    def _vacate_row(self, row, seq, capture_resume=True):
        """Take an active row out for a later exact replay: leave the
        decode set, free the row, capture ``(ctx, last, pos, n_new)``
        (the cache holds rows [0, pos), exactly ``ctx``) and release the
        blocks once.  The one core of preemption and of a quantization
        gate trip (`_quant_trip_seq`)."""
        del self._active[row]
        self._free.append(row)
        req = seq.req
        if capture_resume:
            req._resume = (list(seq.ctx), seq.last, seq.pos, seq.n_new)
            req._preempt_n_new = seq.n_new
        self._release_blocks(seq)
        return req

    # -- quantization gate trips ------------------------------------------
    def _scrub_quant(self, blocks):
        """A tripped row's blocks may include shared prefix blocks whose
        scales are bad: detach them and their subtrees from the prefix
        index, so no later lookup acquires them again, and reclaim those
        that were parked.  The retry prefills fresh blocks."""
        if self._prefix is None or not blocks:
            return
        freed = self._prefix.invalidate(blocks)
        if freed:
            self._alloc.reclaim(freed)
            self._count_evictions(len(freed))

    def _quant_trip_req(self, req, where, requeue=True):
        """The gate tripped for ``req`` (its program picked -1): count,
        then requeue once for a clean retry; the second trip, or a path
        with no exact replay (a slot-cache row mid-generation), fails it
        with `ServeQuantError`.  Never a token the gate flagged."""
        self.stats["quant_trips"] += 1
        self._count("quant.trips")
        telemetry.record_event("serve_quant_trip", replica=self.name,
                               request=req.id, where=where)
        if requeue and req._requeues < 1:
            req._requeues += 1
            with self._qlock:
                self._queue.appendleft(req)
            tracing.phase(req.id, "queue_wait", self.name,
                          requeue="quant_trip")
        else:
            req._finish(error=ServeQuantError(
                "ServeRequest %d: quantization logit gate tripped (%s) — "
                "nonfinite or out-of-range logits under quantized "
                "weights/KV (corrupted scales?); the request was retried "
                "once and is quarantined rather than emitting unverified "
                "tokens" % (req.id, where)))

    def _quant_trip_seq(self, row, seq, where="decode"):
        """A trip on an active row: leave the decode set, scrub the row's
        blocks from the prefix index, release them once and requeue by
        exact replay (the tokens already emitted passed the gate).  A
        slot-cache row has no replay, so it fails at once."""
        replayable = self._paged and seq.blocks is not None
        if replayable:
            self._scrub_quant(seq.blocks)
        req = self._vacate_row(row, seq,
                               capture_resume=replayable
                               and seq.req._requeues < 1)
        self._quant_trip_req(req, where, requeue=replayable)

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
        tracing.phase(req.id, "queue_wait", self.name, requeue="preempt",
                      pos=seq.pos)

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
        if seq.req.session is not None:
            # the turn's full history is the session's context now; its
            # registered blocks just parked, so the follow-up is a prefix
            # hit, on the card or through the tier
            self._session_store(seq.req)
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
        for rs in list(self._restoring.values()):
            # a deadline passing mid-restore resolves like any holder's
            r = rs.req
            if r._cancelled or r.expired(now):
                dropped.append(r)
                self._drop_restore(rs)
        for ld in list(self._landing.values()):
            r = ld.ticket.req
            if r._cancelled or r.expired(now):
                dropped.append(r)
                self._drop_landing(ld)
        with self._qlock:
            if any(t.req._cancelled or t.req.expired(now)
                   for t in self._handoff_inbox):
                keep = deque()
                for t in self._handoff_inbox:
                    if t.req._cancelled or t.req.expired(now):
                        dropped.append(t.req)
                    else:
                        keep.append(t)
                self._handoff_inbox = keep
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
            if t < 0:
                # the quantization gate: never emit the flagged token
                self._quant_trip_seq(row, seq)
                continue
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
        # the expert counts whose copy has landed go to the gauges
        self._drain_moe()
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
        """Chaos's per-iteration faults: the queue flood, under KV quant
        `scale_corrupt`, and with the prefix cache `prefix_evict` (the LRU
        parked block goes as if allocation pressure claimed it)."""
        self.last_beat = time.monotonic()
        if chaos.enabled():
            self._inject_flood()
            if self._kv_quant is not None:
                u = chaos.serve_scale_corrupt()
                if u is not None:
                    self._corrupt_scales(u)
            if self._prefix is not None and chaos.serve_prefix_evict():
                evicted = self._prefix.evict(1)
                if evicted:
                    self._alloc.reclaim(evicted)
                    self._count_evictions(len(evicted))

    def _corrupt_scales(self, u):
        """`scale_corrupt:P` chaos: NaN one held block's per-row K/V scales
        in the pool (the draw ``u`` picks it from the sorted held blocks),
        so every launch that reads the block dequantizes NaN and the
        logit gate must turn the step into a requeue or `ServeQuantError`."""
        held = sorted(self._alloc._ref)
        if not held:
            return
        blk = held[int(u * len(held)) % len(held)]
        self.model.poison_scales(self._cache, blk)
        self.stats["scale_corrupts"] += 1
        self._count("quant.scale_corrupts")
        telemetry.record_event("serve_scale_corrupt", replica=self.name,
                               block=int(blk))

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
            # restores and handoff landings staged last iteration first:
            # their copies rode under its launches
            self._advance_restores()
            self._advance_landings()
            self._advance_prefills()
            self._stage_handoffs()
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
        return len(self._active) + self._pending_work()

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
        # the overlap window: host work the card no longer waits on
        t_sweep = time.perf_counter()
        self._sweep()
        self._advance_restores()
        self._advance_landings()
        self._advance_prefills()
        self._stage_handoffs()
        self._admit_queued()
        self._count_active()
        if inflight is not None:
            # a crash here kills the replica with the megastep in flight:
            # its tokens were never fetched, so no request holds them
            self._chaos_decode()
            # the replica-scoped host-sweep span
            tracing.add_span(0, "host_sweep", self.name, t_sweep,
                             time.perf_counter())
            self._finish_mega(inflight)
        elif self._active:
            time.sleep(0.001)   # every row is stalled on a denial
        return len(self._active) + self._pending_work()

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
        tracing.add_span(0, "megastep", self.name, t_launch, now,
                         rows=n, bucket=b, m=self._mega_m)
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
            finished = tripped = False
            for j in range(m):
                t = int(out[i, j])
                if t == -2:
                    break
                if t < 0:
                    tripped = True
                    break
                finished = self._advance_one(seq, t)
                adv += 1
                if finished:
                    break
            emitted += adv
            if tripped:
                # the quantization gate: never emit the flagged token
                self._quant_trip_seq(row, seq, "megastep")
            elif finished:
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
        tracing.add_span(0, "spec_round", self.name, t_launch, now,
                         rows=n, bucket=b, k=self._spec_k)
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
            finished = tripped = False
            acc_emitted = 0
            for j in range(n_acc + 1):
                t = int(out[i, j])
                if t < 0:
                    # the quantization gate: the tokens before the flagged
                    # position passed it; the row requeues from here
                    tripped = True
                    break
                emitted += 1
                if j < n_acc:
                    acc_emitted += 1
                if self._advance_one(seq, t):
                    finished = True
                    break
            # a trip discards the tail: count only drafts that were emitted
            n_counted = acc_emitted if tripped else n_acc
            self.stats["spec_accepted"] += n_counted
            if n_counted:
                self._count("spec.accepted", n_counted)
            if tripped:
                self._quant_trip_seq(row, seq, "verify")
            elif finished:
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
                    queued = bool(self._queue) or bool(self._handoff_inbox)
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
        # the postmortem first, while the ring holds the death's lead-up
        tracing.dump(self.name, "scheduler_death", error=msg[:200])
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
        for rs in list(self._restoring.values()):
            self._drop_restore(rs)
            inflight.append(rs.req)
        for ld in list(self._landing.values()):
            # a staged landing dies with this replica: the request joins
            # the failover walk and migrates by exact replay
            self._drop_landing(ld)
            inflight.append(ld.ticket.req)
        with self._qlock:
            while self._handoff_inbox:
                inflight.append(self._handoff_inbox.popleft().req)
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


class ReplicaRouter:
    """Least-depth dispatch over engine replicas, with health monitoring,
    failover and respawn: the port of `mxnet_tpu/serving/engine.py`
    `ReplicaRouter`, on replicas that are whole engines (each on one
    device or one sub-mesh; on one card, all on the same one).

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
    only runs each program once.  A session's follow-up turn goes to a
    replica that holds the session (`ServingEngine.has_session`), and
    `drain` moves the drained replica's sessions with it
    (`_migrate_sessions`).

    ``disagg`` (or ``MXNET_SERVE_DISAGG=1``, with at least two paged
    replicas) gives the first ``prefill_replicas``
    (``MXNET_SERVE_PREFILL_REPLICAS``, 0: a quarter, at least one) the
    prefill role and the rest the decode role (`handoff`): a request
    enters through the prefill replica with the least prompt backlog,
    and its handoff goes to the live decode replica with the least
    decode depth.  A session's follow-up turn goes to the decode replica
    that holds it.  `from_mesh` builds the fleet over a mesh's devices,
    one replica a device or one sub-mesh replica a group of them.
    """

    _MONITOR_PERIOD = 0.2
    _BREAKER_RESET_S = 10.0   # healthy this long clears the breaker

    def __init__(self, engines, respawn=None, journal=None, disagg=None,
                 prefill_replicas=None):
        if not engines:
            raise MXNetError("ReplicaRouter: need at least one engine")
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
        # disaggregated prefill/decode: the first prefill_replicas engines
        # take the prefill role, the rest decode; off, no roles at all
        if disagg is None:
            disagg = disagg_enabled()
        self._disagg = bool(disagg) and len(self.engines) >= 2
        n = len(self.engines)
        if self._disagg:
            if not all(e._paged for e in self.engines):
                raise MXNetError(
                    "ReplicaRouter: MXNET_SERVE_DISAGG needs paged=True on "
                    "every replica (the handoff is a paged block-run "
                    "transfer)")
            p = int(os.environ.get("MXNET_SERVE_PREFILL_REPLICAS", "0")
                    if prefill_replicas is None else prefill_replicas)
            if p <= 0:
                p = max(1, n // 4)
            if p >= n:
                raise MXNetError(
                    "ReplicaRouter: MXNET_SERVE_PREFILL_REPLICAS=%d leaves "
                    "no decode replica among %d" % (p, n))
            self._n_prefill = p
        for i, e in enumerate(self.engines):
            self._wire(e, self._role_for(i))

    def _role_for(self, i):
        if not self._disagg:
            return None
        return "prefill" if i < self._n_prefill else "decode"

    def _wire(self, engine, role):
        """Attach one engine to this router, before its warmup: the death
        hook, the role and, with a role, the handoff sink and the replay
        fallback (a decode replica warms the landing's scatter)."""
        engine._on_death = self._handle_death
        engine.role = role
        if role is not None:
            engine._handoff_sink = self._dispatch_handoff
            engine._handoff_fallback = \
                lambda req, _e=engine: self._handoff_replay(req, source=_e)
        telemetry.set_gauge("serve.%s.role" % engine.name,
                            {"prefill": 1, "decode": 2}.get(role, 0))

    @classmethod
    def from_mesh(cls, model, params, mesh=None, n_replicas=None,
                  devices_per_replica=None, respawn=None, journal=None,
                  disagg=None, prefill_replicas=None, **kw):
        """A router over the devices of ``mesh`` (default: every visible
        CUDA device, one entry each).  ``devices_per_replica`` (or
        ``MXNET_SERVE_SHARDED_DEVICES``, 1) groups consecutive devices
        into sub-mesh replicas, each one sharded engine (a remainder that
        cannot fill a group is dropped); with 1 every device is its own
        replica.  ``n_replicas`` keeps the first ones; the other keywords
        go to every `ServingEngine`."""
        if mesh is not None:
            devices = list(mesh.devices.reshape(-1))
        elif torch.cuda.is_available() and torch.cuda.device_count():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            raise MXNetError(
                "ReplicaRouter.from_mesh: no CUDA device; the port serves "
                "on the card by default, pass a CPU mesh to run on the CPU")
        k = int(os.environ.get("MXNET_SERVE_SHARDED_DEVICES", "1")
                if devices_per_replica is None else devices_per_replica)
        ctxs = submeshes(devices, k) if k > 1 else devices
        if n_replicas is not None:
            ctxs = ctxs[:int(n_replicas)]
        engines = [ServingEngine(model, params, ctx=c, name="replica%d" % i,
                                 **kw)
                   for i, c in enumerate(ctxs)]
        return cls(engines, respawn=respawn, journal=journal,
                   disagg=disagg, prefill_replicas=prefill_replicas)

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

    # -- disaggregated handoff routing -------------------------------------
    def _dispatch_handoff(self, ticket):
        """Stage a ticket on the live decode replica with the least decode
        depth (runs on the source's scheduler thread); dead, stopped and
        draining replicas are fenced out, and `receive_handoff` checks
        again under the target's lock.  Raises `ServeEngineDead` when no
        decode replica takes it: the source then falls back to replay."""
        last = None
        targets = [e for e in self._live_engines() if e.role == "decode"]
        for eng in sorted(targets, key=lambda e: e.decode_depth()):
            try:
                eng.receive_handoff(ticket)
            except ServeError as e:
                last = e
                continue  # died or started draining in the window
            telemetry.record_event(
                "serve_handoff", request=ticket.req.id, source=ticket.src,
                target=eng.name, blocks=ticket.k, nbytes=ticket.nbytes)
            return True
        raise ServeEngineDead(
            "ReplicaRouter: no live decode replica for handoff (%s)" % last)

    def _handoff_replay(self, req, source=None):
        """A failed handoff's fallback: the journal's exact replay on a
        survivor, the road an engine death takes.  ``_no_handoff`` pins
        the retry to plain decode (a replay that handed off again could
        bounce forever); the last resort is the source itself, since a
        prefill replica decoding one stray request beats failing it."""
        req._no_handoff = True
        if req.done:
            return True
        ok = False
        if self._migrate(req, exclude=source):
            ok = True
        elif not req.tokens and self._redispatch(req, exclude=source):
            ok = True
        elif source is not None and \
                (self._migrate(req) or
                 (not req.tokens and self._redispatch(req))):
            ok = True
        if ok:
            telemetry.inc("serve.replays_from_handoff")
            if self.journal is not None:
                self.journal.handoff_replays += 1
        return ok

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
                    self._wire(fresh, e.role)  # the role, before warmup
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
        with self._lock:
            fleet = len(self.engines)
        telemetry.set_gauge("serve.replicas", fleet)
        last_err = None
        session = kw.get("session")
        # two rounds: a replica dying (or respawning) between the snapshot
        # and the submit re-routes instead of failing the request
        for _ in range(2):
            live = self._live_engines()
            if not live:
                break
            shed = 0
            order = sorted(live, key=lambda e: e.depth())
            if self._disagg:
                # a fresh request enters through a prefill replica, by
                # prompt backlog; its handoff picks the decode replica
                pre = [e for e in live if e.role == "prefill"]
                if pre:
                    order = sorted(pre, key=lambda e: e.prefill_backlog())
                telemetry.set_gauge("serve.prefill_depth",
                                    sum(e.depth() for e in pre))
                telemetry.set_gauge(
                    "serve.decode_depth",
                    sum(e.decode_depth() for e in live
                        if e.role == "decode"))
            if session is not None:
                # affinity: a follow-up turn goes only to replicas holding
                # the session (its K/V is there); with none alive it
                # starts afresh.  Disaggregated, the decode replica that
                # served the last turn holds the history (the prefill
                # source keeps only a resolved claim)
                holders = [e for e in live if e.has_session(session)]
                if holders:
                    dec = [e for e in holders if e.role == "decode"]
                    order = sorted(dec or holders, key=lambda e: e.depth())
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
        moved = {}   # id(request) -> the engine its replay landed on
        for req in stragglers:
            if req.done:
                continue
            try:
                target = self._migrate(req, exclude=eng)
                if target:
                    if isinstance(target, ServingEngine):
                        moved[id(req)] = target
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
                self._wire(fresh, eng.role)  # the role, before warmup
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
        # the drained replica's sessions move with it (after the swap, so
        # a straggler's session follows its new engine)
        self._migrate_sessions(eng, moved, dest=fresh)
        return fresh

    def _migrate_sessions(self, eng, moved, dest=None):
        """Move stopped ``eng``'s sessions to the fleet: one whose live
        turn migrated as a straggler follows that turn's engine, every
        other (resolved turn, claim, first-turn record) goes to ``dest``
        (the drain's replacement) or the least-deep live survivor.
        Returns how many moved."""
        with eng._slock:
            sessions = list(eng._sessions.items())
            eng._sessions.clear()
        if not sessions:
            return 0
        live = self._live_engines(exclude=eng)
        n = 0
        for key, (hist, ent) in sessions:
            if isinstance(ent, _SessionClaim):
                # an unadmitted claim: the conversation retries from the
                # previous resolved turn
                ent = ent.prev
            target = None
            if isinstance(ent, ServeRequest) and not ent.done:
                target = moved.get(id(ent))
            if target is None:
                target = dest
            if target is None and live:
                target = min(live, key=lambda e: e.depth())
            if target is None:
                continue   # nowhere to go: the history dies with eng
            with target._slock:
                if key in target._sessions:
                    continue   # the target's own copy wins
                target._sessions[key] = (hist, ent)
                target._sessions.move_to_end(key)
                target._trim_sessions_locked()
            n += 1
        if n:
            telemetry.inc("serve.sessions_migrated", n)
            telemetry.record_event("serve_sessions_migrated",
                                   replica=eng.name, n=n)
        return n

    def _next_name(self):
        """A fresh replicaN name (the caller holds ``_lock``)."""
        names = {e.name for e in self.engines}
        idx = len(self.engines)
        while "replica%d" % idx in names:
            idx += 1
        return "replica%d" % idx

    def add_replica(self, role=None, name=None, template=None):
        """Grow the fleet by one replica templated off a live one, warmed
        and started: the autoscaler's scale-up.  The new engine shares the
        template's parameter tensors (the same storage, no copy), and the
        port builds no program, so its warmup only runs each bucket once.
        Disaggregated, ``role`` picks its pool (decode by default).
        Returns it."""
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
        if self._disagg and role is None:
            role = "decode"
        fresh = template.respawn(name=name)
        self._wire(fresh, role if self._disagg else None)
        fresh.warmup()
        with self._lock:
            self.engines.append(fresh)
            if self._disagg and role == "prefill":
                self._n_prefill += 1
            fleet = len(self.engines)
        fresh.start()
        telemetry.set_gauge("serve.replicas", fleet)
        return fresh

    def remove_replica(self, replica=None, deadline_ms=None, role=None):
        """Shrink the fleet by one replica, the autoscaler's scale-down:
        `drain` it (its stragglers and sessions migrate), then drop it.
        With no ``replica`` the least-loaded live one (of ``role``, when
        given) goes.  Refuses to remove the last replica, or disaggregated
        the last of its role.  Returns the removed engine's name."""
        with self._lock:
            engines = list(self.engines)
        if replica is None:
            pool = [e for e in engines if e._dead is None
                    and not e._stopped.is_set() and not e._draining]
            if role is not None:
                pool = [e for e in pool if e.role == role]
            if not pool:
                raise MXNetError("ReplicaRouter: no removable replica%s"
                                 % (" with role %r" % role if role else ""))
            eng = min(pool, key=lambda e: e.depth())
        else:
            eng = self._resolve_engine(replica)
        with self._lock:
            peers = [e for e in self.engines if e is not eng
                     and (not self._disagg or e.role == eng.role)]
            if not peers:
                raise MXNetError(
                    "ReplicaRouter: refusing to remove %s: it is the last "
                    "%sreplica" % (eng.name, "%s " % eng.role
                                   if self._disagg else ""))
        self.drain(eng, deadline_ms=deadline_ms, respawn=False)
        with self._lock:
            try:
                self.engines.remove(eng)
            except ValueError:
                pass   # raced with a concurrent removal
            if self._disagg and eng.role == "prefill":
                self._n_prefill = max(1, self._n_prefill - 1)
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
