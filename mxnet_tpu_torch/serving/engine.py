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
(`step`, `run_until_idle`) or on its own (`start`).  The counters the JAX
engine sends to its telemetry (``shed``, ``expired``, ``cancelled``,
``degraded``, ``block_waits``, ``preempted``, ``stalled``, ``drained``)
are keys of `stats` here.

Sampling is `sampling.sample_tokens`, request-keyed by (seed, position)
like the JAX engine; an iteration whose rows are all greedy takes the
argmax alone, which is the same result.  PyTorch runs eagerly, so
``warmup`` runs each bucket's program once (the kernels build and load,
cuBLAS initialises) instead of compiling it.

What the JAX engine has beyond this waits for later slices: the host
tier and sessions, speculative and megastep decoding, streaming,
quantization, MoE, meshes, routers and the journal, handoffs, launch
failure scoping and cache rebuilds, chaos, telemetry and tracing.  Their
keywords are not accepted, and an ``MXNET_CHAOS`` spec with a serving
clause raises at construction (`chaos`).  A prompt token outside
[-V, V) embeds as NaN, as in the JAX engine, and its request decodes
token 0 (the first NaN's index) while the scheduler goes on.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from .. import chaos
from ..base import MXNetError
from ..context import resolve
from .errors import (ServeBlocksExhausted, ServeCancelled,
                     ServeDeadlineExceeded, ServeEngineDead, ServeError,
                     ServeOverload, ServeTimeout)
from .paged import TRASH_BLOCK, BlockAllocator, PrefixCache
from .sampling import argmax, sample_tokens

__all__ = ["ServeRequest", "ServingEngine"]

_OVERLOAD_POLICIES = ("shed", "block", "degrade")


def _env_flag(name, default="1"):
    return os.environ.get(name, default).lower() not in ("0", "false", "no")


class ServeRequest:
    """One generation request: prompt in, tokens out, latency stamps.

    Greedy unless ``temperature > 0``; then top-k / top-p filtering and a
    draw keyed by ``seed`` (default: the request id) and each token's
    absolute position, so batch composition and preemption never change
    what a request samples.  Once ``t_submit + deadline_ms`` passes, the
    scheduler retires the request at its next iteration with
    `ServeDeadlineExceeded`, queued or running; ``cancel()`` retires it
    the same way with `ServeCancelled`."""

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
        self._waker = None        # set by the owning engine at enqueue
        self._preempt_n_new = None  # n_new at the last preemption: exempt
        #                           from another one until it advances
        #                           min_progress tokens past it

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
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()


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
    """

    def __init__(self, model, params, ctx=None, max_batch=8,
                 decode_buckets=None, prefill_buckets=None,
                 max_new_tokens=32, eos_id=None, paged=True, block_size=None,
                 n_blocks=None, chunk_prefill=True, sampling=True,
                 name="replica0", queue_max=None, overload=None,
                 deadline_ms=None, prefix=None, prefix_pool=None,
                 min_progress=None, thrash_trip=None):
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
                      # anti-thrash
                      "stalls": 0, "thrash_trips": 0,
                      # the JAX engine's telemetry counters
                      "shed": 0, "expired": 0, "cancelled": 0,
                      "degraded": 0, "block_waits": 0, "preempted": 0,
                      "stalled": 0, "drained": 0}

    # -- device staging ----------------------------------------------------
    def _put(self, a):
        return torch.as_tensor(a, device=self.device)

    def _pick(self, logits, reqs, newpos):
        """Host token ids for the first len(reqs) rows of ``logits``:
        argmax when every row is greedy, else `sample_tokens`."""
        logits = logits[:len(reqs)]
        if self._sampling and any(r.temperature > 0 for r in reqs):
            toks = sample_tokens(
                logits,
                self._put(np.array([r.temperature for r in reqs],
                                   np.float32)),
                self._put(np.array([r.top_k for r in reqs], np.int64)),
                self._put(np.array([r.top_p for r in reqs], np.float32)),
                self._put(np.array([r.seed for r in reqs], np.int64)),
                self._put(np.asarray(newpos, np.int64)))
        else:
            toks = argmax(logits)
        return toks.tolist()

    # -- programs ----------------------------------------------------------
    def _table(self, rows, blocks):
        tables = np.full((rows, self._n_table), TRASH_BLOCK, np.int64)
        for i, bl in enumerate(blocks):
            tables[i, :len(bl)] = bl
        return self._put(tables)

    def _prefill_slot(self, tokens, slot):
        """The slot-cache prefill program: forward, write the K/V into
        ``slot``, return the last real token's logits."""
        s = self._bucket_for(len(tokens), self.prefill_buckets)
        toks = np.zeros((1, s), np.int64)
        toks[0, :len(tokens)] = tokens
        length = self._put(np.array([len(tokens)], np.int64))
        logits, kv = self.model.prefill(self._params, self._put(toks), length)
        self.model.write_prefill(self._cache, kv, length,
                                 self._put(np.array([slot], np.int64)))
        return logits

    def _prefill_chunk(self, chunk, bucket, start, blocks):
        """The paged prefill program over one chunk of ``bucket`` tokens."""
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(chunk)] = chunk
        logits, _ = self.model.prefill_paged(
            self._params, self._cache, self._put(toks),
            self._put(np.array([start], np.int64)),
            self._put(np.array([len(chunk)], np.int64)),
            self._table(1, [blocks]))
        return logits

    def _decode(self, b, seqs, slots):
        """The decode program over bucket ``b`` (rows past len(seqs) are
        padding on the trash slot / trash block)."""
        token = np.zeros((b,), np.int64)
        pos = np.zeros((b,), np.int64)
        for i, seq in enumerate(seqs):
            token[i] = seq.last
            pos[i] = seq.pos
        if self._paged:
            logits, _ = self.model.decode_paged(
                self._params, self._cache, self._put(token), self._put(pos),
                self._table(b, [s.blocks for s in seqs]))
        else:
            slot_ids = np.full((b,), self.max_batch, np.int64)
            slot_ids[:len(slots)] = slots
            logits, _ = self.model.decode(
                self._params, self._cache, self._put(token), self._put(pos),
                self._put(slot_ids))
        return logits

    def warmup(self):
        """Run every bucket's program once against the trash slot / trash
        block (and, with the prefix cache, the block copy), so kernels
        build and load, and libraries initialise, before the first
        request."""
        for s in self.prefill_buckets:
            if self._paged:
                logits = self._prefill_chunk([0], s, 0, [])
            else:
                logits = self._prefill_slot([0], self.max_batch)
            logits.argmax(dim=-1).tolist()
        for b in self.decode_buckets:
            self._decode(b, [], []).argmax(dim=-1).tolist()
        if self._sampling:
            one = self._put(np.ones((1,), np.float32))
            zero = self._put(np.zeros((1,), np.int64))
            sample_tokens(torch.zeros((1, self.model.vocab_size),
                                      device=self.device),
                          one, zero, one, zero, zero).tolist()
        if self._prefix is not None:
            self.model.copy_block(self._cache, TRASH_BLOCK, TRASH_BLOCK)
        return {"prefill": list(self.prefill_buckets),
                "decode": list(self.decode_buckets),
                "cache": "paged" if self._paged else "slot",
                "block_size": self.block_size, "n_blocks": self.n_blocks,
                "prefix": self._prefix is not None}

    # -- submission and admission control ----------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_ms=None, temperature=0.0, top_k=0, top_p=1.0,
               seed=None):
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
                raise ServeBlocksExhausted(
                    "ServingEngine %s: request needs up to %d cache blocks "
                    "but the pool only has %d usable (n_blocks=%d, "
                    "block_size=%d)" % (self.name, need, self._alloc.capacity,
                                        self.n_blocks, self.block_size))
        if self._queue_max > 0 and self._overload == "block":
            return self._enqueue_blocking(req)
        return self._enqueue(req)

    def _count(self, what, n=1):
        """Bump a counter that the submitting thread and the scheduler
        can both touch."""
        with self._count_lock:
            self.stats[what] += n

    def _admission_shed(self, depth):
        """Overload decision for one enqueue at queue depth ``depth``:
        a degrade cap on max_new_tokens, None, or `ServeOverload` raised.
        Called under `_qlock`."""
        if self._queue_max <= 0 or depth < self._queue_max:
            return None
        if self._overload == "degrade" and depth < 4 * self._queue_max:
            # cap generation length under pressure instead of shedding;
            # the 4x backstop bounds the queue even under a flood
            return max(1, self.max_new_default // 4)
        self._count("shed")
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

    def _post_enqueue(self, req):
        req._waker = self._wake.set
        self._wake.set()
        return req

    def _enqueue(self, req):
        """Admission under the shed and degrade policies."""
        with self._qlock:
            self._check_alive_locked()
            cap = self._admission_shed(len(self._queue))
            if cap is None and self._storm:
                # preemption storm: admit new work at the degrade cap, so
                # shorter answers shrink the churning footprint
                cap = max(1, self.max_new_default // 4)
            if cap is not None and req.max_new_tokens > cap \
                    and req._resume is None:
                # never degrade a resumed request: its output is already
                # promised, and a cap would cut its replay short
                req.max_new_tokens = cap
                self._count("degraded")
            self._queue.append(req)
        return self._post_enqueue(req)

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
                    break
                waited = True
                self._qcond.wait(0.05)
        if waited:
            self._count("block_waits")
        return self._post_enqueue(req)

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

    def _admit_one(self, req):
        """Admit one queued request.  Returns False only when a paged
        block allocation was denied (the request went back to the queue
        front: stop admitting this iteration)."""
        if self._paged:
            return self._admit_one_paged(req)
        slot = self._free.pop()
        plen = len(req.prompt)
        logits = self._prefill_slot(req.prompt, slot)
        first = self._pick(logits, [req], [plen])[0]
        req.t_first = time.perf_counter()
        req.tokens.append(first)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += plen
        self.stats["tokens"] += 1
        seq = _Seq(req, first, plen)
        if self._seq_finished(seq, first):
            self._retire(slot, seq, enter=False)
        else:
            self._active[slot] = seq
        return True

    # -- block lifetime ----------------------------------------------------
    def _release_blocks(self, holder):
        """Drop a sequence's or prefill's block refs exactly once: every
        path by which a holder leaves the cache funnels through here."""
        if self._paged and holder.blocks is not None:
            self._drop_refs(holder.blocks)
            holder.blocks = None

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

    def _block_gauges(self):
        """The ``blocks_free_min`` low-water mark, taken at every
        allocation, as the JAX engine's pool gauges are."""
        if self._paged:
            self.stats["blocks_free_min"] = min(
                self.stats["blocks_free_min"], self._alloc.free_blocks)

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
        self._enter_decode_or_prefill(req, row, list(tokens), blocks, matched)
        return True

    def _count_prefix_hit(self, matched_tokens):
        self.stats["prefix_hits"] += 1
        self.stats["prefix_tokens"] += matched_tokens

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
            if req._resume is None:
                last, pos, n_new = int(tokens[-1]), len(tokens) - 1, 0
            else:
                last, pos, n_new = req._resume[1:]
                req._resume = None
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
            if pf.row in self._prefilling:
                self._advance_chunk(pf)

    def _advance_chunk(self, pf):
        """Launch one prefill chunk; the last one moves the sequence to
        the active set (sampling its first token, or resuming a
        preempted generation where it stopped)."""
        req = pf.req
        total = len(pf.tokens)
        remaining = total - pf.done
        largest = self.prefill_buckets[-1]
        bucket = largest if remaining > largest else \
            self._bucket_for(remaining, self.prefill_buckets)
        chunk = min(remaining, bucket)
        logits = self._prefill_chunk(pf.tokens[pf.done:pf.done + chunk],
                                     bucket, pf.done, pf.blocks)
        pf.done += chunk
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += chunk
        # publish the newly full blocks (``done`` counts real tokens only,
        # so a block whose tail holds the bucket's padding stays private)
        self._register_prefix(pf.tokens, pf.blocks, pf.done)
        if pf.done < total:
            return
        del self._prefilling[pf.row]
        blocks, pf.blocks = pf.blocks, None
        self.stats["prefills"] += 1
        if pf.resume is not None:
            # the cache rows are rebuilt: continue from the token the
            # preemption interrupted (nothing is sampled again)
            last, pos, n_new = pf.resume
            req._resume = None
            seq = _Seq(req, last, pos, blocks=blocks, ctx=pf.tokens)
            seq.n_new = n_new
            self._active[pf.row] = seq
            return
        first = self._pick(logits, [req], [total])[0]
        req.t_first = time.perf_counter()
        req.tokens.append(first)
        self.stats["tokens"] += 1
        seq = _Seq(req, first, total, blocks=blocks, ctx=pf.tokens)
        if self._seq_finished(seq, first):
            self._retire(pf.row, seq, enter=False)
        else:
            self._active[pf.row] = seq

    # -- growth, copy-on-write and preemption ------------------------------
    def _grow_active(self):
        """Before a decode step every active row must own, exclusively,
        the block its write position lands in: a row past its last block
        grows by one, and a row about to write into a block that is
        shared or registered gets a private copy first (copy-on-write),
        so the cached original keeps serving its other readers.  A denied
        allocation preempts or stalls the row (`_grow_alloc`)."""
        self._stalled.clear()
        oldest = self._oldest_inflight()
        for row, seq in list(self._active.items()):
            if row not in self._active:
                continue  # preempted as an earlier row's victim
            last_write = min(seq.pos + 1, self.model.seq_len) - 1
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
                self._cow(seq, idx, got[0])

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

    def _cow(self, seq, idx, dst):
        """Copy block ``seq.blocks[idx]`` into ``dst`` and repoint the
        table; the original loses this reader."""
        src = seq.blocks[idx]
        self.model.copy_block(self._cache, src, dst)
        seq.blocks[idx] = dst
        self._drop_refs([src])
        self.stats["cow_copies"] += 1
        self._block_gauges()

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
        self._release_blocks(seq)
        seq.req._finish()
        self.stats["completed"] += 1
        # a completion proves the pool drains: reset the storm detector
        self._preempts_since_retire = 0
        self._storm = False

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
        not stalled."""
        rows = [r for r in self._active if r not in self._stalled]
        n = len(rows)
        if n == 0:
            # every row is stalled on a denied allocation: back off briefly
            # instead of spinning while room (or a deadline) arrives
            time.sleep(0.001)
            return
        b = self._bucket_for(n, self.decode_buckets)
        seqs = [self._active[r] for r in rows]
        logits = self._decode(b, seqs, rows)
        nxt = self._pick(logits, [s.req for s in seqs],
                         [s.pos + 1 for s in seqs])
        self.stats["decode_steps"] += 1
        self.stats["decode_rows"] += n
        self.stats["decode_padded"] += b - n
        self.stats["tokens"] += n
        for row, seq, t in zip(rows, seqs, nxt):
            if self._advance_one(seq, t):
                self._retire(row, seq)

    def step(self):
        """One scheduler iteration: sweep deadlines and cancellations,
        advance mid-stream prefills, admit while there is room, grow (and
        copy) blocks, then one decode step over the active set.  Returns
        the number of sequences still in flight (0 = idle)."""
        self._sweep()
        if self._paged:
            self._advance_prefills()
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
        if self._paged:
            self._grow_active()
            self._block_gauges()
        n = len(self._active)
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"], n)
        if n:
            self._decode_plain()
        return len(self._active) + len(self._prefilling)

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
                # anything that escapes a step kills the scheduler: fail
                # every request typed rather than leave it hanging
                self._die(str(e)[:500])
                return
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
        the engine dead and fail the admitted and the queued requests
        with `ServeEngineDead`."""
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
