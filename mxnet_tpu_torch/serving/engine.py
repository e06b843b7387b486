"""Continuous-batching serving engine, in PyTorch.

A port of the single-replica core of `mxnet_tpu/serving/engine.py`
`ServingEngine`.  Iteration-level scheduling: the unit of work is one
decode step over whichever sequences are active; a request joins the
batch after its prefill and leaves the step it finishes.  Shapes come
from a small fixed set of buckets, as in the JAX engine: prompts
right-pad to a prefill bucket, the active set pads to a decode bucket
with padding rows pointed at a trash slot or the trash block.

The K/V cache is paged by default: a block pool updated in place, per-row
block tables and a host-side free list (`paged.BlockAllocator`).
Admission allocates the prompt's blocks, the prompt streams through the
pool in bucket-sized chunks (one chunk per prefilling request per
iteration), and a row grows one block at a time.  A denied growth
preempts the row: its blocks go back, the request requeues at the front
with its generated tokens, and the re-admission replays
``(prompt + generated)[:pos]`` exactly, so preemption never shows in the
output.  ``paged=False`` is the slot cache: one (S_max, embed) row per
batch slot, prefilled through the flash-attention kernel in one launch.

Sampling is `sampling.sample_tokens`, request-keyed by (seed, position)
like the JAX engine; an iteration whose rows are all greedy takes the
argmax alone, which is the same result.  PyTorch runs eagerly, so
``warmup`` runs each bucket's program once (the kernels build and load,
cuBLAS initialises) instead of compiling it.

What the JAX engine has beyond this core waits for later slices: the
prefix cache, host tier, speculative and megastep decoding,
quantization, MoE, meshes and routers, the journal, handoffs, deadlines,
overload policies, chaos, telemetry and the background scheduler thread.
Their keywords are not accepted.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve
from .errors import ServeBlocksExhausted, ServeTimeout
from .paged import TRASH_BLOCK, BlockAllocator
from .sampling import sample_tokens

__all__ = ["ServeRequest", "ServingEngine"]


class ServeRequest:
    """One generation request: prompt in, tokens out, latency stamps.

    Greedy unless ``temperature > 0``; then top-k / top-p filtering and a
    draw keyed by ``seed`` (default: the request id) and each token's
    absolute position, so batch composition and preemption never change
    what a request samples."""

    _ids = [0]
    _ids_lock = threading.Lock()

    def __init__(self, prompt, max_new_tokens, eos_id=None, temperature=0.0,
                 top_k=0, top_p=1.0, seed=None):
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
        self.t_submit = time.perf_counter()
        self.t_first = None       # first token sampled
        self.t_done = None
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block until finished; returns the generated token list.  Raises
        `ServeTimeout` if the wait expires."""
        if not self._done.wait(timeout):
            raise ServeTimeout("ServeRequest %d: timed out after %ss"
                               % (self.id, timeout))
        return list(self.tokens)

    @property
    def ttft_ms(self):
        return None if self.t_first is None else \
            1e3 * (self.t_first - self.t_submit)

    @property
    def latency_ms(self):
        return None if self.t_done is None else \
            1e3 * (self.t_done - self.t_submit)

    def _finish(self):
        self.t_done = time.perf_counter()
        self._done.set()


class _Seq:
    """An active sequence: ``last`` is fed (and cached) at ``pos`` on the
    next decode step.  Paged only: ``blocks`` is its block list and
    ``ctx`` the tokens cached at rows [0, pos), what a preemption
    replays."""

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
    context), ``done`` of them are; ``resume`` is (last, pos, n_new)."""

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
    The other keywords and their defaults are the JAX engine's.
    """

    def __init__(self, model, params, ctx=None, max_batch=8,
                 decode_buckets=None, prefill_buckets=None,
                 max_new_tokens=32, eos_id=None, paged=True, block_size=None,
                 n_blocks=None, chunk_prefill=True, sampling=True):
        self.model = model
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
        self._paged = bool(paged)
        self._sampling = bool(sampling)
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
        self._active = {}         # row -> _Seq (insertion-ordered)
        self._prefilling = {}     # row -> _Prefill (paged only)
        self._free = list(range(self.max_batch))
        self.stats = {"decode_steps": 0, "decode_rows": 0,
                      "decode_padded": 0, "prefills": 0, "completed": 0,
                      "tokens": 0, "prefill_chunks": 0, "prefill_tokens": 0,
                      "preemptions": 0, "alloc_denied": 0,
                      "max_concurrent": 0,
                      "blocks_free_min": (self._alloc.free_blocks
                                          if self._paged else None)}

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
            toks = logits.argmax(dim=-1)
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
        block, so kernels build and load, and libraries initialise, before
        the first request."""
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
        return {"prefill": list(self.prefill_buckets),
                "decode": list(self.decode_buckets),
                "cache": "paged" if self._paged else "slot",
                "block_size": self.block_size, "n_blocks": self.n_blocks}

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None):
        if max_new_tokens is None:
            max_new_tokens = self.max_new_default
        elif int(max_new_tokens) < 1:
            raise MXNetError("ServingEngine: max_new_tokens must be >= 1, "
                             "got %s" % max_new_tokens)
        if temperature and not self._sampling:
            raise MXNetError("ServingEngine: sampling is disabled "
                             "(sampling=False) — temperature > 0 unsupported")
        req = ServeRequest(prompt, max_new_tokens,
                           self.eos_id if eos_id is None else eos_id,
                           temperature=temperature, top_k=top_k, top_p=top_p,
                           seed=seed)
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
            worst = min(len(req.prompt) + req.max_new_tokens,
                        self.model.seq_len)
            need = self._alloc.blocks_for(worst)
            if need > self._alloc.capacity:
                raise ServeBlocksExhausted(
                    "ServingEngine: request needs up to %d cache blocks but "
                    "the pool only has %d usable (n_blocks=%d, "
                    "block_size=%d)" % (need, self._alloc.capacity,
                                        self.n_blocks, self.block_size))
        with self._qlock:
            self._queue.append(req)
        return req

    def depth(self):
        """Queued + prefilling + running requests."""
        with self._qlock:
            return len(self._queue) + len(self._prefilling) + \
                len(self._active)

    # -- scheduling --------------------------------------------------------
    def _bucket_for(self, n, buckets):
        for b in buckets:
            if b >= n:
                return b
        raise MXNetError("ServingEngine: no bucket >= %d in %s"
                         % (n, buckets))

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

    def _admit_one_paged(self, req):
        """Paged admission: allocate blocks for the whole context plus the
        first decode write, then stream the context through the pool in
        chunks.  A denied allocation requeues the request at the front."""
        row = self._free.pop()
        tokens = req.prompt if req._resume is None else req._resume[0]
        blocks = self._alloc.alloc(self._alloc.blocks_for(len(tokens) + 1))
        if blocks is None:
            self._free.append(row)
            self.stats["alloc_denied"] += 1
            with self._qlock:
                self._queue.appendleft(req)
            return False
        pf = _Prefill(req, row, list(tokens), blocks,
                      resume=None if req._resume is None
                      else req._resume[1:])
        self._prefilling[row] = pf
        self._advance_chunk(pf)
        return True

    def _advance_prefills(self):
        """Advance every mid-stream prefill by one chunk."""
        for pf in list(self._prefilling.values()):
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

    def _grow_active(self):
        """Before a decode step every active row must own the block its
        write position lands in; a row whose growth is denied is
        preempted."""
        for row, seq in list(self._active.items()):
            last_write = min(seq.pos + 1, self.model.seq_len) - 1
            need = last_write // self.block_size + 1
            if need > len(seq.blocks):
                got = self._alloc.alloc(need - len(seq.blocks))
                if got is None:
                    self._preempt(row, seq)
                    continue
                seq.blocks.extend(got)
        self.stats["blocks_free_min"] = min(self.stats["blocks_free_min"],
                                            self._alloc.free_blocks)

    def _preempt(self, row, seq):
        """Free a row and requeue its request at the front, carrying the
        context cached at rows [0, pos) for an exact replay."""
        del self._active[row]
        self._free.append(row)
        req = seq.req
        req._resume = (list(seq.ctx), seq.last, seq.pos, seq.n_new)
        self._alloc.free(seq.blocks)
        seq.blocks = None
        self.stats["preemptions"] += 1
        with self._qlock:
            self._queue.appendleft(req)

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
        if self._paged and seq.blocks is not None:
            self._alloc.free(seq.blocks)
            seq.blocks = None
        seq.req._finish()
        self.stats["completed"] += 1

    def _advance_one(self, seq, t):
        """Advance a sequence by one emitted token; True when it finished."""
        seq.req.tokens.append(t)
        if seq.ctx is not None:
            seq.ctx.append(seq.last)  # the token cached at the old pos
        seq.last = t
        seq.pos += 1
        seq.n_new += 1
        return self._seq_finished(seq, t)

    def _decode_plain(self):
        """One single-token decode launch over the active set."""
        rows = list(self._active)
        n = len(rows)
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
        """One scheduler iteration: advance mid-stream prefills, admit
        while there is room, then one decode step over the active set.
        Returns the number of sequences still in flight (0 = idle)."""
        if self._paged:
            self._advance_prefills()
        while self._free:
            with self._qlock:
                req = self._queue.popleft() if self._queue else None
            if req is None or self._admit_one(req) is False:
                break
        if self._paged:
            self._grow_active()
        n = len(self._active)
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"], n)
        if n:
            self._decode_plain()
        return len(self._active) + len(self._prefilling)

    def run_until_idle(self, timeout=None):
        """Step until the queue and the active set drain; returns the
        number of steps taken.  Raises `ServeTimeout` past ``timeout``
        seconds."""
        t0 = time.perf_counter()
        steps = 0
        while True:
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
