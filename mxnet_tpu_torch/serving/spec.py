"""Speculative decoding's drafters, in PyTorch.

A port of `mxnet_tpu/serving/spec.py`.  A drafter proposes k tokens per
row; one verify pass (`TransformerKVModel.verify_paged`) scores them
against the target model, and the engine keeps the longest run of
proposals equal to the target's own picks, plus the target's next
token.  Sampling is request-keyed and position-folded
(`sampling.sample_tokens`), so the target's pick at a position is a
function of (seed, context) alone: the accept rule "a draft survives iff
it equals the target's pick" gives the tokens plain decode gives, at any
temperature.  A drafter only moves the accept rate, never the output.

* `NgramDrafter`: prompt lookup (the continuation of the most recent
  earlier occurrence of the row's trailing n-gram) and a bounded store
  of the generations this replica finished.  No device state; a round
  costs one verify.
* `ModelDrafter`: a draft model, by default the target itself with its
  weights (self-drafting), over a paged K/V pool of its own that mirrors
  the target's block ids, so the engine's tables, growth, copy-on-write,
  preemption and prefix sharing hold for the draft cache too.  A round
  runs k+1 `decode_paged` steps on the device (the last writes the K/V
  of proposal k, so a fully accepted round leaves no hole) and fetches
  the k proposals once.  Where the JAX package runs these steps as one
  `lax.scan` launch, the port enqueues them one after another: several
  launches, one fetch.

Draft state is never correctness-critical: a failed draft launch costs
accept rate (`ModelDrafter._degrade` heals the pool and proposes junk
the verify rejects), except a dead device (chaos's `ChaosEngineCrash`, a
``CUDA error:``), which must still kill the scheduler, and a kernel that
does not build, which is not a launch fault at all: both raise.

The engine drives the lifecycle: `bind` at construction, `warmup` in
`ServingEngine.warmup`, `on_prefill_chunk` after every target prefill
chunk (the draft cache prefills in lockstep), `on_cow` after a target
copy-on-write, `on_restore_span` after a host-tier restore landed a span
of the target pool without a prefill (a drafter that ``mirrors_pool``
prefills it through its own model), `on_cache_rebuild` when the target
pool is rebuilt, `on_retire`, `observe` and `on_resume` for a learning
drafter.  A draft pool quantizes as the target's does (the engine's
``quant`` and ``kv_quant`` specs), so quantization alone never moves
the accept rate.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import chaos, telemetry
from ..base import MXNetError
from ..ops.pallas_kernels._build import KernelBuildError
from .sharded import ShardedParams

__all__ = ["Drafter", "NgramDrafter", "ModelDrafter", "make_drafter"]


class Drafter:
    """The interface a `ServingEngine` speculation round drives.

    ``propose`` is the one required method; the paged-lifecycle hooks
    are no-ops unless the drafter keeps device state."""

    name = "drafter"
    # whether propose() wants the (token, pos, tables) triple on the
    # device (a host drafter costs no device traffic a round)
    needs_device = False

    def __init__(self):
        self._engine = None
        self.launches = 0   # draft rounds and draft prefill chunks run

    def bind(self, engine):
        """Attach to (or, on respawn, re-attach to) an engine."""
        self._engine = engine

    def warmup(self):
        """Run every draft program once (inside `ServingEngine.warmup`)."""

    def propose(self, seqs, k, bucket, host, dev, samp):
        """Proposals for the active ``seqs``: a (bucket, k) int array, or
        a pair of it and a (bucket,) bool mask of the rows whose draft is
        real (False: a filler the drafter expects to be rejected).  With
        no real draft in the batch the engine runs a plain round instead
        of the k+1-wide verify.

        host: (token0, pos, tables) numpy arrays at the bucket shape (each
        row's next fed token, its position, its block table); dev: the
        same on the device, or None when ``needs_device`` is False; samp:
        the engine's per-row sampling tensors on the device (() when
        every row is greedy), so a model drafter draws with the target's
        request-keyed generator."""
        raise NotImplementedError

    def on_prefill_chunk(self, toks_d, start_d, length_d, table_d):
        """A target prefill chunk ran with these (device) operands."""

    # whether the drafter keeps a pool mirroring the target's block ids,
    # which must follow a host-tier restore (`on_restore_span`)
    mirrors_pool = False

    def on_restore_span(self, toks_d, start_d, length_d, table_d):
        """A host-tier restore landed this block-aligned span of the
        target pool without a prefill; a pool-mirroring drafter derives
        its own rows for it (draft state: accept rate, never output)."""

    def on_cow(self, src, dst):
        """The target copied block ``src`` to ``dst`` (copy-on-write)."""

    def on_cache_rebuild(self):
        """The target pool was rebuilt: every cached draft row is void."""

    def on_retire(self, hist):
        """A request finished with token history ``hist`` (prompt and
        generated)."""

    def observe(self, hist, new):
        """A live row's history grew: the last ``new`` tokens of ``hist``
        were just emitted."""

    def on_resume(self, hist):
        """A preempted or migrated request re-entered decode with the
        replayed context ``hist`` (its cached rows and the pending feed
        token)."""


class NgramDrafter(Drafter):
    """Model-free drafting: prompt lookup and a generation store.

    A row's proposals continue its trailing n-gram (n from ``max_n`` down
    to ``min_n``), looked up first in the store (a FIFO index, at most
    ``store_cap`` entries, over the token streams this replica finished
    or saw grow) and then in the row's own ``prompt + generated``.  No
    match proposes the last token repeated, a filler the verify rejects.
    A match counts as real (the mask) when it is at least
    ``min_local_n`` tokens long."""

    name = "ngram"

    # longest continuation one store entry keeps
    _CONT = 16

    def __init__(self, max_n=3, min_n=1, min_local_n=2, store_cap=65536):
        super().__init__()
        if int(max_n) < int(min_n) or int(min_n) < 1:
            raise MXNetError("NgramDrafter: need max_n >= min_n >= 1")
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        self.min_local_n = max(int(min_local_n), int(min_n))
        self.store_cap = int(store_cap)
        self._store = OrderedDict()   # ngram tuple -> continuation tuple

    def _index(self, hist, start):
        """Index every n-gram whose continuation starts at or after
        ``start`` (0: everything, which also refreshes continuations cut
        short while the generation was in flight)."""
        if self.store_cap <= 0:
            return
        hist = [int(t) for t in hist]
        for n in range(self.min_n, self.max_n + 1):
            for i in range(max(n, int(start)), len(hist)):
                cont = tuple(hist[i:i + self._CONT])
                if not cont:
                    break
                key = tuple(hist[i - n:i])
                self._store[key] = cont
                self._store.move_to_end(key)
        while len(self._store) > self.store_cap:
            self._store.popitem(last=False)

    def on_retire(self, hist):
        self._index(hist, 0)

    def observe(self, hist, new):
        self._index(hist, len(hist) - int(new))

    def on_resume(self, hist):
        self._index(hist, 0)

    def _lookup(self, hist, k):
        """(k proposals, confident): confident when the match is at least
        ``min_local_n`` tokens long."""
        n_hist = len(hist)
        for n in range(min(self.max_n, n_hist), self.min_n - 1, -1):
            pat = hist[-n:]
            hit = self._store.get(tuple(pat))
            if hit is not None:
                cont = list(hit[:k])
                return (cont + [hist[-1]] * (k - len(cont)),
                        n >= self.min_local_n)
            if n < self.min_local_n:
                continue
            # the most recent earlier occurrence in the row's own history
            for j in range(n_hist - n - 1, -1, -1):
                if hist[j:j + n] == pat:
                    cont = hist[j + n:j + n + k]
                    if cont:
                        return cont + [hist[-1]] * (k - len(cont)), True
        return [hist[-1]] * k, False

    def propose(self, seqs, k, bucket, host, dev, samp):
        out = np.zeros((bucket, k), np.int64)
        mask = np.zeros((bucket,), bool)
        for r, seq in enumerate(seqs):
            hist = (seq.ctx or []) + [seq.last]
            out[r], mask[r] = self._lookup(hist, k)
        return out, mask


def _fatal(exc):
    """Whether a failed draft launch must escalate: a dead device (chaos's
    crash, or a CUDA error other than out of memory, after which the
    context is unusable) or a kernel that did not build."""
    if isinstance(exc, (chaos.ChaosEngineCrash, KernelBuildError)):
        return True
    msg = str(exc).lower()
    return "cuda error" in msg and "out of memory" not in msg


class ModelDrafter(Drafter):
    """Draft-model drafting over a mirrored paged K/V pool.

    ``model`` / ``params`` default to the bound engine's own model and
    weights (self-drafting, the serve bench's configuration, whose
    ceiling accept rate is 1); a draft model of another geometry works
    if it has the target's vocabulary.  Its pool is (L_d, 2, n_blocks,
    block_size, E_d): only the block ids are shared with the target.
    Rejected drafts leave garbage rows that the next round overwrites
    before it attends them."""

    name = "model"
    needs_device = True
    mirrors_pool = True

    def __init__(self, model=None, params=None):
        super().__init__()
        self.model = model
        self.params = params
        self._pool = None
        self._dparams = None
        self.steps = 0          # draft decode steps run (k+1 a round)
        self.prefill_chunks = 0

    def bind(self, engine):
        super().bind(engine)
        if self.model is None:
            self.model = engine.model
        else:
            # the draft pool quantizes as the target's does
            self.model = self.model.with_quant(engine.model.quant,
                                               engine.model.kv_quant)
        if self.model.vocab_size != engine.model.vocab_size:
            raise MXNetError(
                "ModelDrafter: draft vocab %d != target vocab %d"
                % (self.model.vocab_size, engine.model.vocab_size))
        params = engine._params if self.params is None else self.params
        if isinstance(params, ShardedParams):
            # self-drafting on a sub-mesh replica: the target's shards
            self._dparams = params
            self._init_pool()
            return
        if self.model.quant is not None:
            # idempotent: self-drafting shares the engine's quantized
            # parameters
            params = self.model.quantize_params(params)
        if all(isinstance(v, torch.Tensor) for v in params.values()):
            self.model.check_params(params)
            self._dparams = {k: v.to(engine.device)
                             for k, v in params.items()}
        else:
            self._dparams = self.model.params_from_jax(params, engine.device)
        self._init_pool()

    def _init_pool(self):
        e = self._engine
        self._pool = self.model.init_block_pool(e.n_blocks, e.block_size,
                                                device=e.device)

    def _pool_lost(self):
        return self.model.cache_lost(self._pool)

    def _draft(self, token_d, pos_d, tables_d, samp):
        """The k+1 draft steps of one round, enqueued on the device with
        no host sync: feed a token, write its draft K/V, attend, pick,
        feed the pick.  Returns the (b, k) proposals, still on the
        device (the last step's pick is never proposed)."""
        e = self._engine
        k = e._spec_k
        tok = token_d
        picks = []
        for j in range(k + 1):
            logits, self._pool = self.model.decode_paged(
                self._dparams, self._pool, tok, pos_d + j, tables_d)
            tok = e._pick_dev(logits, samp, pos_d + j + 1)
            picks.append(tok)
            self.steps += 1
        return torch.stack(picks[:k], dim=1)

    def warmup(self):
        """Each draft program once, against the trash block; a failure
        here raises."""
        e = self._engine
        for s in e.prefill_buckets:
            _, self._pool = self.model.prefill_paged(
                self._dparams, self._pool, *e._chunk_inputs([0], s, 0, []))
            self.prefill_chunks += 1
        for b in e.decode_buckets:
            self._draft(*e._decode_inputs(b, [], []), ()).cpu()
        if e._prefix is not None:
            self.model.copy_block(self._pool, 0, 0)

    def _degrade(self, site, exc):
        """A failed draft launch costs accept rate, not output: count it,
        heal a half-written pool, go on.  `_fatal` failures raise."""
        if _fatal(exc):
            raise exc
        telemetry.inc("serve.draft_degraded")
        telemetry.record_event("serve_draft_degraded", site=site,
                               error=str(exc)[:200])
        if self._pool_lost():
            self._init_pool()

    def propose(self, seqs, k, bucket, host, dev, samp):
        token_d, pos_d, tables_d = dev
        try:
            out = self._draft(token_d, pos_d, tables_d, samp)
            self.launches += 1
            return out.cpu().numpy()   # the round's one host fetch
        except Exception as exc:  # noqa: BLE001 -- scoped in _degrade
            self._degrade("propose", exc)
            # junk proposals: the verify rejects them, and the round
            # advances each row by the target's one token
            return np.repeat(np.asarray(host[0])[:, None], k, axis=1)

    def on_prefill_chunk(self, toks_d, start_d, length_d, table_d):
        try:
            _, self._pool = self.model.prefill_paged(
                self._dparams, self._pool, toks_d, start_d, length_d,
                table_d)
            self.launches += 1
            self.prefill_chunks += 1
        except Exception as exc:  # noqa: BLE001 -- scoped in _degrade
            self._degrade("prefill", exc)

    def on_restore_span(self, toks_d, start_d, length_d, table_d):
        # the target got the span back as bytes; the draft pool prefills
        # the same tokens through the draft model
        self.on_prefill_chunk(toks_d, start_d, length_d, table_d)

    def on_cow(self, src, dst):
        try:
            self._pool = self.model.copy_block(self._pool, src, dst)
        except Exception as exc:  # noqa: BLE001 -- scoped in _degrade
            self._degrade("cow", exc)

    def on_cache_rebuild(self):
        self._init_pool()


def make_drafter(kind, **kw):
    """A drafter by its ``MXNET_SERVE_SPEC_DRAFTER`` name (a `Drafter` is
    returned as it is)."""
    if isinstance(kind, Drafter):
        return kind
    if kind == "ngram":
        return NgramDrafter(**kw)
    if kind == "model":
        return ModelDrafter(**kw)
    raise MXNetError("make_drafter: unknown drafter %r "
                     "(expected 'ngram' or 'model')" % (kind,))
