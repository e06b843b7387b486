"""Attention-family ops: the training ops and the serving helpers.

Ports of `mxnet_tpu/ops/attention.py`:

* the `DotProductAttention` op in both layouts, over the flash-attention
  kernels (`flash_attention` on (B, H, S, D) operands, `flash_attention_bsd`
  on (B, S, E) ones), and the `LayerNorm` op over the LayerNorm kernels;
  both differentiate through the kernels' backward passes;
* the serving helpers `decode_attention`, `gather_paged_kv`,
  `paged_decode_attention`, `chunk_attention` and speculative decoding's
  `verify_attention`, and the `DecodeAttention` op over
  `decode_attention`.  The JAX package wrote no Pallas kernel for these
  (XLA fuses them), so they stay torch ops.

The ops call the kernel functions through this module's globals, so a
caller can swap in their plain versions (`chip_smoke.py` does, for its
gradient check).  In the serving helpers, softmax statistics are float32
whatever the cache dtype, and cache rows no query may attend have their V
zeroed explicitly, so a softmax weight of 0 multiplies an exact 0 and
never stale garbage.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .pallas_kernels.flash_attention import (flash_attention,
                                             flash_attention_bsd)
from .pallas_kernels.layer_norm import layer_norm
from .registry import OpDef, Param, register

__all__ = ["decode_attention", "gather_paged_kv", "gather_paged_scales",
           "paged_decode_attention",
           "chunk_attention", "verify_attention"]


class DotProductAttention(OpDef):
    """Fused scaled-dot-product attention, (batch, heads, seq, head_dim)
    operands or, with ``layout='bsd'``, (batch, seq, embed) ones with
    ``num_heads``.

    softmax(Q K^T * scale) V without materializing the score matrix.
    ``scale`` defaults to 1/sqrt(head_dim); ``causal=True`` applies a lower
    triangular mask.  ``block_q``/``block_k`` are the JAX package's tile
    knobs: ``block_k`` is passed on and sets the plain versions' K block
    (<= 0: the default); ``block_q`` is accepted, so the JAX package's
    symbol JSON loads, and has no effect (the plain versions have no Q
    block); the CUDA kernels keep their fixed 64-row tiles.
    """

    name = "DotProductAttention"
    params = {
        "causal": Param(bool, default=False),
        "scale": Param(float, default=None),
        "block_q": Param(int, default=0),
        "block_k": Param(int, default=0),
        "layout": Param(str, default="bhsd"),
        "num_heads": Param(int, default=0),
    }

    def list_arguments(self, params):
        return ["query", "key", "value"]

    def infer_shape(self, params, in_shapes):
        q, k, v = in_shapes
        if k is None and v is not None:
            k = v
        if v is None and k is not None:
            v = k
        if params["layout"] == "bsd":
            if params["num_heads"] < 1:
                raise MXNetError(
                    "DotProductAttention(layout='bsd') requires num_heads")
            for name, s in (("query", q), ("key", k), ("value", v)):
                if s is not None and len(s) != 3:
                    raise MXNetError(
                        "DotProductAttention(layout='bsd'): %s must be "
                        "(batch, seq, embed), got %s" % (name, s))
                if s is not None and s[-1] % params["num_heads"] != 0:
                    raise MXNetError(
                        "DotProductAttention: embed %d not divisible by "
                        "num_heads %d" % (s[-1], params["num_heads"]))
        else:
            for name, s in (("query", q), ("key", k), ("value", v)):
                if s is not None and len(s) != 4:
                    raise MXNetError(
                        "DotProductAttention: %s must be (batch, heads, "
                        "seq, head_dim), got %s" % (name, s))
        if k is not None and v is not None and k != v:
            raise MXNetError(
                "DotProductAttention: key %s and value %s must match"
                % (k, v))
        if q is not None and k is not None and (
                q[0] != k[0] or q[-1] != k[-1] or
                (len(q) == 4 and q[1] != k[1])):
            raise MXNetError(
                "DotProductAttention: query %s and key %s must agree on "
                "(batch, heads, head_dim)" % (q, k))
        out = None
        if q is not None:
            out = tuple(q)
        return [q, k, v], [out], []

    def apply(self, octx, params, inputs, aux):
        q, k, v = inputs
        # the output is tagged "attn_out" for MXNET_BACKWARD_MIRROR_POLICY
        # attn and streams (`remat.save_only_these_names`): the flash
        # forward itself carries the name, so a policy that keeps it keeps
        # the kernel's out and lse
        if params["layout"] == "bsd":
            out = flash_attention_bsd(q, k, v, params["num_heads"],
                                      causal=params["causal"],
                                      scale=params["scale"],
                                      block_k=params["block_k"],
                                      name="attn_out")
        else:
            out = flash_attention(q, k, v, causal=params["causal"],
                                  scale=params["scale"],
                                  block_k=params["block_k"], name="attn_out")
        return [out], []


register(DotProductAttention, aliases=("Attention",))


class LayerNorm(OpDef):
    """Layer normalization over the last axis (transformer-era counterpart
    of `src/operator/batch_norm-inl.h`; no running stats)."""

    name = "LayerNorm"
    params = {"eps": Param(float, default=1e-5)}

    def list_arguments(self, params):
        return ["data", "gamma", "beta"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        c = (d[-1],)
        return [d, c, c], [d], []

    def apply(self, octx, params, inputs, aux):
        x, gamma, beta = inputs
        return [layer_norm(x, gamma, beta, params["eps"])], []


register(LayerNorm)


def _head_dim(e, num_heads, what):
    if e % num_heads != 0:
        raise MXNetError("%s: embed %d not divisible by num_heads %d"
                         % (what, e, num_heads))
    return e // num_heads


def decode_attention(q, k_cache, v_cache, pos, num_heads, *, scale=None):
    """Single-token attention over a per-sequence K/V cache.

    q: (b, e); k_cache/v_cache: (b, S, e), rows 0..pos[b] valid (the row's
    own K/V already written at pos[b]); pos: (b,) int.  Returns (b, e) in
    q's dtype."""
    b, s, e = k_cache.shape
    hd = _head_dim(e, num_heads, "decode_attention")
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    qh = q.reshape(b, num_heads, hd).float()
    kh = k_cache.reshape(b, s, num_heads, hd).float()
    valid = (torch.arange(s, device=q.device)[None, :]
             <= pos.long()[:, None])                        # (b, s)
    vh = torch.where(valid[:, :, None, None],
                     v_cache.reshape(b, s, num_heads, hd).float(), 0.0)
    scores = torch.einsum("bhd,bshd->bhs", qh, kh) * scale
    scores = torch.where(valid[:, None, :], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, vh)
    return out.reshape(b, e).to(q.dtype)


def gather_paged_kv(pool, block_tables):
    """Per-row K (or V) context from one layer's block pool.

    pool: (n_blocks, block_size, e); block_tables: (b, m) int.  Returns
    (b, m * block_size, e).  Tables may alias (the trash block fills
    every padding tail): a gather only reads."""
    b, m = block_tables.shape
    _, bs, e = pool.shape
    return pool[block_tables.long()].reshape(b, m * bs, e)


def gather_paged_scales(scales, block_tables):
    """Per-row dequantization scales from one layer's paged scale pool,
    the int8-KV companion of `gather_paged_kv`.

    scales: (n_blocks, block_size) f32, one layer's K (or V) per-row
    scales, indexed like the int8 pool; block_tables: (b, m) int.
    Returns (b, m * block_size): multiply onto the gathered int8 rows
    (``kc.float() * sc[..., None]``) before the attention math; position
    masking hides the same tail rows as ever."""
    b, m = block_tables.shape
    return scales[block_tables.long()].reshape(b, m * scales.shape[1])


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos, num_heads,
                           *, scale=None):
    """`decode_attention` over a paged K/V pool: gather each row's blocks
    by table, then the same position-masked attention."""
    kc = gather_paged_kv(k_pool, block_tables)
    vc = gather_paged_kv(v_pool, block_tables)
    return decode_attention(q, kc, vc, pos, num_heads, scale=scale)


def chunk_attention(q, k_cache, v_cache, start, num_heads, *, scale=None):
    """Chunked-prefill attention: a c-token chunk at absolute positions
    start .. start+c-1 attends to the cached prefix and, causally, to
    itself.

    q: (b, c, e); k_cache/v_cache: (b, S, e) with the chunk's own rows
    already written; start: (b,) int.  Returns (b, c, e) in q's dtype."""
    b, c, e = q.shape
    s = k_cache.shape[1]
    hd = _head_dim(e, num_heads, "chunk_attention")
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    qh = q.reshape(b, c, num_heads, hd).float()
    kh = k_cache.reshape(b, s, num_heads, hd).float()
    start = start.long()
    cols = torch.arange(s, device=q.device)
    written = cols[None, :] < (start + c)[:, None]           # (b, s)
    vh = torch.where(written[:, :, None, None],
                     v_cache.reshape(b, s, num_heads, hd).float(), 0.0)
    scores = torch.einsum("bchd,bshd->bhcs", qh, kh) * scale
    qpos = start[:, None] + torch.arange(c, device=q.device)[None, :]
    valid = cols[None, None, :] <= qpos[:, :, None]          # (b, c, s)
    scores = torch.where(valid[:, None], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhcs,bshd->bchd", p, vh)
    return out.reshape(b, c, e).to(q.dtype)


def verify_attention(q, k_cache, v_cache, start, length, num_heads, *,
                     scale=None):
    """Length-masked multi-query attention, speculative decoding's verify:
    a c-token chunk at absolute positions start .. start+c-1 attends to
    the cached prefix and, causally, to itself, but only the first
    ``length[b]`` chunk tokens of a row are real.  Chunk keys past them
    are masked for every query; a query's own position stays visible, so
    a query past ``length`` keeps a finite softmax (its output is never
    used).  ``length == c`` is `chunk_attention`.

    q: (b, c, e); k_cache/v_cache: (b, S, e) with the chunk's rows already
    written; start, length: (b,) int, 1 <= length <= c.  Returns (b, c, e)
    in q's dtype."""
    b, c, e = q.shape
    s = k_cache.shape[1]
    hd = _head_dim(e, num_heads, "verify_attention")
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    qh = q.reshape(b, c, num_heads, hd).float()
    kh = k_cache.reshape(b, s, num_heads, hd).float()
    start = start.long()
    cols = torch.arange(s, device=q.device)
    written = cols[None, :] < (start + c)[:, None]           # (b, s)
    vh = torch.where(written[:, :, None, None],
                     v_cache.reshape(b, s, num_heads, hd).float(), 0.0)
    scores = torch.einsum("bchd,bshd->bhcs", qh, kh) * scale
    qpos = start[:, None] + torch.arange(c, device=q.device)[None, :]
    j = cols[None, None, :]
    causal = j <= qpos[:, :, None]                           # (b, c, s)
    real = (j < (start + length.long())[:, None, None]) | \
        (j == qpos[:, :, None])
    scores = torch.where((causal & real)[:, None], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhcs,bshd->bchd", p, vh)
    return out.reshape(b, c, e).to(q.dtype)


class DecodeAttention(OpDef):
    """`decode_attention` as an op of the registry, so a KV-cache decode
    graph can be written as a symbol: query (batch, embed), key and value
    caches (batch, S_max, embed), pos (batch,)."""

    name = "DecodeAttention"
    params = {
        "num_heads": Param(int, required=True),
        "scale": Param(float, default=None),
    }

    def list_arguments(self, params):
        return ["query", "key_cache", "value_cache", "pos"]

    def infer_shape(self, params, in_shapes):
        q, kc, vc, pos = in_shapes
        if kc is None and vc is not None:
            kc = vc
        if vc is None and kc is not None:
            vc = kc
        for name, shp, rank in (("query", q, 2), ("key_cache", kc, 3),
                                ("value_cache", vc, 3), ("pos", pos, 1)):
            if shp is not None and len(shp) != rank:
                raise MXNetError(
                    "DecodeAttention: %s must be rank %d, got %s"
                    % (name, rank, shp))
        if kc is not None and vc is not None and kc != vc:
            raise MXNetError(
                "DecodeAttention: key_cache %s and value_cache %s must "
                "match" % (kc, vc))
        if q is not None and kc is not None and (
                q[0] != kc[0] or q[-1] != kc[-1]):
            raise MXNetError(
                "DecodeAttention: query %s and key_cache %s must agree on "
                "(batch, embed)" % (q, kc))
        out = tuple(q) if q is not None else None
        if q is not None and pos is None:
            pos = (q[0],)
        return [q, kc, vc, pos], [out], []

    def apply(self, octx, params, inputs, aux):
        q, kc, vc, pos = inputs
        return [decode_attention(q, kc, vc, pos.long(), params["num_heads"],
                                 scale=params["scale"])], []


register(DecodeAttention)
