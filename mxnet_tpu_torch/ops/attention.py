"""Serving attention over a K/V cache, in plain torch.

Ports of `mxnet_tpu/ops/attention.py` `decode_attention`,
`gather_paged_kv`, `paged_decode_attention` and `chunk_attention`.  The
JAX package wrote no Pallas kernel for these (XLA fuses them), so they
stay torch ops here.  Softmax statistics are float32 whatever the cache
dtype, and cache rows no query may attend have their V zeroed explicitly,
so a softmax weight of 0 multiplies an exact 0 and never stale garbage.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["decode_attention", "gather_paged_kv", "paged_decode_attention",
           "chunk_attention"]


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
