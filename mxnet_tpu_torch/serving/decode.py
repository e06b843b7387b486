"""KV-cache prefill/decode functions for the transformer LM, in PyTorch.

A port of `mxnet_tpu/serving/decode.py` `TransformerKVModel`: the same
geometry, the same parameter names and (out, in) weight layouts, the
same cache layouts, the same programs.

* ``prefill`` forwards a right-padded prompt through the flash-attention
  kernel and returns the logits of each row's last real token plus the
  per-layer K/V to write into the slot cache (``write_prefill``);
* ``decode`` runs one token per row over the slot cache
  (num_layers, 2, n_slots, S_max, embed);
* ``prefill_paged`` / ``decode_paged`` do the same over the paged block
  pool (num_layers, 2, n_blocks, block_size, embed) through int32 block
  tables, with `chunk_attention` / `paged_decode_attention`.

Every program runs LayerNorm through the port's kernel, 2L + 1 times.
PyTorch runs eagerly, so the cache and the pool are updated in place
(the JAX programs donate them); each method still returns the buffer so
the call sites read as the JAX ones.  Parameters are a ``{name: tensor}``
dict; `params_from_jax` carries a JAX parameter dict (numpy arrays)
across with a check of every name and shape.  The quantized, MoE,
megastep, verify and sharding methods wait for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import resolve
from ..ops.attention import (chunk_attention, decode_attention,
                             gather_paged_kv, paged_decode_attention)
from ..ops.pallas_kernels.flash_attention import flash_attention
from ..ops.pallas_kernels.layer_norm import layer_norm

__all__ = ["TransformerKVModel"]


class TransformerKVModel:
    """Prefill/decode programs for one transformer-LM geometry.

    Mirrors the JAX `TransformerKVModel(vocab_size, seq_len, num_layers,
    num_heads, num_embed, num_ffn_hidden, use_bias)`; ``seq_len`` is the
    maximum context (cache depth S_max) and ``dtype`` a torch dtype.
    """

    def __init__(self, vocab_size, seq_len, num_layers=2, num_heads=4,
                 num_embed=128, num_ffn_hidden=None, use_bias=True,
                 eps=1e-5, dtype=torch.float32):
        if num_embed % num_heads != 0:
            raise MXNetError("num_embed must be divisible by num_heads")
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.num_embed = int(num_embed)
        self.num_ffn_hidden = int(num_ffn_hidden or 4 * num_embed)
        self.use_bias = bool(use_bias)
        self.eps = float(eps)
        self.dtype = dtype

    # -- parameters --------------------------------------------------------
    def param_shapes(self):
        """{name: shape} of every weight the programs read, with the JAX
        package's names."""
        e, f, v = self.num_embed, self.num_ffn_hidden, self.vocab_size
        shapes = {
            "embed_weight": (v, e),
            "pos_embed_weight": (1, self.seq_len, e),
            "final_ln_gamma": (e,),
            "final_ln_beta": (e,),
            "pred_weight": (v, e),
        }
        if self.use_bias:
            shapes["pred_bias"] = (v,)
        for i in range(self.num_layers):
            p = "layer%d_" % i
            shapes[p + "ln1_gamma"] = (e,)
            shapes[p + "ln1_beta"] = (e,)
            shapes[p + "ln2_gamma"] = (e,)
            shapes[p + "ln2_beta"] = (e,)
            for proj, (nh, nin) in [("q", (e, e)), ("k", (e, e)),
                                    ("v", (e, e)), ("attn_out", (e, e)),
                                    ("ffn1", (f, e)), ("ffn2", (e, f))]:
                shapes[p + proj + "_weight"] = (nh, nin)
                if self.use_bias:
                    shapes[p + proj + "_bias"] = (nh,)
        return shapes

    def init_params(self, rng=None, scale=0.02):
        """Random float32 numpy parameters, drawn from ``rng`` (a
        `np.random.RandomState`) in the JAX package's order, so the same
        seed gives the same weights in both packages."""
        rng = rng or np.random.RandomState(0)
        params = {}
        for name, shape in self.param_shapes().items():
            if name.endswith("_gamma"):
                params[name] = np.ones(shape, np.float32)
            elif name.endswith(("_beta", "_bias")):
                params[name] = np.zeros(shape, np.float32)
            else:
                params[name] = (rng.randn(*shape) * scale).astype(np.float32)
        return params

    def check_params(self, params):
        missing = [n for n in self.param_shapes() if n not in params]
        if missing:
            raise MXNetError(
                "TransformerKVModel: params missing %s" % missing)

    def params_from_jax(self, params, device=None, dtype=None):
        """``{name: tensor}`` on ``device`` (default ``cuda:0``) in ``dtype``
        (default the model's) from a JAX parameter dict of numpy arrays.
        Names and (out, in) layouts are the same in both packages, so this
        is a copy; it raises on a missing, extra or misshapen entry."""
        device = resolve(device)
        dtype = self.dtype if dtype is None else dtype
        shapes = self.param_shapes()
        extra = sorted(set(params) - set(shapes))
        if extra:
            raise MXNetError("TransformerKVModel: unknown params %s" % extra)
        self.check_params(params)
        out = {}
        for name, shape in shapes.items():
            a = np.asarray(params[name], dtype=np.float32)
            if a.shape != shape:
                raise MXNetError("TransformerKVModel: %s has shape %s, want %s"
                                 % (name, a.shape, shape))
            out[name] = torch.from_numpy(a).to(device=device, dtype=dtype)
        return out

    def init_cache(self, n_slots, device=None):
        """Zeroed slot cache (num_layers, 2, n_slots, S_max, embed)."""
        return torch.zeros((self.num_layers, 2, int(n_slots), self.seq_len,
                            self.num_embed), dtype=self.dtype,
                           device=resolve(device))

    def init_block_pool(self, n_blocks, block_size, device=None):
        """Zeroed paged pool (num_layers, 2, n_blocks, block_size, embed);
        block 0 is the trash block."""
        return torch.zeros((self.num_layers, 2, int(n_blocks),
                            int(block_size), self.num_embed),
                           dtype=self.dtype, device=resolve(device))

    # -- shared pieces -----------------------------------------------------
    def _proj(self, params, x, name):
        return F.linear(x, params[name + "_weight"],
                        params.get(name + "_bias") if self.use_bias else None)

    def _ffn(self, params, h2, p):
        f = F.gelu(self._proj(params, h2, p + "ffn1"), approximate="tanh")
        return self._proj(params, f, p + "ffn2")

    def _ln(self, params, x, name):
        return layer_norm(x, params[name + "_gamma"], params[name + "_beta"],
                          self.eps)

    def _head(self, params, x):
        return self._proj(params, self._ln(params, x, "final_ln"), "pred")

    # -- prefill -----------------------------------------------------------
    def prefill(self, params, tokens, length):
        """Forward the right-padded prompt.

        tokens: (b, s) int, rows padded past ``length``; length: (b,) int,
        real tokens per row (>= 1).  Returns (logits (b, vocab) of each
        row's last real token, kv (num_layers, 2, b, s, embed))."""
        b, s = tokens.shape
        h, e = self.num_heads, self.num_embed
        x = params["embed_weight"][tokens.long()] + \
            params["pos_embed_weight"][0, :s]
        kv = []
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hf = self._ln(params, x, p + "ln1").reshape(-1, e)
            q = self._proj(params, hf, p + "q").reshape(b, s, e)
            k = self._proj(params, hf, p + "k").reshape(b, s, e)
            v = self._proj(params, hf, p + "v").reshape(b, s, e)
            kv.append(torch.stack([k, v]))

            # (b, s, e) -> (b, h, s, hd) as a view: the kernel takes strides
            def heads(t):
                return t.reshape(b, s, h, e // h).transpose(1, 2)
            attn = flash_attention(heads(q), heads(k), heads(v), causal=True)
            attn = attn.transpose(1, 2).reshape(-1, e)
            x = x + self._proj(params, attn, p + "attn_out").reshape(b, s, e)
            hn = self._ln(params, x, p + "ln2")
            x = x + self._ffn(params, hn.reshape(-1, e), p).reshape(b, s, e)
        last = x[torch.arange(b, device=x.device), length.long() - 1]
        return self._head(params, last), torch.stack(kv)

    def write_prefill(self, cache, kv, length, slots):
        """Write a prefill's (num_layers, 2, b, s, embed) K/V into the slot
        cache at ``slots``, rows 0..s-1, in place.  ``length`` is unused,
        as in the JAX package (decode never attends past its position)."""
        s = kv.shape[3]
        cache[:, :, slots.long(), :s] = kv.to(cache.dtype)
        return cache

    # -- decode ------------------------------------------------------------
    def decode(self, params, cache, token, pos, slots):
        """One generation step over the slot cache, updated in place.

        token, pos, slots: (b,) int — each row's current token, the
        position it occupies and its cache slot (padding rows point at
        the engine's trash slot).  Returns (logits (b, vocab), cache)."""
        pos = pos.long()
        slots = slots.long()
        x = params["embed_weight"][token.long()] + \
            params["pos_embed_weight"][0][pos]
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hn = self._ln(params, x, p + "ln1")
            q = self._proj(params, hn, p + "q")
            k = self._proj(params, hn, p + "k")
            v = self._proj(params, hn, p + "v")
            cache[i, 0, slots, pos] = k.to(cache.dtype)
            cache[i, 1, slots, pos] = v.to(cache.dtype)
            attn = decode_attention(q, cache[i, 0][slots], cache[i, 1][slots],
                                    pos, self.num_heads)
            x = x + self._proj(params, attn, p + "attn_out")
            hn = self._ln(params, x, p + "ln2")
            x = x + self._ffn(params, hn, p)
        return self._head(params, x), cache

    # -- paged cache -------------------------------------------------------
    def prefill_paged(self, params, pool, tokens, start, length, tables):
        """One chunked-prefill step over the paged pool, updated in place.

        tokens: (b, c) int, a prompt chunk padded past ``length``; c is a
        multiple of the block size.  start: (b,) int, the chunk's
        absolute start (block-aligned).  length: (b,) int, real tokens in
        this chunk.  tables: (b, m) int block tables covering the chunk.
        Returns (logits of each row's last real chunk token, pool)."""
        b, c = tokens.shape
        h, e = self.num_heads, self.num_embed
        bs = pool.shape[3]
        m = tables.shape[1]
        start = start.long()
        tables = tables.long()
        nb = c // bs
        # table entries of the chunk; those past the table (a short final
        # chunk's padding) go to the trash block explicitly
        ent = start[:, None] // bs + torch.arange(nb, device=tables.device)
        blk = torch.gather(tables, 1, ent.clamp(max=m - 1))
        blk = torch.where(ent < m, blk, 0)                     # (b, nb)
        # a short final chunk's padding can run past seq_len: clamp its
        # (never attended) positions into the table
        positions = start[:, None] + torch.arange(c, device=tables.device)
        x = params["embed_weight"][tokens.long()] + \
            params["pos_embed_weight"][0][positions.clamp(max=self.seq_len - 1)]
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hf = self._ln(params, x, p + "ln1").reshape(-1, e)
            q = self._proj(params, hf, p + "q").reshape(b, c, e)
            k = self._proj(params, hf, p + "k").reshape(b, c, e)
            v = self._proj(params, hf, p + "v").reshape(b, c, e)
            # write the chunk's rows into their blocks, then gather the
            # whole context so the chunk attends to itself too
            pool[i, 0, blk] = k.reshape(b, nb, bs, e).to(pool.dtype)
            pool[i, 1, blk] = v.reshape(b, nb, bs, e).to(pool.dtype)
            kc = gather_paged_kv(pool[i, 0], tables)
            vc = gather_paged_kv(pool[i, 1], tables)
            attn = chunk_attention(q, kc, vc, start, h)
            x = x + self._proj(params, attn.reshape(-1, e),
                               p + "attn_out").reshape(b, c, e)
            hn = self._ln(params, x, p + "ln2")
            x = x + self._ffn(params, hn.reshape(-1, e), p).reshape(b, c, e)
        last = x[torch.arange(b, device=x.device), length.long() - 1]
        return self._head(params, last), pool

    def decode_paged(self, params, pool, token, pos, tables):
        """One generation step over the paged pool, updated in place.

        token, pos: (b,) int; tables: (b, m) int (padding rows are all
        trash with pos 0, so their writes land in the trash block).
        Returns (logits (b, vocab), pool)."""
        bs = pool.shape[3]
        m = tables.shape[1]
        pos = pos.long()
        tables = tables.long()
        ent = pos // bs
        blk = torch.gather(tables, 1, ent.clamp(max=m - 1)[:, None])[:, 0]
        blk = torch.where(ent < m, blk, 0)
        off = pos % bs
        x = params["embed_weight"][token.long()] + \
            params["pos_embed_weight"][0][pos.clamp(max=self.seq_len - 1)]
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hn = self._ln(params, x, p + "ln1")
            q = self._proj(params, hn, p + "q")
            k = self._proj(params, hn, p + "k")
            v = self._proj(params, hn, p + "v")
            pool[i, 0, blk, off] = k.to(pool.dtype)
            pool[i, 1, blk, off] = v.to(pool.dtype)
            attn = paged_decode_attention(q, pool[i, 0], pool[i, 1], tables,
                                          pos, self.num_heads)
            x = x + self._proj(params, attn, p + "attn_out")
            hn = self._ln(params, x, p + "ln2")
            x = x + self._ffn(params, hn, p)
        return self._head(params, x), pool
