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
  tables, with `chunk_attention` / `decode_attention` over the gathered
  (under KV quant, dequantized) context;
* ``copy_block`` copies one block of the pool to another, the prefix
  cache's copy-on-write (plain indexing, as the JAX one is a gather and
  a scatter outside any Pallas kernel);
* ``verify_paged`` scores a speculative draft run, k+1 tokens a row at
  arbitrary positions, over the paged pool with `verify_attention`;
* ``decode_megastep`` runs m steps of ``decode_paged`` with per-row
  active masks, so a row that finishes mid-run retires on the device;
* ``slice_block`` / ``write_block`` read one block out for a host-tier
  spill and scatter a staged run of blocks back in (the restore).

Quantization (`mxnet_tpu_torch.quant`), both off by default:

* ``quant`` (weights, int8 or fp8): `quantize_params` replaces every 2-D
  matmul weight by its 1-byte storage under the same name, with the
  per-output-channel f32 scales beside it as ``<name>_qscale``, and every
  program runs scaled matmuls, ``y = (x @ W_q.T) * scale`` in f32 then
  the downcast (a plain product, never in TF32); the embedding gathers
  1-byte rows and scales each by its entry's scale;
* ``kv_quant`` (paged pool, int8): the pool becomes the pair ``(int8
  pool (L, 2, n_blocks, bs, E), f32 scales (L, 2, n_blocks, bs))``,
  quantized on write at every scatter (prefill chunks, decode rows,
  verify spans, megastep steps, `copy_block`, `write_block`) and
  dequantized at every gather, one scale per cached token row.  Scales
  are indexed by block, so sharing, copy-on-write, spill and restore
  carry them beside the rows.

The token embedding is the JAX model's ``jnp.take``
(`ops.indexing.take_rows`): a token outside [-V, V) embeds as a NaN row,
so its request decodes from NaN logits as in the JAX engine, and no
gather trips a device-side assert.

Every program runs LayerNorm through the port's kernel, 2L + 1 times.
PyTorch runs eagerly, so the cache and the pool are updated in place
(the JAX programs donate them); each method still returns the buffer so
the call sites read as the JAX ones.  In place of the JAX package's
donation, a program that writes the cache first sets a write mark on it
and clears the mark when it returns: a program that raises between the
two has left the cache half-written, and `cache_lost` reads the mark (the
JAX `cache_lost` asks whether a failed launch consumed the donated
buffer).  Parameters are a ``{name: tensor}``
dict; `params_from_jax` carries a JAX parameter dict (numpy arrays)
across with a check of every name and shape.

MoE (``moe_experts=E > 0``): every layer's dense FFN becomes a top-1
routed mixture of E expert FFNs (`_ffn`), dispatched densely as in the
JAX package, so a row's result never depends on its batch.  Every
program takes ``moe_tape``, a list that collects the per-expert routed
row counts of each layer (padding rows included); `decode_megastep`
appends one count summed over its steps and layers.

Sub-mesh replicas: `param_shardings` and `kv_shardings` give the JAX
package's split rules as plain descriptors (the axis a tensor splits on,
or None), and `shard_params` cuts a parameter dict into per-shard dicts.
Every program is written once, over the model's `ShardPlan`: the
unsharded model is the one-shard plan (one device, one attention unit of
full width, every group replicated), and `sharded.ShardedKVModel` swaps
in a k-shard plan with its own parameter and buffer layouts.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import resolve
from ..ops.attention import (chunk_attention, decode_attention,
                             gather_paged_kv, gather_paged_scales,
                             verify_attention)
from ..ops.indexing import as_index, in_range, take_rows
from ..ops.pallas_kernels.flash_attention import flash_attention
from ..ops.pallas_kernels.layer_norm import layer_norm
from ..parallel.mesh import _device
from ..quant.codec import quantize, quantize_rows, row_amax
from ..quant.codec import resolve as quant_resolve

__all__ = ["TransformerKVModel"]


class ShardPlan:
    """Where a k-way shard axis puts a model's work.

    ``devices`` is each shard's device, in shard order; ``devs`` the
    distinct devices in order of first appearance (``home``, shard 0's, is
    first); ``groups`` which weight groups split (`TransformerKVModel.
    shard_groups`); ``units`` the attention units, each ``(device, lo,
    hi, shard)``: the embed columns [lo, hi) of one shard's heads when the
    heads split, else one whole-width unit per distinct device fed by the
    first shard there.  ``ShardPlan(model)`` is the unsharded model's
    one-shard plan, keyed by None: the device its tensors lie on."""

    def __init__(self, model, devices=(None,)):
        self.devices = [None if d is None else _device(d) for d in devices]
        self.k = len(self.devices)
        if self.k < 1:
            raise MXNetError("ShardPlan: no devices")
        self.devs = []
        self.first = {}
        for s, d in enumerate(self.devices):
            if d not in self.first:
                self.first[d] = s
                self.devs.append(d)
        self.home = self.devs[0]
        self.groups = model.shard_groups(self.k)
        e = model.num_embed
        if self.groups["heads"]:
            w = e // self.k
            self.units = [(d, s * w, (s + 1) * w, s)
                          for s, d in enumerate(self.devices)]
        else:
            self.units = [(d, 0, e, self.first[d]) for d in self.devs]

    def signature(self):
        return (self.k, tuple(str(d) for d in self.devices))


class TransformerKVModel:
    """Prefill/decode programs for one transformer-LM geometry.

    Mirrors the JAX `TransformerKVModel(vocab_size, seq_len, num_layers,
    num_heads, num_embed, num_ffn_hidden, use_bias, quant, kv_quant,
    moe_experts)`; ``seq_len`` is the maximum context (cache depth S_max)
    and ``dtype`` a torch dtype.
    """

    def __init__(self, vocab_size, seq_len, num_layers=2, num_heads=4,
                 num_embed=128, num_ffn_hidden=None, use_bias=True,
                 eps=1e-5, dtype=torch.float32, quant=None, kv_quant=None,
                 moe_experts=0):
        if num_embed % num_heads != 0:
            raise MXNetError("num_embed must be divisible by num_heads")
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.num_embed = int(num_embed)
        self.num_ffn_hidden = int(num_ffn_hidden or 4 * num_embed)
        self.use_bias = bool(use_bias)
        # > 0: every layer's FFN is a top-1 routed mixture of this many
        # biasless expert FFNs (`_ffn`)
        self.moe_experts = int(moe_experts or 0)
        self.eps = float(eps)
        self.dtype = dtype
        # post-training quantization specs (None: full precision)
        self.quant = quant_resolve(quant)
        self.kv_quant = quant_resolve(kv_quant)
        # where the programs' work goes: one shard, unless a sub-mesh
        # replica swaps in its own (`sharded.ShardedKVModel`)
        self.plan = ShardPlan(self)

    def with_quant(self, quant, kv_quant):
        """A shallow copy of this geometry with the given quantization
        specs (self when they are already these), so one model object
        serves a quantized engine and its full-precision oracle side by
        side."""
        quant = quant_resolve(quant)
        kv_quant = quant_resolve(kv_quant)
        if quant == self.quant and kv_quant == self.kv_quant:
            return self
        m = copy.copy(self)
        m.quant = quant
        m.kv_quant = kv_quant
        return m

    # -- the write mark ----------------------------------------------------
    # A paged pool under KV quant is the (pool, scales) pair; the mark
    # rides on the pool tensor.
    @staticmethod
    def _mark(cache):
        """Set the write mark: ``cache`` is about to be written in place."""
        (cache[0] if isinstance(cache, tuple) else cache)._mxt_writing = True

    @staticmethod
    def _unmark(cache):
        """Clear the write mark: the program writing ``cache`` returned."""
        (cache[0] if isinstance(cache, tuple) else cache)._mxt_writing = False
        return cache

    @staticmethod
    def cache_lost(cache):
        """True when a program that wrote ``cache`` in place raised before
        it returned, leaving rows half-written: the engine's probe for a
        lost cache (the JAX one: a failed launch consumed the donated
        buffer)."""
        t = cache[0] if isinstance(cache, tuple) else cache
        return bool(getattr(t, "_mxt_writing", False))

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
            projs = [("q", (e, e)), ("k", (e, e)), ("v", (e, e)),
                     ("attn_out", (e, e))]
            if not self.moe_experts:
                projs += [("ffn1", (f, e)), ("ffn2", (e, f))]
            for proj, (nh, nin) in projs:
                shapes[p + proj + "_weight"] = (nh, nin)
                if self.use_bias:
                    shapes[p + proj + "_bias"] = (nh,)
            if self.moe_experts:
                # the router and the expert banks, every expert's FFN
                # stacked on axis 0
                shapes[p + "moe_router_weight"] = (e, self.moe_experts)
                shapes[p + "moe_w1"] = (self.moe_experts, e, f)
                shapes[p + "moe_w2"] = (self.moe_experts, f, e)
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

    def _quant_weight_names(self):
        """The matmul weights weight quant applies to: every 2-D
        projection, the embedding and the head (per-channel scales need a
        channel axis).  LayerNorm gammas and betas, biases and the
        positional table stay full precision, and so do an MoE model's
        router and (E, ., .) expert banks, as in the JAX package."""
        names = ["embed_weight", "pred_weight"]
        projs = ("q", "k", "v", "attn_out")
        if not self.moe_experts:
            projs = projs + ("ffn1", "ffn2")
        for i in range(self.num_layers):
            p = "layer%d_" % i
            names += [p + s + "_weight" for s in projs]
        return names

    def quantize_params(self, params):
        """Quantize the matmul weights once at load: each becomes its
        int8/fp8 storage under the same name, with the per-output-channel
        f32 scales beside it as ``<name>_qscale`` (the programs take the
        scaled matmul wherever that key exists).  Numpy or torch values
        alike; idempotent: an already quantized dict passes through."""
        if self.quant is None:
            return params
        if any(k.endswith("_qscale") for k in params):
            return params
        out = dict(params)
        for name in self._quant_weight_names():
            q, scale = quantize(out[name], self.quant, axis=0)
            out[name] = q
            out[name + "_qscale"] = scale
        return out

    # -- sub-mesh sharding rules -------------------------------------------
    def shard_groups(self, k):
        """Which weight groups a k-way shard axis splits: ``heads`` (q/k/v
        by whole heads, attn_out by the matching rows, and the K/V cache),
        ``ffn`` (ffn1 by columns, ffn2 by rows), ``vocab`` (the embedding
        and the pred head) and ``experts`` (MoE banks).  A group splits
        only when k > 1 divides it; the rest is replicated."""
        k = int(k)
        return {"heads": k > 1 and self.num_heads % k == 0,
                "ffn": (k > 1 and not self.moe_experts
                        and self.num_ffn_hidden % k == 0),
                "vocab": k > 1 and self.vocab_size % k == 0,
                "experts": (k > 1 and self.moe_experts > 0
                            and self.moe_experts % k == 0)}

    def param_shardings(self, mesh, axis="model"):
        """``{name: split axis or None}`` for a sub-mesh serving replica,
        the JAX package's rules as plain descriptors: q/k/v/ffn1 weights
        and biases split on axis 0 (columns of the output), attn_out/ffn2
        weights on axis 1 (rows, their biases replicated: they add after
        the reduction), the embedding, the pred head and its bias by
        vocabulary (axis 0), MoE banks on the expert axis (0) with the
        router replicated, LayerNorm and ``pos_embed`` replicated, and
        ``<name>_qscale`` following its weight's axis 0.  A dimension the
        shard count does not divide stays replicated.  One deliberate
        difference: q/k/v/attn_out split by whole heads only
        (``num_heads % k == 0``); else attention is replicated."""
        g = self.shard_groups(mesh.shape[axis])
        out = {}
        for name in self.param_shapes():
            ax = None
            if name.endswith(("moe_w1", "moe_w2")):
                ax = 0 if g["experts"] else None
            elif name.endswith("moe_router_weight"):
                ax = None
            elif name in ("embed_weight", "pred_weight", "pred_bias"):
                ax = 0 if g["vocab"] else None
            elif name.endswith(("q_weight", "k_weight", "v_weight",
                                "q_bias", "k_bias", "v_bias")):
                ax = 0 if g["heads"] else None
            elif name.endswith("attn_out_weight"):
                ax = 1 if g["heads"] else None
            elif name.endswith(("ffn1_weight", "ffn1_bias")):
                ax = 0 if g["ffn"] else None
            elif name.endswith("ffn2_weight"):
                ax = 1 if g["ffn"] else None
            out[name] = ax
        if self.quant is not None:
            for w in self._quant_weight_names():
                out[w + "_qscale"] = 0 if out[w] == 0 else None
        return out

    def kv_shardings(self, mesh, axis="model"):
        """(pool, scales) descriptors of the K/V buffers: the paged pool
        (L, 2, n_blocks, bs, E) and the slot cache split on the embed axis
        (4) by whole heads, so block tables stay replica-global, and the
        KV-quant row scales replicated; both replicated when the heads do
        not split."""
        heads = self.shard_groups(mesh.shape[axis])["heads"]
        return (4 if heads else None), None

    def shard_params(self, params, mesh, axis="model"):
        """Cut a parameter dict (tensors, or a JAX dict of numpy arrays)
        into a `sharded.ShardedParams` by `param_shardings`: each split
        tensor's slice a fresh tensor on its shard's device, each
        replicated one a single copy per distinct device."""
        from .sharded import ShardedParams, _new_like
        plan = ShardPlan(self, mesh.axis_devices(axis))
        axes = self.param_shardings(mesh, axis)
        if all(isinstance(v, torch.Tensor) for v in params.values()):
            self.check_params(params)
        else:
            params = self.params_from_jax(params, plan.home)
        shards = [{} for _ in range(plan.k)]
        for name, t in params.items():
            ax = axes.get(name)
            if ax is None:
                copies = {d: t.to(d) for d in plan.devs}
                for s, d in enumerate(plan.devices):
                    shards[s][name] = copies[d]
                continue
            n = t.shape[ax] // plan.k
            for s, d in enumerate(plan.devices):
                shards[s][name] = _new_like(t.narrow(ax, s * n, n), d)
        return ShardedParams(shards, plan, axes)

    def params_from_jax(self, params, device=None, dtype=None):
        """``{name: tensor}`` on ``device`` (default ``cuda:0``) in ``dtype``
        (default the model's) from a JAX parameter dict of numpy arrays.
        Names and (out, in) layouts are the same in both packages, so this
        is a copy; it raises on a missing, extra or misshapen entry.  A
        dict that `quantize_params` quantized carries across as it is:
        1-byte weights keep their storage (an fp8 array as its bits) and
        ``<name>_qscale`` stays f32."""
        device = resolve(device)
        dtype = self.dtype if dtype is None else dtype
        shapes = self.param_shapes()
        if any(k.endswith("_qscale") for k in params):
            shapes.update({n + "_qscale": shapes[n][:1]
                           for n in self._quant_weight_names()})
        extra = sorted(set(params) - set(shapes))
        if extra:
            raise MXNetError("TransformerKVModel: unknown params %s" % extra)
        missing = [n for n in shapes if n not in params]
        if missing:
            raise MXNetError(
                "TransformerKVModel: params missing %s" % missing)
        out = {}
        for name, shape in shapes.items():
            a = params[name]
            if isinstance(a, torch.Tensor):
                t = a
            elif np.asarray(a).dtype == np.int8:
                t = torch.from_numpy(np.array(a))
            elif np.asarray(a).dtype.name == "float8_e4m3fn":
                t = torch.from_numpy(np.array(a).view(np.uint8)).view(
                    torch.float8_e4m3fn)
            else:
                t = torch.from_numpy(np.asarray(a, dtype=np.float32))
            if tuple(t.shape) != shape:
                raise MXNetError("TransformerKVModel: %s has shape %s, want %s"
                                 % (name, tuple(t.shape), shape))
            if t.dtype in (torch.int8, torch.float8_e4m3fn):
                out[name] = t.to(device=device)
            elif name.endswith("_qscale"):
                out[name] = t.to(device=device, dtype=torch.float32)
            else:
                out[name] = t.to(device=device, dtype=dtype)
        return out

    def init_cache(self, n_slots, device=None):
        """Zeroed slot cache (num_layers, 2, n_slots, S_max, embed)."""
        return torch.zeros((self.num_layers, 2, int(n_slots), self.seq_len,
                            self.num_embed), dtype=self.dtype,
                           device=resolve(device))

    def init_block_pool(self, n_blocks, block_size, device=None):
        """Zeroed paged pool (num_layers, 2, n_blocks, block_size, embed),
        or under KV quant the pair of that pool in int8 and its per-row
        f32 scales (num_layers, 2, n_blocks, block_size); block 0 is the
        trash block."""
        shape = (self.num_layers, 2, int(n_blocks), int(block_size),
                 self.num_embed)
        device = resolve(device)
        if self.kv_quant is None:
            return torch.zeros(shape, dtype=self.dtype, device=device)
        return (torch.zeros(shape, dtype=self.kv_quant.dtype, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))

    def block_run_placeholder(self, k, block_size, pin=False):
        """Zeroed host staging buffers for a ``k``-block run, the restore's
        transfer payload: one (num_layers, 2, k, block_size, embed) tensor,
        or the (int8 data, f32 scales) pair under KV quant.  ``pin``
        allocates page-locked memory, for a non-blocking copy to a card."""
        shape = (self.num_layers, 2, int(k), int(block_size),
                 self.num_embed)
        if self.kv_quant is None:
            return torch.zeros(shape, dtype=self.dtype, pin_memory=pin)
        return (torch.zeros(shape, dtype=self.kv_quant.dtype, pin_memory=pin),
                torch.zeros(shape[:-1], dtype=torch.float32, pin_memory=pin))

    def slice_block(self, cache, block):
        """One block's rows, every layer, K and V: the spill payload (views
        into the pool), or the (int8 data, scales) pair under KV quant, so
        a spill never dequantizes."""
        pool, scales = self._pool_parts(cache)
        if scales is None:
            return pool[:, :, block]
        return pool[:, :, block], scales[:, :, block]

    def write_block(self, cache, dst, data):
        """Scatter a staged run of blocks, every layer, K and V, into the
        pool at blocks ``dst`` ((k,) int tensor on the pool's device), in
        place: the host-tier restore.  ``data`` is the (num_layers, 2, k,
        block_size, embed) tensor, or the (int8 data, scales) pair under
        KV quant; padding entries of ``dst`` point at the trash block.
        Sets the write mark like every in-place write.  Returns the
        pool."""
        pool, scales = self._pool_parts(cache)
        dst = dst.long()
        self._mark(cache)
        if scales is None:
            pool[:, :, dst] = data.to(pool.dtype)
        else:
            pool[:, :, dst] = data[0].to(pool.dtype)
            scales[:, :, dst] = data[1].to(torch.float32)
        return self._unmark(cache)

    # -- shared pieces -----------------------------------------------------
    def _pool_parts(self, cache):
        """``(pool, None)`` at full precision, ``(int8 pool, f32 scales)``
        under KV quant."""
        if self.kv_quant is not None:
            return cache
        return cache, None

    def _gather_ctx(self, pool, scales, layer, which, tables):
        """One layer's K (or V) context through the block tables,
        dequantized (f32 rows times their gathered scales) under KV
        quant."""
        ctx = gather_paged_kv(pool[layer, which], tables)
        if scales is None:
            return ctx
        sc = gather_paged_scales(scales[layer, which], tables)
        return ctx.float() * sc[..., None]

    def _proj(self, params, x, name):
        qs = params.get(name + "_weight_qscale")
        if qs is None:
            return F.linear(x, params[name + "_weight"],
                            params.get(name + "_bias") if self.use_bias
                            else None)
        # the scaled matmul: the 1-byte weight upcast, an f32 product,
        # the per-output-channel scale on the f32 result, then the
        # downcast, as the JAX package orders it
        y = (torch.matmul(x.float(), params[name + "_weight"].float().t())
             * qs).to(x.dtype)
        if self.use_bias:
            y = y + params[name + "_bias"]
        return y

    def _embed(self, params, tokens):
        """The token embedding, ``jnp.take``'s NaN rows for ids outside
        [-V, V) included; under weight quant the gathered 1-byte rows
        scale by their entry's scale."""
        qs = params.get("embed_weight_qscale")
        if qs is None:
            return take_rows(params["embed_weight"], tokens)
        wrapped, valid = in_range(as_index(tokens), self.vocab_size)
        rows = params["embed_weight"][wrapped].float() * qs[wrapped][..., None]
        return torch.where(valid[..., None], rows,
                           torch.full((), float("nan"), device=rows.device)
                           ).to(self.dtype)

    def _ffn(self, params, h2, p, tape=None):
        """Layer ``p``'s FFN over flattened (n, e) rows: gelu(ffn1) then
        ffn2, or with ``moe_experts`` a top-1 routed mixture of expert
        FFNs, the JAX package's `_ffn` step for step.  The router runs in
        f32 with a softmax; the gate is the top probability and the
        one-hot its argmax (the first index on a tie, in both packages).
        Dispatch is dense: every row runs every expert (gelu, tanh form)
        and the one-hot gate keeps the winner's output, so a row's result
        is one expert's FFN whatever the rest of the batch routed.  All
        of it in f32 (plain products, never TF32), cast back to the
        activation dtype.  ``tape`` (a list or None) collects this
        layer's (E,) routed row counts, padding rows included."""
        if not self.moe_experts:
            f = F.gelu(self._proj(params, h2, p + "ffn1"), approximate="tanh")
            return self._proj(params, f, p + "ffn2")
        x = h2.float()
        probs = torch.softmax(
            x @ params[p + "moe_router_weight"].float(), dim=-1)  # (n, E)
        gate = probs.amax(dim=-1)
        onehot = F.one_hot(probs.argmax(dim=-1),
                           self.moe_experts).to(torch.float32)
        if tape is not None:
            tape.append(onehot.sum(dim=0).to(torch.int32))
        hb = F.gelu(torch.einsum("nd,edf->nef", x,
                                 params[p + "moe_w1"].float()),
                    approximate="tanh")                         # (n, E, f)
        y = torch.einsum("nef,efd->ned", hb, params[p + "moe_w2"].float())
        return torch.einsum("ned,ne->nd", y,
                            onehot * gate[:, None]).to(h2.dtype)

    def _ln(self, params, x, name):
        return layer_norm(x, params[name + "_gamma"], params[name + "_beta"],
                          self.eps)

    def _head(self, params, x):
        return self._proj(params, self._ln(params, x, "final_ln"), "pred")

    # -- the programs' steps over the shard plan ----------------------------
    # A value of the residual stream is ``{device: tensor}``, one per
    # distinct device of the plan; ``pv`` is `_views` of the parameters.
    # The one-shard plan takes every replicated branch, which is the
    # unsharded model's arithmetic op for op.
    def _views(self, params):
        """``({device: dict}, [dict per shard])``: the dict whose
        replicated entries serve each distinct device, and each shard's
        own (its slices).  The one-shard plan's both hold ``params``."""
        return {None: params}, [params]

    def _unit_pools(self, cache):
        """Each attention unit's K/V buffer, and under KV quant the row
        scales per distinct device (else None)."""
        pool, scales = self._pool_parts(cache)
        return [pool], (None if scales is None else {None: scales})

    def _pack_kv(self, kv):
        """A slot prefill's K/V as `write_prefill` takes it: the one
        unit's (L, 2, b, s, embed)."""
        return kv[0]

    def _rep(self, t):
        """``t`` (on shard 0's device) as one tensor per distinct
        device."""
        devs = self.plan.devs
        if len(devs) == 1:
            return {devs[0]: t}
        return {d: (t if t.device == d else t.to(d)) for d in devs}

    def _reduce(self, parts):
        """The sum of the shards' partial results, in shard order, as one
        tensor per distinct device: on the shards' device when they share
        one, else on shard 0's, copied back."""
        total = parts[0]
        for p in parts[1:]:
            total = total + (p if p.device == total.device
                             else p.to(total.device))
        return self._rep(total)

    def _flat(self, x):
        return {d: t.reshape(-1, self.num_embed) for d, t in x.items()}

    def _ln_r(self, pv, x, name):
        return {d: self._ln(pv[0][d], x[d], name) for d in self.plan.devs}

    def _row_partial(self, p, x, name):
        """One shard's share of a row-split projection: its rows of the
        weight times its slice of the input, no bias, no scale (both apply
        after the reduction); f32 under weight quant."""
        w = p[name + "_weight"]
        if p.get(name + "_weight_qscale") is None:
            return F.linear(x, w)
        return torch.matmul(x.float(), w.float().t())

    def _row_finish(self, p, y, name, dtype):
        qs = p.get(name + "_weight_qscale")
        if qs is not None:
            y = (y * qs).to(dtype)
        if self.use_bias:
            y = y + p[name + "_bias"]
        return y

    def _embed_r(self, pv, tokens):
        """The token embedding per distinct device: replicated, or the
        vocab-split masked lookup and its reduction (``jnp.take``'s NaN
        rows for ids outside [-V, V) kept)."""
        g = self.plan
        pd, ps = pv
        tok = self._rep(tokens)
        if not g.groups["vocab"]:
            return {d: self._embed(pd[d], tok[d]) for d in g.devs}
        n = self.vocab_size // g.k
        parts = []
        for s, d in enumerate(g.devices):
            p = ps[s]
            wrapped, _ = in_range(as_index(tok[d]), self.vocab_size)
            local = wrapped - s * n
            mine = (local >= 0) & (local < n)
            idx = local.clamp(0, n - 1)
            rows = p["embed_weight"][idx]
            qs = p.get("embed_weight_qscale")
            if qs is not None:
                rows = rows.float() * qs[idx][..., None]
            parts.append(torch.where(mine[..., None], rows,
                                     torch.zeros((), dtype=rows.dtype,
                                                 device=rows.device)))
        tot = self._reduce(parts)
        out = {}
        for d in g.devs:
            _, valid = in_range(as_index(tok[d]), self.vocab_size)
            out[d] = torch.where(valid[..., None], tot[d],
                                 torch.full((), float("nan"),
                                            dtype=tot[d].dtype,
                                            device=tot[d].device)
                                 ).to(self.dtype)
        return out

    def _input(self, pv, tokens, positions):
        """Embedding plus the positional rows at ``positions`` (on shard
        0's device), per distinct device."""
        x = self._embed_r(pv, tokens)
        pr = self._rep(positions)
        return {d: x[d] + pv[0][d]["pos_embed_weight"][0][pr[d]]
                for d in self.plan.devs}

    def _qkv(self, pv, hn, p, shape):
        """Every unit's q, k, v from the normed input, each reshaped to
        ``shape + (e_u,)``."""
        out = []
        for d, lo, hi, src in self.plan.units:
            pu = pv[1][src]
            out.append(tuple(
                self._proj(pu, hn[d], p + w).reshape(shape + (hi - lo,))
                for w in ("q", "k", "v")))
        return out

    def _unit_heads(self, u):
        _, lo, hi, _ = self.plan.units[u]
        return self.num_heads * (hi - lo) // self.num_embed

    def _attn_out(self, pv, x, attn, p):
        """``x + attn_out(attn)`` per distinct device: the row-split
        projection reduced over the shards, or replicated when the heads
        do not split (``attn`` holds one unit per distinct device)."""
        g = self.plan
        pd, ps = pv
        name = p + "attn_out"
        if g.groups["heads"]:
            parts = [self._row_partial(ps[src], a, name)
                     for a, (_, _, _, src) in zip(attn, g.units)]
            y = self._reduce(parts)
            return {d: x[d] + self._row_finish(
                pd[d], y[d], name, attn[0].dtype).reshape(x[d].shape)
                for d in g.devs}
        return {d: x[d] + self._proj(pd[d], attn[j], name).reshape(
            x[d].shape) for j, d in enumerate(g.devs)}

    def _ffn_r(self, pv, hn, p, tape=None):
        """Layer ``p``'s FFN over flattened (n, e) rows per distinct
        device: column/row split and reduced, MoE expert-parallel (the
        router replicated, each shard's gated experts reduced: one nonzero
        term per row plus exact zeros), or replicated."""
        g = self.plan
        pd, ps = pv
        home = g.home
        if self.moe_experts and g.groups["experts"]:
            route = {}
            for d in g.devs:
                x = hn[d].float()
                probs = torch.softmax(
                    x @ pd[d][p + "moe_router_weight"].float(), dim=-1)
                gate = probs.amax(dim=-1)
                onehot = F.one_hot(probs.argmax(dim=-1),
                                   self.moe_experts).to(torch.float32)
                if tape is not None and d == home:
                    tape.append(onehot.sum(dim=0).to(torch.int32))
                route[d] = (x, onehot * gate[:, None])
            ne = self.moe_experts // g.k
            parts = []
            for s, d in enumerate(g.devices):
                x, wg = route[d]
                hb = F.gelu(torch.einsum("nd,edf->nef", x,
                                         ps[s][p + "moe_w1"].float()),
                            approximate="tanh")
                y = torch.einsum("nef,efd->ned", hb,
                                 ps[s][p + "moe_w2"].float())
                parts.append(torch.einsum("ned,ne->nd", y,
                                          wg[:, s * ne:(s + 1) * ne]))
            tot = self._reduce(parts)
            return {d: tot[d].to(hn[d].dtype) for d in g.devs}
        if self.moe_experts or not g.groups["ffn"]:
            return {d: self._ffn(pd[d], hn[d], p,
                                 tape if d == home else None)
                    for d in g.devs}
        parts = []
        for s, d in enumerate(g.devices):
            f = F.gelu(self._proj(ps[s], hn[d], p + "ffn1"),
                       approximate="tanh")
            parts.append(self._row_partial(ps[s], f, p + "ffn2"))
        y = self._reduce(parts)
        return {d: self._row_finish(pd[d], y[d], p + "ffn2", hn[d].dtype)
                for d in g.devs}

    def _ffn_block(self, pv, x, p, tape):
        """``x + ffn(ln2(x))`` per distinct device."""
        f = self._ffn_r(pv, self._flat(self._ln_r(pv, x, p + "ln2")), p,
                        tape)
        return {d: x[d] + f[d].reshape(x[d].shape) for d in self.plan.devs}

    def _head_r(self, pv, x):
        """The final LayerNorm and the head: replicated, on shard 0's
        device; or split by vocabulary, the LayerNorm per distinct device
        and the logits concatenated on shard 0's device."""
        g = self.plan
        if not g.groups["vocab"]:
            return self._head(pv[0][g.home], x[g.home])
        hn = self._ln_r(pv, x, "final_ln")
        return torch.cat([
            self._proj(pv[1][s], hn[d], "pred").to(hn[g.home].device)
            for s, d in enumerate(g.devices)], dim=-1)

    def _last(self, x, length):
        """Each row's last real position, per distinct device."""
        b = length.shape[0]
        idx = self._rep(length.long() - 1)
        return {d: t[torch.arange(b, device=t.device), idx[d]]
                for d, t in x.items()}

    def _write_units(self, pools, scales, idx, rows):
        """``pool[idx] = rows`` for every unit (``idx`` per distinct
        device): every scatter into the paged pool.  Under KV quant each
        row quantizes by the whole embed row's amax (the max over the
        units when the heads split), its scales written once per distinct
        device."""
        g = self.plan
        if scales is None:
            for u, (d, _, _, _) in enumerate(g.units):
                pools[u][idx[d]] = rows[u].to(pools[u].dtype)
            return
        amax = None
        if g.groups["heads"]:
            for r in rows:
                m = row_amax(r)
                amax = m if amax is None else torch.maximum(
                    amax, m if m.device == amax.device else m.to(amax.device))
            amax = self._rep(amax)
        sc = {}
        for u, (d, _, _, _) in enumerate(g.units):
            q, sc[d] = quantize_rows(rows[u], self.kv_quant,
                                     amax=None if amax is None else amax[d])
            pools[u][idx[d]] = q
        for d, t in scales.items():
            t[idx[d]] = sc[d]

    def _ctx(self, pools, scales, u, layer, which, tables):
        """Unit ``u``'s K (or V) context of one layer."""
        d = self.plan.units[u][0]
        return self._gather_ctx(pools[u], None if scales is None
                                else scales[d], layer, which, tables)

    # -- prefill -----------------------------------------------------------
    def prefill(self, params, tokens, length, moe_tape=None):
        """Forward the right-padded prompt.

        tokens: (b, s) int, rows padded past ``length``; length: (b,) int,
        real tokens per row (>= 1).  Returns (logits (b, vocab) of each
        row's last real token, kv (num_layers, 2, b, s, embed); a
        sub-mesh replica's per unit, each its heads' columns).
        ``moe_tape`` collects an MoE model's routed counts, a layer an
        entry.  Each attention unit runs the flash kernel on its heads."""
        g = self.plan
        pv = self._views(params)
        b, s = tokens.shape
        hd = self.num_embed // self.num_heads
        x = self._input(pv, tokens, torch.arange(s, device=tokens.device))
        kv = [[] for _ in g.units]
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hf = self._flat(self._ln_r(pv, x, p + "ln1"))
            attn = []
            for u, (q, k, v) in enumerate(self._qkv(pv, hf, p, (b, s))):
                kv[u].append(torch.stack([k, v]))
                hu = self._unit_heads(u)

                # (b, s, e_u) -> (b, h_u, s, hd) as a view: the kernel
                # takes strides
                def heads(t):
                    return t.reshape(b, s, hu, hd).transpose(1, 2)
                a = flash_attention(heads(q), heads(k), heads(v), causal=True)
                attn.append(a.transpose(1, 2).reshape(b * s, -1))
            x = self._attn_out(pv, x, attn, p)
            x = self._ffn_block(pv, x, p, moe_tape)
        return (self._head_r(pv, self._last(x, length)),
                self._pack_kv([torch.stack(k) for k in kv]))

    def write_prefill(self, cache, kv, length, slots):
        """Write a prefill's (num_layers, 2, b, s, embed) K/V into the slot
        cache at ``slots``, rows 0..s-1, in place.  ``length`` is unused,
        as in the JAX package (decode never attends past its position)."""
        s = kv.shape[3]
        self._mark(cache)
        cache[:, :, slots.long(), :s] = kv.to(cache.dtype)
        return self._unmark(cache)

    # -- decode ------------------------------------------------------------
    def decode(self, params, cache, token, pos, slots, moe_tape=None):
        """One generation step over the slot cache, updated in place.

        token, pos, slots: (b,) int — each row's current token, the
        position it occupies and its cache slot (padding rows point at
        the engine's trash slot).  Returns (logits (b, vocab), cache)."""
        g = self.plan
        pv = self._views(params)
        pools, _ = self._unit_pools(cache)
        pos = pos.long()
        pr = self._rep(pos)
        sl = self._rep(slots.long())
        b = token.shape[0]
        x = self._input(pv, token, pos)
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hn = self._ln_r(pv, x, p + "ln1")
            attn = []
            self._mark(cache)
            for u, (q, k, v) in enumerate(self._qkv(pv, hn, p, (b,))):
                d = g.units[u][0]
                c = pools[u]
                c[i, 0, sl[d], pr[d]] = k.to(c.dtype)
                c[i, 1, sl[d], pr[d]] = v.to(c.dtype)
                attn.append(decode_attention(q, c[i, 0][sl[d]],
                                             c[i, 1][sl[d]], pr[d],
                                             self._unit_heads(u)))
            x = self._attn_out(pv, x, attn, p)
            x = self._ffn_block(pv, x, p, moe_tape)
        return self._head_r(pv, x), self._unmark(cache)

    # -- paged cache -------------------------------------------------------
    def prefill_paged(self, params, pool, tokens, start, length, tables,
                      moe_tape=None):
        """One chunked-prefill step over the paged pool, updated in place.

        tokens: (b, c) int, a prompt chunk padded past ``length``; c is a
        multiple of the block size.  start: (b,) int, the chunk's
        absolute start (block-aligned).  length: (b,) int, real tokens in
        this chunk.  tables: (b, m) int block tables covering the chunk.
        Returns (logits of each row's last real chunk token, pool)."""
        cache = pool
        g = self.plan
        pv = self._views(params)
        pools, scales = self._unit_pools(cache)
        b, c = tokens.shape
        bs = pools[0].shape[3]
        m = tables.shape[1]
        start = start.long()
        tables = tables.long()
        nb = c // bs
        # table entries of the chunk; those past the table (a short final
        # chunk's padding) go to the trash block explicitly
        ent = start[:, None] // bs + torch.arange(nb, device=tables.device)
        blk = torch.gather(tables, 1, ent.clamp(max=m - 1))
        blk = self._rep(torch.where(ent < m, blk, 0))           # (b, nb)
        # a short final chunk's padding can run past seq_len: clamp its
        # (never attended) positions into the table
        positions = start[:, None] + torch.arange(c, device=tables.device)
        x = self._input(pv, tokens, positions.clamp(max=self.seq_len - 1))
        tr = self._rep(tables)
        sr = self._rep(start)
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hf = self._flat(self._ln_r(pv, x, p + "ln1"))
            qkv = self._qkv(pv, hf, p, (b, c))
            # write the chunk's rows into their blocks, then gather the
            # whole context so the chunk attends to itself too
            self._mark(cache)
            for which in (0, 1):
                self._write_units(
                    pools, scales, {d: (i, which, blk[d]) for d in g.devs},
                    [t[1 + which].reshape(b, nb, bs, -1) for t in qkv])
            attn = []
            for u, (q, _, _) in enumerate(qkv):
                d = g.units[u][0]
                a = chunk_attention(
                    q, self._ctx(pools, scales, u, i, 0, tr[d]),
                    self._ctx(pools, scales, u, i, 1, tr[d]), sr[d],
                    self._unit_heads(u))
                attn.append(a.reshape(b * c, -1))
            x = self._attn_out(pv, x, attn, p)
            x = self._ffn_block(pv, x, p, moe_tape)
        return (self._head_r(pv, self._last(x, length)),
                self._unmark(cache))

    def copy_block(self, pool, src, dst):
        """Copy one block's cached rows, every layer, K and V, from block
        ``src`` to block ``dst`` (ints or (1,) int tensors) in place: the
        copy-on-write body, so a writer about to touch a shared block
        gets a private copy and the original keeps serving its other
        readers.  Under KV quant the per-row scales copy with the rows, so
        the copy dequantizes as its original does.  Returns the pool."""
        cache = pool
        pool, scales = self._pool_parts(cache)
        src = torch.as_tensor(src, device=pool.device).long().reshape(-1)
        dst = torch.as_tensor(dst, device=pool.device).long().reshape(-1)
        self._mark(cache)
        pool[:, :, dst] = pool[:, :, src]
        if scales is not None:
            scales[:, :, dst] = scales[:, :, src]
        return self._unmark(cache)

    def gather_blocks(self, cache, idx):
        """The rows of blocks ``idx`` ((n,) int tensor on the pool's
        device), every layer, K and V, as one run (and their scales under
        KV quant): the handoff's pack."""
        pool, scales = self._pool_parts(cache)
        if scales is None:
            return pool[:, :, idx]
        return pool[:, :, idx], scales[:, :, idx]

    @staticmethod
    def cache_leaves(cache):
        """The tensors of a cache or pool value."""
        return list(cache) if isinstance(cache, tuple) else [cache]

    def poison_scales(self, cache, block):
        """NaN one block's per-row K/V scales (``scale_corrupt`` chaos)."""
        cache[1][:, :, block] = float("nan")

    def decode_paged(self, params, pool, token, pos, tables, moe_tape=None):
        """One generation step over the paged pool, updated in place.

        token, pos: (b,) int; tables: (b, m) int (padding rows are all
        trash with pos 0, so their writes land in the trash block).
        Returns (logits (b, vocab), pool)."""
        cache = pool
        g = self.plan
        pv = self._views(params)
        pools, scales = self._unit_pools(cache)
        bs = pools[0].shape[3]
        m = tables.shape[1]
        pos = pos.long()
        tables = tables.long()
        ent = pos // bs
        blk = torch.gather(tables, 1, ent.clamp(max=m - 1)[:, None])[:, 0]
        blk = self._rep(torch.where(ent < m, blk, 0))
        off = self._rep(pos % bs)
        b = token.shape[0]
        x = self._input(pv, token, pos.clamp(max=self.seq_len - 1))
        tr = self._rep(tables)
        pr = self._rep(pos)
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hn = self._ln_r(pv, x, p + "ln1")
            qkv = self._qkv(pv, hn, p, (b,))
            self._mark(cache)
            for which in (0, 1):
                self._write_units(
                    pools, scales,
                    {d: (i, which, blk[d], off[d]) for d in g.devs},
                    [t[1 + which] for t in qkv])
            attn = []
            for u, (q, _, _) in enumerate(qkv):
                d = g.units[u][0]
                attn.append(decode_attention(
                    q, self._ctx(pools, scales, u, i, 0, tr[d]),
                    self._ctx(pools, scales, u, i, 1, tr[d]), pr[d],
                    self._unit_heads(u)))
            x = self._attn_out(pv, x, attn, p)
            x = self._ffn_block(pv, x, p, moe_tape)
        return self._head_r(pv, x), self._unmark(cache)

    def decode_megastep(self, params, pool, token, pos, left, eos, tables,
                        steps, pick, moe_tape=None):
        """``steps`` generation steps of the `decode_paged` body, enqueued
        back to back with no host sync: per-row masks and picks stay on
        the device, so a row that finishes (EOS, its budget, the cache
        depth) retires mid-run and its remaining steps run at the dead
        position one past its table's coverage, which `decode_paged`
        redirects to the trash block.

        token, pos: (b,) int, each row's current token and its position;
        left: (b,) int, tokens the row may still emit (<= 0: inactive from
        the start, as padding rows); eos: (b,) int, the row's EOS id or
        -1; steps: the run length m; pick: ``pick(logits, newpos) -> (b,)
        int``, the engine's sampling tail, given the carried position + 1
        each step, so the run draws what m single steps would.

        Returns ``(toks (b, steps) int64, pool)``: ``toks[r, j]`` is the
        j-th token row r emitted, or -2 where the row had retired (or was
        never active) when step j ran.  An MoE model appends ONE entry to
        ``moe_tape``: the (E,) counts summed over the steps and layers,
        rows no longer active counted at the dead position, as the JAX
        scan's carry counts them."""
        want = bool(self.moe_experts) and moe_tape is not None
        cnt = None
        bs = self._pool_parts(pool)[0].shape[3]
        dead = tables.shape[1] * bs
        tok = token.long()
        p = pos.long()
        lf = left.long()
        eos = eos.long()
        act = lf > 0
        emits = []
        for _ in range(int(steps)):
            tape = [] if want else None
            logits, pool = self.decode_paged(params, pool, tok,
                                             torch.where(act, p, dead),
                                             tables, moe_tape=tape)
            if want:
                step_cnt = torch.stack(tape).sum(dim=0)
                cnt = step_cnt if cnt is None else cnt + step_cnt
            picked = pick(logits, p + 1).long()
            p2 = torch.where(act, p + 1, p)
            lf2 = torch.where(act, lf - 1, lf)
            tok = torch.where(act, picked, tok)
            # the host's stop rules on the state after the advance: the
            # finishing token is emitted, then the row is inactive
            fin = ((eos >= 0) & (picked == eos)) | (lf2 <= 0) | \
                (p2 >= self.seq_len)
            emits.append(torch.where(act, picked, -2))
            act = act & ~fin
            p, lf = p2, lf2
        if want:
            moe_tape.append(cnt)
        return torch.stack(emits, dim=1), pool

    def verify_paged(self, params, pool, tokens, pos, length, tables,
                     moe_tape=None):
        """Speculative decoding's verify: a whole draft run scored in one
        pass over the paged pool, updated in place.

        tokens: (b, c) int, column 0 each row's last emitted token and
        columns 1.. its draft, fed at pos .. pos+c-1; pos: (b,) int;
        length: (b,) int, real fed tokens per row (fewer at the cache end;
        1 on padding rows); tables: (b, m) int, whose blocks covering the
        fed span the row owns alone.  The span's K/V is written before
        attending, by (block, offset) per position; positions past the
        table's coverage go to the trash block.  Returns (logits (b, c,
        vocab) at every fed position, pool)."""
        cache = pool
        g = self.plan
        pv = self._views(params)
        pools, scales = self._unit_pools(cache)
        b, c = tokens.shape
        bs = pools[0].shape[3]
        m = tables.shape[1]
        pos = pos.long()
        tables = tables.long()
        positions = pos[:, None] + torch.arange(c, device=tables.device)
        ent = positions // bs                                  # (b, c)
        blk = torch.gather(tables, 1, ent.clamp(max=m - 1))
        blk = self._rep(torch.where(ent < m, blk, 0))
        off = self._rep(positions % bs)
        x = self._input(pv, tokens, positions.clamp(max=self.seq_len - 1))
        tr = self._rep(tables)
        pr = self._rep(pos)
        lr = self._rep(length)
        for i in range(self.num_layers):
            p = "layer%d_" % i
            hf = self._flat(self._ln_r(pv, x, p + "ln1"))
            qkv = self._qkv(pv, hf, p, (b, c))
            self._mark(cache)
            for which in (0, 1):
                self._write_units(
                    pools, scales,
                    {d: (i, which, blk[d], off[d]) for d in g.devs},
                    [t[1 + which] for t in qkv])
            attn = []
            for u, (q, _, _) in enumerate(qkv):
                d = g.units[u][0]
                a = verify_attention(
                    q, self._ctx(pools, scales, u, i, 0, tr[d]),
                    self._ctx(pools, scales, u, i, 1, tr[d]), pr[d], lr[d],
                    self._unit_heads(u))
                attn.append(a.reshape(b * c, -1))
            x = self._attn_out(pv, x, attn, p)
            x = self._ffn_block(pv, x, p, moe_tape)
        logits = self._head_r(pv, self._flat(x)).reshape(
            b, c, self.vocab_size)
        return logits, self._unmark(cache)
