"""Sub-mesh serving replicas: the parameter and buffer layouts of a
k-shard plan.

The port of the JAX package's sub-mesh replica (`ServingEngine(ctx=
Mesh)`), which GSPMD partitions from `TransformerKVModel.param_shardings`
and `kv_shardings`.  Here the partition is explicit and single-controller:
one engine, one host thread, k shards on the devices of one mesh axis (a
device may repeat: 2 shards on one card are ``[cuda:0, cuda:0]``).

The programs are `decode.TransformerKVModel`'s, written once over its
`ShardPlan`; `ShardedKVModel` gives them a k-shard plan and the layouts
it needs (`ShardedParams`, `ShardedCache`).  The plan splits by the
JAX package's rules:

* q/k/v are split by whole heads and attn_out by the matching rows, when
  ``num_heads % k == 0``; else attention, attn_out and the K/V cache are
  replicated (GSPMD would split the embed axis inside a head; an explicit
  port would then need a reduction of partial scores);
* ffn1 is split by columns and ffn2 by rows, their bias added after the
  reduction; MoE expert banks split on the expert axis, the router
  replicated;
* the embedding and the pred head are split by vocabulary: the lookup is
  masked per shard and reduced, the head's logits concatenated, so the
  sampler sees the whole row;
* LayerNorm, the positional table and the residual stream are replicated:
  they run once per distinct device of the group, not once per shard
  (the final LayerNorm only on shard 0's device, unless the head splits);
* any group the shard count does not divide stays replicated.

Row-parallel partial sums go through one reduction (`TransformerKVModel.
_reduce`): shard
order, on the shards' device when they share one, else gathered to shard
0's device, summed in the same order and copied back, so the bits never
depend on placement.  Under KV quant a row's scale is the amax over the
whole embed row: each shard's write quantizes its slice by the max of
every shard's row amax, so the int8 rows equal the unsharded codec's.

Block tables, the allocator, the prefix cache and all scheduling stay
replica-global: a block is k slices on the embed axis (`ShardedCache`),
and a spilled block or a packed run holds the unsharded layout
(`slice_block`, `gather_blocks`, `write_block`), so the host tier and the
handoff move the unsharded engine's bytes.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .decode import ShardPlan, TransformerKVModel

__all__ = ["ShardPlan", "ShardedParams", "ShardedCache", "ShardedKVModel"]


class ShardedParams:
    """A sub-mesh replica's parameters: one ``{name: tensor}`` dict per
    shard, on its device.  A split weight holds the shard's slice; a
    replicated one is a single copy per distinct device, which every shard
    there shares.  ``axes`` is `param_shardings`' descriptor per name."""

    def __init__(self, shards, plan, axes):
        self.shards = shards
        self.plan = plan
        self.axes = axes

    def rep(self, dev):
        """The dict whose replicated entries serve ``dev``."""
        return self.shards[self.plan.first[dev]]

    def tensors(self):
        """Every distinct tensor held, with its shard position."""
        for s, sh in enumerate(self.shards):
            for name, t in sh.items():
                yield s, name, t


class ShardedCache:
    """A sub-mesh replica's K/V buffers: ``units`` holds one slot cache
    (L, 2, n_slots, S_max, e_u) or paged pool (L, 2, n_blocks, bs, e_u)
    per attention unit of the plan, ``scales`` (under KV quant) one
    (L, 2, n_blocks, bs) f32 copy per distinct device.  The write mark
    rides on this object."""

    def __init__(self, units, scales=None):
        self.units = units
        self.scales = scales
        self._mxt_writing = False

    def leaves(self):
        return list(self.units) + (list(self.scales.values())
                                   if self.scales is not None else [])


def _new_like(t, dev):
    """A fresh contiguous copy of ``t`` on ``dev``: a shard's slice owns
    its memory, never a view into the unsharded tensor."""
    return torch.empty(tuple(t.shape), dtype=t.dtype,
                       device=dev).copy_(t)


def _storage_bytes(tensors):
    """Bytes of the distinct storages among ``tensors``."""
    seen, n = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        key = (str(t.device), st.data_ptr())
        if key in seen:
            continue
        seen.add(key)
        n += st.nbytes()
    return n


class ShardedKVModel(TransformerKVModel):
    """A `TransformerKVModel` whose plan partitions its programs over the
    devices of one mesh axis (see the module docstring).  Every program
    takes `ShardedParams` and a `ShardedCache` in place of the dict and
    the tensor, and returns what the unsharded program returns: logits
    whole and on shard 0's device (a slot prefill's K/V a list, one per
    attention unit)."""

    def __init__(self, model, mesh, axis="model"):
        if isinstance(model, ShardedKVModel):
            raise MXNetError("ShardedKVModel: model is already sharded")
        self.__dict__.update(model.__dict__)
        self.mesh = mesh
        self.axis = axis
        self.plan = ShardPlan(model, mesh.axis_devices(axis))

    # -- parameters --------------------------------------------------------
    def shard_params(self, params, mesh=None, axis=None):
        """`TransformerKVModel.shard_params` over this model's mesh; a
        `ShardedParams` of the same plan passes through (a respawn moves
        no bytes)."""
        if isinstance(params, ShardedParams):
            if params.plan.signature() != self.plan.signature():
                raise MXNetError("ShardedKVModel: parameters sharded for "
                                 "another group")
            return params
        return super().shard_params(params, self.mesh, self.axis)

    def footprint(self, params, cache):
        """`ServingEngine.memory_footprint`'s numbers: ``total_bytes``
        (params and K/V in the unsharded layout, each counted once),
        ``per_device_bytes`` (the largest shard position's share: its
        slices plus every replicated tensor in full, as each device of a
        JAX mesh holds them), ``devices`` (shard positions), and
        ``physical_device_bytes`` (the distinct storages on each distinct
        device)."""
        g = self.plan
        per = [0] * g.k
        total = 0
        for s, name, t in params.tensors():
            nb = t.numel() * t.element_size()
            per[s] += nb
            # a split tensor's slices sum to it; a replicated one counts
            # once, at shard 0
            if params.axes.get(name) is not None or s == 0:
                total += nb
        leaves = cache.units
        for u, (d, lo, hi, src) in enumerate(g.units):
            nb = leaves[u].numel() * leaves[u].element_size()
            if g.groups["heads"]:
                per[src] += nb
                total += nb
            else:
                for s, ds in enumerate(g.devices):
                    if ds == d:
                        per[s] += nb
                if d == g.home:
                    total += nb
        if cache.scales is not None:
            for s, d in enumerate(g.devices):
                t = cache.scales[d]
                per[s] += t.numel() * t.element_size()
            t = cache.scales[g.home]
            total += t.numel() * t.element_size()
        physical = {}
        for d in g.devs:
            ts = [t for _, _, t in params.tensors() if t.device == d]
            ts += [t for t in cache.leaves() if t.device == d]
            physical[str(d)] = _storage_bytes(ts)
        return {"total_bytes": int(total), "per_device_bytes": int(max(per)),
                "devices": g.k, "per_shard_bytes": [int(n) for n in per],
                "physical_device_bytes": physical}

    # -- buffers -------------------------------------------------------------
    def _unit_width(self, u):
        _, lo, hi, _ = self.plan.units[u]
        return hi - lo

    def init_cache(self, n_slots, device=None):
        """Zeroed slot caches, one (L, 2, n_slots, S_max, e_u) per unit
        (``device`` is the plan's)."""
        return ShardedCache([
            torch.zeros((self.num_layers, 2, int(n_slots), self.seq_len,
                         self._unit_width(u)), dtype=self.dtype, device=d)
            for u, (d, _, _, _) in enumerate(self.plan.units)])

    def init_block_pool(self, n_blocks, block_size, device=None):
        """Zeroed paged pools, one (L, 2, n_blocks, bs, e_u) per unit, and
        under KV quant the per-row scales once per distinct device."""
        lead = (self.num_layers, 2, int(n_blocks), int(block_size))
        dt = self.dtype if self.kv_quant is None else self.kv_quant.dtype
        units = [torch.zeros(lead + (self._unit_width(u),), dtype=dt,
                             device=d)
                 for u, (d, _, _, _) in enumerate(self.plan.units)]
        scales = None
        if self.kv_quant is not None:
            scales = {d: torch.zeros(lead, dtype=torch.float32, device=d)
                      for d in self.plan.devs}
        return ShardedCache(units, scales)

    def cache_leaves(self, cache):
        return cache.leaves()

    def poison_scales(self, cache, block):
        for t in cache.scales.values():
            t[:, :, block] = float("nan")

    def _pool_parts(self, cache):
        return cache.units[0], cache.scales

    def _gather_run(self, cache, idx):
        """The unsharded (L, 2, [n,] bs, E) rows of block(s) ``idx`` (an
        int or an int tensor on shard 0's device) on shard 0's device, and
        the scales under KV quant."""
        g = self.plan
        home = g.home
        if g.groups["heads"]:
            parts = []
            for u in cache.units:
                i = idx.to(u.device) if torch.is_tensor(idx) else idx
                parts.append(u[:, :, i].to(home))
            rows = torch.cat(parts, dim=-1)
        else:
            rows = cache.units[0][:, :, idx]
        if cache.scales is None:
            return rows
        return rows, cache.scales[home][:, :, idx]

    def slice_block(self, cache, block):
        """One block's rows in the unsharded layout: the spill payload."""
        return self._gather_run(cache, block)

    def gather_blocks(self, cache, idx):
        return self._gather_run(cache, idx)

    def write_block(self, cache, dst, data):
        """Scatter an unsharded staged run into every unit's slice of
        blocks ``dst``, scales into every device's copy."""
        g = self.plan
        dst = self._rep(dst.long())
        rows, sc = (data if isinstance(data, tuple) else (data, None))
        self._mark(cache)
        for u, (d, lo, hi, _) in enumerate(g.units):
            pool = cache.units[u]
            pool[:, :, dst[d]] = rows[..., lo:hi].to(device=d,
                                                     dtype=pool.dtype)
        if cache.scales is not None:
            for d, t in cache.scales.items():
                t[:, :, dst[d]] = sc.to(device=d, dtype=torch.float32)
        return self._unmark(cache)

    def copy_block(self, pool, src, dst):
        cache = pool
        home = self.plan.home
        src = self._rep(torch.as_tensor(src, device=home).long().reshape(-1))
        dst = self._rep(torch.as_tensor(dst, device=home).long().reshape(-1))
        self._mark(cache)
        for u, (d, _, _, _) in enumerate(self.plan.units):
            p = cache.units[u]
            p[:, :, dst[d]] = p[:, :, src[d]]
        if cache.scales is not None:
            for d, t in cache.scales.items():
                t[:, :, dst[d]] = t[:, :, src[d]]
        return self._unmark(cache)

    def write_prefill(self, cache, kv, length, slots):
        sl = self._rep(slots.long())
        self._mark(cache)
        for u, (d, _, _, _) in enumerate(self.plan.units):
            c = cache.units[u]
            c[:, :, sl[d], :kv[u].shape[3]] = kv[u].to(c.dtype)
        return self._unmark(cache)

    # -- the layouts the programs run over ------------------------------------
    def _views(self, params):
        return ({d: params.rep(d) for d in self.plan.devs}, params.shards)

    def _unit_pools(self, cache):
        return cache.units, cache.scales

    def _pack_kv(self, kv):
        return kv
