"""Host-DRAM block tier under the paged K/V pool.

A port of `mxnet_tpu/serving/tiers.py`.  When the prefix cache's LRU
evicts a parked device block, the engine's spill hook copies the block's
K/V (every layer, K and V: one (num_layers, 2, block_size, embed) tensor,
or the (int8 rows, f32 scales) pair under KV quantization) into this
bounded host pool, and the radix node converts to host residency instead
of detaching: the prefix stays findable, only its bytes moved down a
tier, and the device block still goes back to the free list.  A later
lookup that lands on host-resident nodes becomes a restore: the engine
allocates fresh device blocks, packs the run into one staging buffer
(`pack_block_run`), copies it to the card under the current decode
iteration, and scatters it into the pool (`TransformerKVModel.write_block`)
at the next one.

The tier holds its blocks in one slab of ``capacity + 1`` slots shaped
like a block, allocated once when the tier is made (page-locked for a
card), so a spill allocates nothing: `put` copies the block into a free
slot (the spare one when the tier is full, before the LRU tail is
evicted), on a card non-blocking on the pool's stream, so the copy is
ordered before any later write to the freed device block, behind an
event that `get` waits on before the first read.  Capacity is
``MXNET_SERVE_HOST_BLOCKS`` blocks with the pool's own LRU: spilling
past it evicts the oldest host block, and the engine detaches the radix
node that pointed at it.  Handles are opaque increasing ints, in no id
space shared with device blocks (the node's ``tier`` tells them apart).
Scheduler thread only, like the allocator.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..base import MXNetError

__all__ = ["HostBlockTier", "pack_block_run"]


def pack_block_run(model, block_size, arrs, kb, pin=False):
    """Pack an ordered run of per-block host payloads into ONE zeroed
    `block_run_placeholder` of ``kb`` blocks (a tuple pair packs both
    leaves in step), so one copy carries the whole run and one scatter
    lands it; entries past ``len(arrs)`` stay zero (the caller points
    their destinations at the trash block)."""
    data = model.block_run_placeholder(kb, block_size, pin=pin)
    for j, a in enumerate(arrs):
        if isinstance(data, tuple):
            data[0][:, :, j] = a[0]
            data[1][:, :, j] = a[1]
        else:
            data[:, :, j] = a
    return data


class HostBlockTier:
    """Bounded LRU pool of spilled K/V blocks on host DRAM.

    ``like`` is one block's payload (a tensor, or the (int8 rows, f32
    scales) pair under KV quantization), the shape and dtype of
    every slot; ``pin`` page-locks the slab for non-blocking copies from
    a card.  `put` may evict the LRU tail to make room and returns the
    evicted handles so the owner can detach their radix nodes; this class
    never calls back into the cache."""

    def __init__(self, capacity, like, pin=False):
        if int(capacity) < 1:
            raise MXNetError(
                "HostBlockTier: capacity must be >= 1 host blocks, "
                "got %d" % capacity)
        self.capacity = int(capacity)
        self._pair = isinstance(like, tuple)
        self._slab = tuple(
            torch.empty((self.capacity + 1,) + tuple(a.shape),
                        dtype=a.dtype, pin_memory=pin)
            for a in (like if self._pair else (like,)))
        self._slot_bytes = sum(int(t[0].nbytes) for t in self._slab)
        self._free = list(range(self.capacity, -1, -1))
        self._data = OrderedDict()    # handle -> slot, LRU order
        self._ready = {}              # handle -> event its copy is behind
        self._next = 1

    @property
    def used(self):
        """Host blocks resident."""
        return len(self._data)

    @property
    def bytes(self):
        """Host DRAM the resident blocks take (the quantized footprint
        under KV quantization)."""
        return len(self._data) * self._slot_bytes

    def _view(self, slot):
        leaves = tuple(t[slot] for t in self._slab)
        return leaves if self._pair else leaves[0]

    def put(self, arr):
        """Copy one spilled block into the tier; returns ``(handle,
        evicted)``, the LRU handles pushed out to make room (the caller
        detaches their index entries).  The copy lands in a free slot
        before anything is evicted, so a copy that raises leaves the tier
        as it was.  From a card the copy is non-blocking, on the current
        stream, and `get` waits on the event behind it."""
        slot = self._free.pop()
        ready = None
        try:
            for dst, src in zip(self._slab, arr if self._pair else (arr,)):
                dst[slot].copy_(src, non_blocking=src.is_cuda)
                if src.is_cuda:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(src.device))
        except Exception:
            self._free.append(slot)
            raise
        evicted = []
        while len(self._data) >= self.capacity:
            h, old = self._data.popitem(last=False)
            self._ready.pop(h, None)
            self._free.append(old)
            evicted.append(h)
        handle = self._next
        self._next += 1
        self._data[handle] = slot
        if ready is not None:
            self._ready[handle] = ready
        return handle, evicted

    def get(self, handle):
        """The block's payload, a view of its slot (MRU-touched), or None
        when the tier no longer holds it (the caller recomputes).  Waits
        for the block's own copy to land, never for the device's queue.
        The view is the tier's: read it before the next `put`."""
        slot = self._data.get(handle)
        if slot is None:
            return None
        ev = self._ready.pop(handle, None)
        if ev is not None:
            ev.synchronize()
        self._data.move_to_end(handle)
        return self._view(slot)

    def touch(self, handle):
        """MRU-touch without reading (a lookup matched this block)."""
        if handle in self._data:
            self._data.move_to_end(handle)

    def free(self, handle):
        """Drop one block; a handle already gone is a no-op."""
        slot = self._data.pop(handle, None)
        self._ready.pop(handle, None)
        if slot is not None:
            self._free.append(slot)

    def clear(self):
        """Forget everything (the pool-rebuild path: the index the
        handles hung from was cleared with the pool)."""
        self._free.extend(self._data.values())
        self._data.clear()
        self._ready.clear()
