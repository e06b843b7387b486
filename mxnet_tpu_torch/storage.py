"""Device memory manager (reference `src/storage/`,
`include/mxnet/storage.h`).

A port of `mxnet_tpu/storage.py`.  Tensors are allocated by PyTorch's
caching allocator, so ordinary arrays never touch this module.  What it
keeps is the reference's imperative buffer pool (`PooledStorageManager`,
`pooled_storage_manager.h:21-83`): explicit `alloc`/`free` of scratch
device buffers, an exact-size free list per device, and a dump-all cap
(``MXNET_STORAGE_POOL_CAP_BYTES``, default 4 GiB, the reference's
hard-coded cap at `storage.cc:28`), plus the device's memory counters.

`Storage.get().alloc(size, ctx) -> Handle{size, ctx, data}` (``data`` a
uint8 tensor of ``max(size, 1)`` bytes; ``ctx`` None is the current
context, the card unless a ``with mx.cpu():`` scope says otherwise),
`free(handle)` (back to the pool: the next `alloc` of that size on that
device hands the same buffer back), `release_all()`, `pool_stats()`, and
`device_memory_stats(ctx)`: ``torch.cuda.memory_stats`` of a card as the
JAX package's names (``bytes_in_use``, ``peak_bytes_in_use``,
``bytes_limit``, and ``bytes_reserved``, ``num_allocs``), ``{}`` for the
CPU, as the JAX CPU device gives.  The ``storage`` collector (the pool
and a card's counters) is in every `telemetry` step report.
"""
from __future__ import annotations

import os
import threading

import torch

from . import telemetry
from .base import MXNetError
from .context import Context, current_context

__all__ = ["Handle", "Storage", "device_memory_stats"]


def _ctx(ctx):
    if ctx is None:
        return current_context()
    return ctx if isinstance(ctx, Context) else Context(ctx)


class Handle:
    """`Storage::Handle` (`storage.h:22-40`): a sized device buffer."""

    __slots__ = ("data", "size", "ctx", "_freed")

    def __init__(self, data, size, ctx):
        self.data = data
        self.size = size
        self.ctx = ctx
        self._freed = False

    def asnumpy(self):
        return self.data.cpu().numpy()


class Storage:
    """Singleton pooled allocator (`storage.cc:99-105` Storage::Get).

    free() caches the buffer on an exact-size free list keyed by (ctx,
    size); alloc() of the same size reuses it without allocating; when
    the cached bytes of a device exceed the cap, everything cached there
    is dropped (`pooled_storage_manager.h:44-50`)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._pools = {}  # (ctx_str, size) -> [buffers]
        self._cached_bytes = {}  # ctx_str -> int
        self._live = {}  # ctx_str -> int, currently alloc'd via this manager
        self._mu = threading.Lock()
        self.cap_bytes = int(os.environ.get(
            "MXNET_STORAGE_POOL_CAP_BYTES", str(4 << 30)))

    @classmethod
    def get(cls):
        with cls._lock:
            if cls._instance is None:
                cls._instance = Storage()
            return cls._instance

    def alloc(self, size, ctx=None):
        if size < 0:
            raise MXNetError("Storage.alloc: negative size %d" % size)
        ctx = _ctx(ctx)
        key = (str(ctx), int(size))
        with self._mu:
            pool = self._pools.get(key)
            if pool:
                buf = pool.pop()
                self._cached_bytes[key[0]] -= size
                self._live[key[0]] = self._live.get(key[0], 0) + size
                return Handle(buf, size, ctx)
        buf = torch.zeros(max(size, 1), dtype=torch.uint8,
                          device=ctx.torch_device())
        with self._mu:
            self._live[key[0]] = self._live.get(key[0], 0) + size
        return Handle(buf, size, ctx)

    def free(self, handle):
        if handle._freed:
            raise MXNetError("Storage.free: double free")
        handle._freed = True
        key = (str(handle.ctx), int(handle.size))
        with self._mu:
            self._live[key[0]] = self._live.get(key[0], 0) - handle.size
            cached = self._cached_bytes.get(key[0], 0) + handle.size
            if cached > self.cap_bytes:
                for k in [k for k in self._pools if k[0] == key[0]]:
                    del self._pools[k]
                self._cached_bytes[key[0]] = 0
                return
            self._pools.setdefault(key, []).append(handle.data)
            self._cached_bytes[key[0]] = cached

    def release_all(self, ctx=None):
        """`DirectFreeAll`: drop every cached buffer (for ctx, or all)."""
        with self._mu:
            if ctx is None:
                self._pools.clear()
                self._cached_bytes.clear()
            else:
                cs = str(_ctx(ctx))
                for k in [k for k in self._pools if k[0] == cs]:
                    del self._pools[k]
                self._cached_bytes[cs] = 0

    def pool_stats(self):
        """{ctx: {"cached_bytes": n, "live_bytes": n, "cached_buffers": n}}"""
        with self._mu:
            out = {}
            for (cs, size), bufs in self._pools.items():
                d = out.setdefault(cs, {"cached_bytes": 0, "live_bytes": 0,
                                        "cached_buffers": 0})
                d["cached_bytes"] += size * len(bufs)
                d["cached_buffers"] += len(bufs)
            for cs, live in self._live.items():
                d = out.setdefault(cs, {"cached_bytes": 0, "live_bytes": 0,
                                        "cached_buffers": 0})
                d["live_bytes"] = live
            return out


def device_memory_stats(ctx=None):
    """A card's live memory counters from PyTorch's allocator, under the
    JAX package's names; {} for the CPU."""
    dev = _ctx(ctx).torch_device()
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            dev).total_memory),
        "num_allocs": int(stats.get("allocation.all.allocated", 0)),
    }


def _telemetry_collector():
    """The storage part of each telemetry step report: the pool's stats
    and the current device's memory counters where it has them."""
    out = {"pool": Storage.get().pool_stats()}
    try:
        mem = device_memory_stats()
        if mem:
            out["hbm"] = {k: mem[k] for k in
                          ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}
    except MXNetError:  # no card, and the current context is one
        pass
    return out


telemetry.register_collector("storage", _telemetry_collector, default=True)
