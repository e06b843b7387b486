"""KVStore: key-value parameter synchronization, in one process.

A port of `mxnet_tpu/kvstore.py` (the reference's `kvstore_local.h`,
`kvstore_device.h`, `python/mxnet/kvstore.py`) for the types ``local``
(and its ``local_update_cpu``/``local_allreduce_cpu`` names) and
``device`` (``local_allreduce_device``).  The contract is the
reference's: int or str keys; `init`, `push` (the sum of the devices'
values, left to right on the first value's device) and `pull`; with an
updater, a push updates the stored weight and a pull serves it, without
one a push fills the merge buffer and a pull serves that; `rank`,
`num_workers`, `barrier`; `set_optimizer` installs
`optimizer.get_fused_updater`, which applies a pushed list of keys as one
`update_multi`.  A pull copies (the JAX package shares the buffer).
Pushes and pulls count ``kvstore.push_calls``/``push_bytes`` and
``kvstore.pull_calls``/``pull_bytes`` in `telemetry`.

The ``dist_*`` types (the parameter server of `parallel/dist.py`) raise:
they come with ROADMAP.md queue 1, item 3.
"""
from __future__ import annotations

import os
import pickle

from . import telemetry
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]


def _reduce(values):
    """Sum NDArrays onto the first one's device, left to right."""
    acc = values[0].data
    for v in values[1:]:
        acc = acc + v.data.to(acc.device)
    return NDArray(acc if len(values) > 1 else acc.clone(),
                   values[0].context)


class KVStore:
    """Single-process store of type local or device."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._merge_buf = {}
        self._updater = None

    @staticmethod
    def _keylist(key):
        if isinstance(key, (int, str)):
            return [key]
        return list(key)

    @staticmethod
    def _vallist(value, nkeys):
        """Per key, the list of its devices' values
        (`kvstore_local.h:180-236`)."""
        if isinstance(value, NDArray):
            value = [value]
        if nkeys == 1 and value and isinstance(value[0], NDArray):
            return [list(value)]
        return [[v] if isinstance(v, NDArray) else list(v) for v in value]

    def init(self, key, value):
        keys = self._keylist(key)
        for k, vlist in zip(keys, self._vallist(value, len(keys))):
            if k in self._store:
                raise MXNetError("key %r already initialized" % k)
            self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Push values; a list of keys is one bucket, which a list-capable
        updater applies in one `update_multi`."""
        keys = self._keylist(key)
        vals = self._vallist(value, len(keys))
        telemetry.inc("kvstore.push_calls")
        telemetry.inc("kvstore.push_bytes", sum(
            v.data.nbytes for vlist in vals for v in vlist))
        merged = [_reduce(v) for v in vals]
        if self._updater is None:
            for k, m in zip(keys, merged):
                self._merge_buf[k] = m
            return
        for k in keys:
            if k not in self._store:
                raise MXNetError("key %r not initialized" % k)
        if len(keys) > 1 and getattr(self._updater, "supports_multi", False):
            self._updater(keys, merged, [self._store[k] for k in keys])
        else:
            for k, m in zip(keys, merged):
                self._updater(k, m, self._store[k])

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull requires out=")
        keys = self._keylist(key)
        if isinstance(out, NDArray):
            outs = [[out]]
        elif out and isinstance(out[0], NDArray) and len(keys) == 1:
            outs = [list(out)]
        else:
            outs = [[o] if isinstance(o, NDArray) else list(o) for o in out]
        for k, olist in zip(keys, outs):
            if self._updater is None and k in self._merge_buf:
                src = self._merge_buf[k]
            elif k in self._store:
                src = self._store[k]
            else:
                raise MXNetError("key %r not initialized" % k)
            telemetry.inc("kvstore.pull_bytes", src.data.nbytes * len(olist))
            for o in olist:
                src.copyto(o)
        telemetry.inc("kvstore.pull_calls")

    def _set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Install ``optimizer`` as the updater (a list-capable
        `get_fused_updater` closure).  The optimizer must pickle, as the
        reference ships it to its servers."""
        from .optimizer import get_fused_updater

        pickle.loads(pickle.dumps(optimizer))
        self._set_updater(get_fused_updater(optimizer))

    @property
    def rank(self):
        return int(os.environ.get("DMLC_RANK", "0"))

    @property
    def num_workers(self):
        return int(os.environ.get("DMLC_NUM_WORKER", "1"))

    def barrier(self):
        pass


_LOCAL = {"local", "local_update_cpu", "local_allreduce_cpu", "device",
          "local_allreduce_device"}


def create(name="local"):
    """A KVStore of type ``name`` (`src/kvstore/kvstore.cc:17-49`)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in ("dist_sync", "dist_async", "dist"):
        raise MXNetError(
            "KVStore %r (the distributed parameter server) is not ported "
            "yet (ROADMAP.md queue 1, item 3)" % name)
    if name not in _LOCAL:
        raise MXNetError("unknown KVStore type %r" % name)
    return KVStore(name)
