"""Operator resources (reference `src/resource.cc`,
`include/mxnet/resource.h`).

A port of `mxnet_tpu/resource.py`.  The reference's ResourceManager
handed operators two things:

- `kRandom`: a per-device PRNG (`resource.cc:48-120`).  Here
  `Request(ctx, kRandom)` returns a `RandomResource` whose keys are the
  next keys of the global stream of `random` (threefry, bit for bit the
  JAX package's keys), so ops stay reproducible under `mx.random.seed`.
- `kTempSpace`: grow-only scratch buffers (`resource.cc:121-224`).
  PyTorch allocates operator workspace itself; for host-side scratch a
  grow-only host buffer keeps the `get_space` reuse contract.
"""
from __future__ import annotations

import numpy as np

from . import random as _random
from .base import MXNetError
from .context import Context

__all__ = ["ResourceRequest", "RandomResource", "TempSpaceResource",
           "ResourceManager"]


class ResourceRequest:
    kRandom = "random"
    kTempSpace = "temp_space"

    def __init__(self, type_):
        if type_ not in (self.kRandom, self.kTempSpace):
            raise MXNetError("unknown resource type %r" % type_)
        self.type = type_


class RandomResource:
    """`Resource` with req.type == kRandom: yields `random` keys."""

    def __init__(self, ctx):
        self.ctx = ctx

    def get_key(self):
        return _random.next_key()

    def seed(self, seed):
        _random.seed(seed)


class TempSpaceResource:
    """`Resource` with req.type == kTempSpace: `get_space(shape, dtype)`
    returns a zeroed scratch view of a grow-only host buffer; a smaller
    request reuses the grown allocation, a larger one reallocates
    (`resource.cc:204-224`)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self._buf = None  # grow-only byte buffer

    def get_space(self, shape, dtype=np.float32):
        dtype = np.dtype(dtype)
        n = int(np.prod(shape))
        nbytes = n * dtype.itemsize
        if self._buf is None or self._buf.nbytes < nbytes:
            self._buf = np.empty(nbytes, np.uint8)
        view = self._buf[:nbytes].view(dtype)[:n].reshape(shape)
        view[...] = 0  # scratch semantics: zeroed
        return view

    def release(self):
        self._buf = None


class ResourceManager:
    """`ResourceManager::Get()->Request(ctx, req)`."""

    _instance = None

    @classmethod
    def get(cls):
        if cls._instance is None:
            cls._instance = ResourceManager()
        return cls._instance

    def request(self, ctx, req):
        if not isinstance(req, ResourceRequest):
            req = ResourceRequest(req)
        ctx = Context(ctx) if not isinstance(ctx, Context) else ctx
        if req.type == ResourceRequest.kRandom:
            return RandomResource(ctx)
        return TempSpaceResource(ctx)
