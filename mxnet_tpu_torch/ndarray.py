"""Imperative NDArray of the port.

A port of `mxnet_tpu/ndarray.py` (the reference's `include/mxnet/
ndarray.h`, `python/mxnet/ndarray.py`): an `NDArray` holds a
`torch.Tensor` on its context's device, and keeps the `Context` itself
(several CPU contexts share the one CPU device).

* Mutation is in place.  ``slice``, ``reshape`` and ``__getitem__``
  return torch views, so a write to the view writes through to the array
  it came from, as the reference's zero-copy ``Slice``/``Reshape`` do
  (the JAX package models the same with ``(parent, index)``; its
  ``reshape`` is a copy, the port's a view).
* Ops go onto the tensor's CUDA stream in issue order, which gives the
  reference's read-after-write order on the device.  Host ops pushed to
  the dependency engine (`engine.py`) that will write an array mark it
  with their var (``_hvar``, a ``(var, token)`` pair on the array a view
  was cut from), and every read or write of the array or its views waits
  for that op first (``_sync_host``), as the JAX package's arrays do.
  ``wait_to_read``, ``wait_to_write`` and `waitall` synchronize the
  device (`waitall` drains the engine first); ``asnumpy`` is a
  synchronizing copy.
* `save`/`load` write the JAX package's bytes: list magic 0x112 and a
  reserved word, the arrays (magic 0xF7B7, ndim, shape, device type and
  id, dtype flag, byte count, data), then the names, every field
  little-endian.  A file written by either package loads in the other,
  and on the CPU both write the same bytes.  Loading puts each array on
  its saved context, or on the CPU where that card is not present, as
  the reference does.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from . import engine
from .base import (MXNetError, check_shape, dtype_flag, flag_dtype, np_dtype,
                   numeric_types, torch_dtype)
from .context import Context, cpu, current_context

__all__ = ["NDArray", "empty", "zeros", "ones", "full", "array", "arange",
           "concatenate", "onehot_encode", "waitall", "save", "load"]


def _tensor(value, device, dtype=None):
    """``value`` (NDArray, tensor, numpy array or scalar) as a tensor on
    ``device``."""
    if isinstance(value, NDArray):
        value = value._data
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    return value.to(device=device, dtype=dtype)


class NDArray:
    """A multi-dimensional array on one context's device."""

    __slots__ = ("_buf", "_ctx", "_hvar", "_base", "__weakref__")

    def __init__(self, data, ctx=None, _base=None):
        ctx = Context(ctx) if ctx is not None else None
        if isinstance(data, NDArray):
            ctx = ctx or data._ctx
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if ctx is None:
            ctx = cpu() if data.device.type == "cpu" else \
                Context("gpu", data.device.index or 0)
        dev = ctx.torch_device()
        if data.device != dev:
            data = data.to(dev)
        self._buf = data
        self._ctx = ctx
        # pending-host-write mark: ``(engine var, generation token)`` while
        # an async host op has a write into this array pending; the fresh
        # token per mark lets a reader clear exactly the mark it waited on
        self._hvar = None
        self._base = _base  # the array a view was cut from (holds the mark)
        engine.track_array(self)

    def _sync_host(self):
        """Wait for a pending host-engine write into this array (or the
        array it is a view of).  A read from inside the op that holds the
        var must not wait on itself; the clear compares the whole mark, so
        finishing an older wait never erases a newer op's mark."""
        root = self if self._base is None else self._base
        mark = root._hvar
        if mark is not None:
            var = mark[0]
            if engine.current_op_holds(var):
                return
            engine.get().wait_for_var(var)
            if root._hvar is mark:
                root._hvar = None

    @property
    def _data(self) -> torch.Tensor:
        root = self if self._base is None else self._base
        if root._hvar is not None:
            self._sync_host()
        return self._buf

    @_data.setter
    def _data(self, value):
        root = self if self._base is None else self._base
        if root._hvar is not None:
            self._sync_host()
        self._buf = value

    @property
    def data(self) -> torch.Tensor:
        """The underlying tensor (views write through)."""
        return self._data

    # -- properties -------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def dtype(self):
        """A numpy dtype (bfloat16 stays a torch dtype: numpy has none)."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return np_dtype(self._data.dtype)

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def T(self):
        return NDArray(self._data.t().contiguous(), self._ctx)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self._ctx)

    # -- sync points ------------------------------------------------------
    def wait_to_read(self):
        """Block until every queued write to this array is done
        (`ndarray.h:94-97`)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    def wait_to_write(self):
        """Block until every queued read and write is done
        (`ndarray.h:103-110`); one stream orders both, so this is the same
        barrier as `wait_to_read`."""
        self.wait_to_read()

    def asnumpy(self) -> np.ndarray:
        """A numpy copy; synchronizes like the reference's."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("asscalar() requires size-1 array")
        return self.asnumpy().reshape(()).item()

    # -- conversion / copy ------------------------------------------------
    def astype(self, dtype):
        return NDArray(self._data.to(torch_dtype(dtype), copy=True),
                       self._ctx)

    def copy(self):
        return NDArray(self._data.clone(), self._ctx)

    def copyto(self, other):
        """Copy into another NDArray (across devices and dtypes) or onto
        a Context (`ndarray.cc` `CopyFromTo`)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True),
                           other)
        raise MXNetError("copyto: expects NDArray or Context")

    def as_in_context(self, ctx):
        ctx = Context(ctx)
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    # -- views ------------------------------------------------------------
    def _root(self):
        return self if self._base is None else self._base

    def slice(self, start, stop):
        """A view of rows [start, stop) of axis 0 (`ndarray.h:227-239`);
        writes to it write through to this array."""
        return NDArray(self._data[int(start):int(stop)], self._ctx,
                       _base=self._root())

    def reshape(self, shape):
        """A view of the same elements in another shape
        (`ndarray.h:241-250`); writes write through.  Raises where the
        elements cannot be viewed so."""
        shape = check_shape(shape)
        try:
            return NDArray(self._data.view(shape), self._ctx,
                           _base=self._root())
        except RuntimeError as e:
            raise MXNetError("reshape %s -> %s: %s" % (self.shape, shape, e))

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return NDArray(self._data[int(idx)], self._ctx,
                           _base=self._root())
        if isinstance(idx, slice):
            if idx.step not in (None, 1):
                raise MXNetError("slice step not supported")
            start = idx.start or 0
            stop = idx.stop if idx.stop is not None else self.shape[0]
            return self.slice(start, stop)
        raise MXNetError("unsupported index %r" % (idx,))

    def __setitem__(self, idx, value):
        if isinstance(idx, slice) and idx == slice(None):
            target = self
        elif isinstance(idx, (int, np.integer, slice)):
            target = self[idx]
        else:
            raise MXNetError("unsupported index %r" % (idx,))
        if isinstance(value, numeric_types):
            target._data.fill_(value)
            return
        v = _tensor(value, self._data.device)
        if tuple(v.shape) != target.shape:
            raise MXNetError("shape mismatch in assignment: %s vs %s"
                             % (tuple(v.shape), target.shape))
        target._data.copy_(v)

    # -- arithmetic -------------------------------------------------------
    def _operand(self, other):
        if isinstance(other, numeric_types):
            return other
        return _tensor(other, self._data.device)

    def _binary(self, other, fn, reverse=False):
        o = self._operand(other)
        a, b = (o, self._data) if reverse else (self._data, o)
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(a, device=self._data.device)
        return NDArray(fn(a, b), self._ctx)

    def __add__(self, other):
        return self._binary(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __rsub__(self, other):
        return self._binary(other, torch.sub, reverse=True)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, torch.true_divide)

    def __rtruediv__(self, other):
        return self._binary(other, torch.true_divide, reverse=True)

    def __pow__(self, other):
        return self._binary(other, torch.pow)

    def __neg__(self):
        return NDArray(torch.neg(self._data), self._ctx)

    def _inplace(self, other, fn):
        self._data.copy_(fn(self._data, self._operand(other)))
        return self

    def __iadd__(self, other):
        return self._inplace(other, torch.add)

    def __isub__(self, other):
        return self._inplace(other, torch.sub)

    def __imul__(self, other):
        return self._inplace(other, torch.mul)

    def __itruediv__(self, other):
        return self._inplace(other, torch.true_divide)

    def __eq__(self, other):  # elementwise, like numpy/mxnet
        if isinstance(other, (NDArray,) + numeric_types):
            dtype = self._data.dtype
            return self._binary(other, lambda a, b: torch.eq(a, b).to(dtype))
        return NotImplemented

    def __hash__(self):
        return id(self)


# -- creation ------------------------------------------------------------


def _ctx(ctx):
    return Context(ctx) if ctx is not None else current_context()


def empty(shape, ctx=None, dtype=np.float32):
    """An array of ``shape`` (zero-filled, as the JAX package's)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=np.float32):
    ctx = _ctx(ctx)
    return NDArray(torch.zeros(check_shape(shape), dtype=torch_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def ones(shape, ctx=None, dtype=np.float32):
    ctx = _ctx(ctx)
    return NDArray(torch.ones(check_shape(shape), dtype=torch_dtype(dtype),
                              device=ctx.torch_device()), ctx)


def full(shape, val, ctx=None, dtype=np.float32):
    ctx = _ctx(ctx)
    return NDArray(torch.full(check_shape(shape), val,
                              dtype=torch_dtype(dtype),
                              device=ctx.torch_device()), ctx)


def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like (`python/mxnet/ndarray.py` array):
    float32 unless the source is a numpy array of another type (float64
    narrows to float32, as in the JAX package)."""
    ctx = _ctx(ctx)
    if isinstance(source_array, NDArray):
        t = source_array._data
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return NDArray(t.to(ctx.torch_device(), copy=True), ctx)
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach()
        t = t.to(torch_dtype(dtype)) if dtype is not None else t
        return NDArray(t.to(ctx.torch_device(), copy=True), ctx)
    arr = np.asarray(source_array,
                     dtype=None if dtype is None else np_dtype(dtype))
    if dtype is None:
        if not isinstance(source_array, np.ndarray) or \
                arr.dtype == np.float64:
            arr = arr.astype(np.float32)
    return NDArray(torch.tensor(arr, device=ctx.torch_device()), ctx)


def arange(start, stop=None, step=1.0, ctx=None, dtype=np.float32):
    ctx = _ctx(ctx)
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                                device=ctx.torch_device()), ctx)


def concatenate(arrays, axis=0):
    return NDArray(torch.cat([a._data for a in arrays], dim=axis),
                   arrays[0].context)


def onehot_encode(indices, out):
    """out[i, indices[i]] = 1, every other element 0 (reference
    `onehot_encode`, `ndarray.cc`)."""
    depth = out.shape[1]
    idx = indices._data.to(out._data.device).long()
    hot = torch.nn.functional.one_hot(idx.clamp(0, depth - 1), depth)
    hot = hot * ((idx >= 0) & (idx < depth)).unsqueeze(1)
    out._data.copy_(hot)
    return out


def waitall():
    """Drain the host engine, then block until all queued device work is
    done (`MXNDArrayWaitAll`)."""
    engine.wait_for_all()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- serialization -------------------------------------------------------

_LIST_MAGIC = 0x112
_ARRAY_MAGIC = 0xF7B7


def _save_array(f, nd: NDArray):
    t = nd._data.detach().contiguous().cpu()
    flag = dtype_flag(t.dtype)
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        raw = np.ascontiguousarray(t.numpy()).tobytes()
    ctx = nd.context
    f.write(struct.pack("<IIQ", _ARRAY_MAGIC, t.dim(), 0))
    for d in t.shape:
        f.write(struct.pack("<q", d))
    f.write(struct.pack("<II", ctx.device_typeid, ctx.device_id))
    f.write(struct.pack("<I", flag))
    f.write(struct.pack("<Q", len(raw)))
    f.write(raw)


def _load_array(f) -> NDArray:
    magic, ndim, _ = struct.unpack("<IIQ", f.read(16))
    if magic != _ARRAY_MAGIC:
        raise MXNetError("invalid NDArray record (bad magic)")
    shape = tuple(struct.unpack("<q", f.read(8))[0] for _ in range(ndim))
    dev_type, dev_id = struct.unpack("<II", f.read(8))
    (flag,) = struct.unpack("<I", f.read(4))
    (nbytes,) = struct.unpack("<Q", f.read(8))
    raw = f.read(nbytes)
    dtype = flag_dtype(flag)
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.frombuffer(raw, np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, np_dtype(dtype)).copy())
    t = t.reshape(shape)
    try:
        ctx = Context(Context.devtype2str.get(dev_type, "cpu"), dev_id)
        ctx.torch_device()
    except MXNetError:
        ctx = cpu()
    return NDArray(t, ctx)


def save(fname, data):
    """Save an NDArray, a list of them or a str -> NDArray dict (names in
    sorted order) (`MXNDArraySave`)."""
    if isinstance(data, NDArray):
        data = [data]
    names, arrays = [], []
    if isinstance(data, dict):
        for k in sorted(data):
            names.append(k)
            arrays.append(data[k])
    else:
        arrays = list(data)
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for nd in arrays:
            _save_array(f, nd)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname):
    """Load what `save` wrote: a list, or a dict where names were saved
    (`MXNDArrayLoad`)."""
    try:
        with open(fname, "rb") as f:
            magic, _ = struct.unpack("<QQ", f.read(16))
            if magic != _LIST_MAGIC:
                raise MXNetError("invalid NDArray file (bad magic)")
            (n,) = struct.unpack("<Q", f.read(8))
            arrays = [_load_array(f) for _ in range(n)]
            (nn,) = struct.unpack("<Q", f.read(8))
            names = []
            for _ in range(nn):
                (ln,) = struct.unpack("<Q", f.read(8))
                names.append(f.read(ln).decode("utf-8"))
    except (struct.error, UnicodeDecodeError, ValueError, EOFError,
            RuntimeError) as e:
        raise MXNetError(
            "corrupt or truncated NDArray file %r: %s" % (fname, e))
    if names:
        if len(names) != len(arrays):
            raise MXNetError("corrupt NDArray file: name/array count mismatch")
        return dict(zip(names, arrays))
    return arrays
