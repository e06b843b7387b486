"""Device meshes: the port of `mxnet_tpu/parallel/mesh.py`.

A `Mesh` is a plain grid of ``torch.device`` entries with named axes, the
same conventions as the JAX package's:

* axis "data" - batch (data parallelism);
* axis "model" - tensor/model parallelism (a sub-mesh serving replica's
  shard axis);
* axis "seq" - sequence/context parallelism.

A device may appear more than once: a 2-shard serving group on one card
is ``[cuda:0, cuda:0]``, and the CPU tests build ``[cpu] * k``.  The
serving engine runs the partitioned programs over the entries of one
axis (`ServingEngine(ctx=mesh)`); the trainer's shardings wait for the
port's `torch.distributed` training (ROADMAP.md queue 1, item 3).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Mesh", "MeshContext", "get_mesh", "make_mesh",
           "data_parallel_sharding", "replicated_sharding",
           "mesh_signature", "submeshes"]

_current_mesh = None


def _device(d):
    """``d`` as the ``torch.device`` tensors on it report: ``cpu`` without
    an index, ``cuda`` with one."""
    d = torch.device(d)
    if d.type == "cpu":
        return torch.device("cpu")
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


class Mesh:
    """A grid of devices with named axes.

    ``devices`` is an ndarray of ``torch.device`` (object dtype) whose
    shape is the mesh's; ``axis_names`` names its axes in order;
    ``shape`` maps each name to its size, in order, as the JAX `Mesh`
    does."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = arr.reshape(-1)
        for i, d in enumerate(np.asarray(devices, dtype=object).reshape(-1)):
            flat[i] = _device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise MXNetError("Mesh: %d axis names for a %d-d device grid"
                             % (len(axis_names), arr.ndim))
        if len(set(axis_names)) != len(axis_names):
            raise MXNetError("Mesh: repeated axis name in %s"
                             % (axis_names,))
        self.devices = arr
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, arr.shape))

    def axis_devices(self, axis):
        """The devices along ``axis``, in order; every other axis must
        have size 1 (the port keeps no copies across a second axis)."""
        if axis not in self.axis_names:
            raise MXNetError("Mesh: no axis %r in %s"
                             % (axis, self.axis_names))
        others = [n for n, k in self.shape.items() if n != axis and k > 1]
        if others:
            raise MXNetError(
                "Mesh: sharding over %r needs every other axis of size 1, "
                "got %s (replication across a second axis is not ported)"
                % (axis, dict(self.shape)))
        return list(self.devices.reshape(-1))

    def __repr__(self):
        return "Mesh(%s, %s)" % ([str(d) for d in self.devices.reshape(-1)],
                                 dict(self.shape))


def _visible_devices():
    """Every visible CUDA device, one entry each."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise MXNetError(
            "make_mesh: no CUDA device; the port runs on the card by "
            "default, pass devices=['cpu'] * k to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape=None, axis_names=("data",), devices=None):
    """Create a Mesh.  shape=None puts every device on the first axis;
    ``devices`` defaults to every visible CUDA device, one entry each."""
    devices = list(_visible_devices() if devices is None else devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise MXNetError(
            "mesh shape %s needs %d devices, have %d" % (shape, n,
                                                        len(devices)))
    arr = np.empty((n,), dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i] = _device(d)
    return Mesh(arr.reshape(shape), axis_names)


class MeshContext:
    """`with MeshContext(mesh):` scopes the current mesh like the
    reference's Context stack."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._old = None

    def __enter__(self):
        global _current_mesh
        self._old = _current_mesh
        _current_mesh = self.mesh
        return self.mesh

    def __exit__(self, *args):
        global _current_mesh
        _current_mesh = self._old


def get_mesh():
    return _current_mesh


def data_parallel_sharding(mesh, axis="data"):
    """The trainer's batch sharding: waits for the port's multi-process
    training."""
    raise MXNetError("data_parallel_sharding: the trainer's mesh shardings "
                     "are not ported yet (ROADMAP.md queue 1, item 3)")


def replicated_sharding(mesh):
    """The trainer's replicated sharding: waits for the port's
    multi-process training."""
    raise MXNetError("replicated_sharding: the trainer's mesh shardings "
                     "are not ported yet (ROADMAP.md queue 1, item 3)")


def mesh_signature(mesh):
    """Hashable identity of a mesh's program space: axis names, axis
    sizes and device platform (``cuda`` or ``cpu``); ``None`` signs as the
    empty tuple.  Two groups of the same width share a signature."""
    if mesh is None:
        return ()
    first = mesh.devices.reshape(-1)[0]
    return (tuple(mesh.axis_names), tuple(mesh.devices.shape),
            str(first.type))


def submeshes(devices, per_mesh, axis_names=("model",)):
    """Partition ``devices`` into consecutive groups of ``per_mesh`` and
    return one 1-axis Mesh per group: the sub-mesh replicas' fleet layout
    (`ReplicaRouter.from_mesh(..., devices_per_replica=k)`).  A remainder
    that cannot fill a whole group is dropped; raises when no group
    fills."""
    devices = list(devices)
    per_mesh = int(per_mesh)
    if per_mesh < 1:
        raise MXNetError("submeshes: need per_mesh >= 1, got %d" % per_mesh)
    groups = [devices[i:i + per_mesh]
              for i in range(0, len(devices) - per_mesh + 1, per_mesh)]
    if not groups:
        raise MXNetError(
            "submeshes: %d devices cannot fill one %d-device sub-mesh"
            % (len(devices), per_mesh))
    out = []
    for g in groups:
        arr = np.empty((len(g),), dtype=object)
        for i, d in enumerate(g):
            arr[i] = _device(d)
        out.append(Mesh(arr, axis_names))
    return out
