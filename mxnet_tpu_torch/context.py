"""Device contexts of the port.

A port of `mxnet_tpu/context.py` (the reference's `Context{dev_type,
dev_id}` and its `with` scope), over torch devices:

* `Context` names a logical device, value-semantic and hashable, with
  the saved format's type ids (cpu 1, the accelerator 2, cpu_pinned 3).
  ``gpu(i)`` is ``cuda:i``; ``tpu(i)`` is kept as an alias of ``gpu(i)``,
  as the JAX package keeps ``gpu`` as an alias of ``tpu``, so reference
  scripts run unchanged and a saved array carries type id 2 in both
  packages.  Every ``cpu(i)`` is the one CPU device: several CPU contexts
  are how the tests run multi-device code without cards, as the
  reference's do.
* `Context.torch_device` resolves through `resolve`, which raises for a
  card that is not there: no context quietly runs on the CPU.
* Deliberate difference: `current_context()` with an empty stack is
  ``gpu(0)`` here, where the JAX package gives ``cpu(0)``.  The port runs
  on the card unless asked for the CPU.

`resolve` is what the port's other entry points take a ``ctx`` through:
``None`` means ``cuda:0``, and without a CUDA device that raises instead
of carrying on quietly on the CPU.  The CPU is an explicit choice
(``ctx="cpu"``, a CPU ``torch.device`` or ``cpu()``), which is how the
tests run the plain versions of the kernels.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_devices",
           "resolve"]


def resolve(ctx=None):
    """The ``torch.device`` an entry point runs on.

    ctx: None (``cuda:0``), a `Context`, a string such as ``"cpu"``,
         ``"cuda"`` or ``"cuda:1"``, or a ``torch.device``.
    Raises `MXNetError` for a CUDA device when CUDA is unavailable, and
    for any device type other than ``cpu`` and ``cuda``."""
    if isinstance(ctx, Context):
        return ctx.torch_device()
    dev = torch.device("cuda", 0) if ctx is None else torch.device(ctx)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError("unsupported device %s: the port runs on cuda, or "
                         "on cpu when asked" % dev)
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device: the port runs on the card by default; pass "
            "ctx='cpu' to run its plain versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise MXNetError("CUDA device %d not present (%d visible)"
                         % (dev.index, torch.cuda.device_count()))
    return dev


class Context:
    """A logical device.  Value-semantic and hashable."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "tpu": 2, "cpu_pinned": 3}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def torch_device(self):
        """The torch device: ``cpu`` for every CPU context, ``cuda:i`` for
        ``gpu(i)`` (through `resolve`, which raises without that card)."""
        if self.device_typeid == 2:
            return resolve(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *args):
        Context._default_ctx.stack.pop()

    @staticmethod
    def default_ctx():
        stack = getattr(Context._default_ctx, "stack", None)
        if stack:
            return stack[-1]
        return Context("gpu", 0)


def cpu(device_id=0):
    """A CPU context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """The context of card ``device_id`` (``cuda:device_id``)."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`, so reference scripts written for the JAX
    package run unchanged."""
    return Context("gpu", device_id)


def current_context():
    """The context at the top of the ``with mx.Context(...)`` stack;
    ``gpu(0)`` when the stack is empty."""
    return Context.default_ctx()


def num_devices(device_type="gpu"):
    """Number of visible devices of a type: cards for gpu/tpu, 1 for the
    CPU."""
    if device_type in ("gpu", "tpu"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1
