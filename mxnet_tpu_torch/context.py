"""Device resolution for the port's entry points.

Every entry point takes a ``ctx`` and runs on the card unless the caller
asks for the CPU: ``None`` means ``cuda:0``, and without a CUDA device
that raises instead of carrying on quietly on the CPU.  The CPU is an
explicit choice (``ctx="cpu"`` or a CPU ``torch.device``), which is how
the tests run the plain versions of the kernels.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve"]


def resolve(ctx=None):
    """The ``torch.device`` an entry point runs on.

    ctx: None (``cuda:0``), a string such as ``"cpu"``, ``"cuda"`` or
         ``"cuda:1"``, or a ``torch.device``.
    Raises `MXNetError` for a CUDA device when CUDA is unavailable, and
    for any device type other than ``cpu`` and ``cuda``."""
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
