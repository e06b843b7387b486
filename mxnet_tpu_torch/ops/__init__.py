"""Operators of the port.  Importing this package registers every op.

The registry (`registry`) holds the ops of the LM training path:
`elementwise`, `tensor`, `nn`, `loss` and the attention ops of
`attention`, which also holds the serving attention helpers (plain
torch).  The hand-written kernels live under `pallas_kernels`.
"""
from __future__ import annotations

from . import registry
from . import elementwise  # noqa: F401  (registers ops)
from . import nn  # noqa: F401
from . import tensor  # noqa: F401
from . import loss  # noqa: F401
from . import attention  # noqa: F401
from .registry import OpCtx, OpDef, Param, get, list_ops, register

__all__ = ["OpCtx", "OpDef", "Param", "get", "list_ops", "register"]
