"""Base error type of the PyTorch/CUDA port.

The port's counterpart of `mxnet_tpu/base.py`, reduced to what the
serving slice raises.  It is a separate class from the JAX package's
`MXNetError` (the port imports nothing of that package), with the same
name so code reads the same in both.
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch."""
