"""Base types of the PyTorch/CUDA port.

The port's counterpart of `mxnet_tpu/base.py`, reduced to what the port
uses: the error type, `check_shape` and `np_dtype`.  `MXNetError` is a
separate class from the JAX package's (the port imports nothing of that
package), with the same name so code reads the same in both.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MXNetError", "check_shape", "np_dtype"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch."""


def check_shape(shape) -> tuple:
    """Canonicalize a shape argument to a tuple of ints (reference TShape)."""
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(x) for x in shape)


def np_dtype(dtype) -> np.dtype:
    """Canonicalize a numpy dtype-like object to a numpy dtype."""
    return np.dtype(dtype)
