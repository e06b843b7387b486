"""Base types of the PyTorch/CUDA port.

The port's counterpart of `mxnet_tpu/base.py`: the error type, shape and
dtype helpers, and the integer dtype flags of the saved-array format.
`MXNetError` is a separate class from the JAX package's (the port imports
nothing of that package), with the same name so code reads the same in
both.  The flags are the JAX package's (0-4 the reference's, bfloat16 5),
so `.params` files carry over; bfloat16 is a torch dtype here, since
numpy has none without ml_dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "check_shape", "np_dtype", "dtype_flag",
           "flag_dtype", "torch_dtype", "numeric_types"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch."""


def check_shape(shape) -> tuple:
    """Canonicalize a shape argument to a tuple of ints (reference TShape)."""
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(x) for x in shape)


def np_dtype(dtype) -> np.dtype:
    """Canonicalize a numpy dtype-like object (or a torch dtype other than
    bfloat16) to a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


# torch dtype -> the saved format's flag (`mxnet_tpu/base.py:50-62`)
_FLAGS = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
          torch.uint8: 3, torch.int32: 4, torch.bfloat16: 5, torch.int64: 6,
          torch.int8: 7, torch.bool: 8, torch.uint32: 9, torch.uint64: 10}
_BY_FLAG = {v: k for k, v in _FLAGS.items()}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype-like, a name
    ('bfloat16' included) or a saved-format flag."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, (int, np.integer)) and not isinstance(dtype, bool):
        return flag_dtype(dtype)
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def dtype_flag(dtype) -> int:
    """The saved format's integer flag of a dtype."""
    t = torch_dtype(dtype)
    if t not in _FLAGS:
        raise MXNetError("unsupported dtype %s" % t)
    return _FLAGS[t]


def flag_dtype(flag) -> torch.dtype:
    """The torch dtype of a saved-format flag."""
    if int(flag) not in _BY_FLAG:
        raise MXNetError("unknown dtype flag %d" % flag)
    return _BY_FLAG[int(flag)]


numeric_types = (float, int, np.generic)
