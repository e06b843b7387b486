"""LayerNorm forward: a CUDA kernel for the card, a plain version beside it.

Replaces `mxnet_tpu/ops/pallas_kernels/layer_norm.py` `_fwd_pallas` (the
TPU kernel `_fwd_kernel`); the plain version is `_fwd_jnp` in torch.
The kernel (`csrc/layer_norm.cu`) is memory-bound on the H100 (one read
and one write of each element) and launch-bound at serving decode's few
rows; its note says what the design does about that.

`layer_norm_fwd` takes x as (rows, N) in float32 or bfloat16, with gamma
and beta (N,) in x's dtype, and returns y in x's dtype plus mean and rstd
as (rows, 1) float32 (the backward of a later slice reads them).  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The TPU kernel's ``N % 128`` gate does not apply: the kernel
takes any N up to 8192 and raises above it.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_N = 256 * 32


def _fwd_plain(x2d, gamma, beta, eps):
    """The plain version: `_fwd_jnp` of the JAX package in torch (two-pass
    float32 statistics)."""
    x = x2d.float()
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x - mean) * rstd * gamma.float() + beta.float()
    return y.to(x2d.dtype), mean, rstd


def _lib():
    lib = _build.load("layer_norm")
    fn = lib.mxt_layer_norm_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _fwd_cuda(x2d, gamma, beta, eps):
    rows, n = x2d.shape
    if x2d.dtype not in _DTYPES:
        raise MXNetError("layer_norm: CUDA kernel takes float32 or bfloat16, "
                         "got %s" % x2d.dtype)
    if gamma.dtype != x2d.dtype or beta.dtype != x2d.dtype:
        raise MXNetError("layer_norm: gamma and beta must be in x's dtype "
                         "%s, got %s and %s" % (x2d.dtype, gamma.dtype,
                                                beta.dtype))
    if gamma.shape != (n,) or beta.shape != (n,):
        raise MXNetError("layer_norm: gamma/beta must be (%d,), got %s and "
                         "%s" % (n, tuple(gamma.shape), tuple(beta.shape)))
    if not 1 <= n <= _MAX_N:
        raise MXNetError("layer_norm: the CUDA kernel takes 1 <= N <= %d, "
                         "got %d" % (_MAX_N, n))
    if gamma.device != x2d.device or beta.device != x2d.device:
        raise MXNetError("layer_norm: x, gamma and beta must share a device")
    _build.check_current_device(x2d.device, "layer_norm")
    x2d, gamma, beta = x2d.contiguous(), gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    err = _lib()(_DTYPES[x2d.dtype], x2d.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), y.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), rows, n, float(eps),
                 torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "layer_norm launch")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


def layer_norm_fwd(x2d, gamma, beta, eps=1e-5):
    """(y, mean, rstd) of LayerNorm over the last axis of x2d (rows, N)."""
    if x2d.dim() != 2:
        raise MXNetError("layer_norm_fwd expects (rows, N), got %s"
                         % (tuple(x2d.shape),))
    if x2d.device.type == "cpu":
        return _fwd_plain(x2d, gamma, beta, eps)
    if x2d.device.type != "cuda":
        raise MXNetError("layer_norm: unsupported device %s" % x2d.device)
    return _fwd_cuda(x2d, gamma, beta, eps)


# kernel launches since the count was last set to 0 (CUDA path only)
layer_norm_fwd.launches = 0


def layer_norm(x, gamma, beta, eps=1e-5):
    """y = (x - mean)/sqrt(var+eps) * gamma + beta over the last axis of x
    (any leading shape), as the JAX package's public `layer_norm`."""
    y, _, _ = layer_norm_fwd(x.reshape(-1, x.shape[-1]), gamma, beta, eps)
    return y.reshape(x.shape)


def layer_norm_plain(x, gamma, beta, eps=1e-5):
    """`layer_norm` through the plain version on any device: the reference
    that `chip_smoke.py` holds the kernel against on the card."""
    y, _, _ = _fwd_plain(x.reshape(-1, x.shape[-1]), gamma, beta, eps)
    return y.reshape(x.shape)
