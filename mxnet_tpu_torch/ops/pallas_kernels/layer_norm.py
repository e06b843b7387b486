"""LayerNorm forward and backward: CUDA kernels for the card, plain
versions beside them.

Replaces `mxnet_tpu/ops/pallas_kernels/layer_norm.py` `_fwd_pallas` (the
TPU kernel `_fwd_kernel`) and `_bwd_pallas` (`_bwd_kernel`); the plain
versions are `_fwd_jnp` and `_bwd_jnp` in torch.  The kernels
(`csrc/layer_norm.cu`) are memory-bound on the H100; the forward is
launch-bound at serving decode's few rows.  The source's note says what
the design does about that, and how the backward sums dgamma/dbeta over
row chunks without atomics.

`layer_norm_fwd` takes x as (rows, N) in float32 or bfloat16, with gamma
and beta (N,) in x's dtype, and returns y in x's dtype plus mean and rstd
as (rows, 1) float32.  `layer_norm_bwd` takes x, gamma, mean, rstd and dy
and returns dx in x's dtype with dgamma and dbeta in gamma's dtype.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The TPU kernel's ``N % 128`` gate does not apply: the kernels
take any N up to 8192 and raise above it.

`layer_norm` is the public function: a `torch.autograd.Function` whose
forward is the forward kernel (saving x, gamma, mean and rstd) and whose
backward is the backward kernel, with ``_ln_bwd_vjp``'s casts.  Where no
gradient is wanted (serving, under `torch.no_grad`) it calls the forward
alone and saves nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_N = 256 * 32
_MAX_CHUNKS = 512  # row chunks of the backward's dgamma/dbeta partial sums


def _fwd_plain(x2d, gamma, beta, eps):
    """The plain version: `_fwd_jnp` of the JAX package in torch (two-pass
    float32 statistics)."""
    x = x2d.float()
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x - mean) * rstd * gamma.float() + beta.float()
    return y.to(x2d.dtype), mean, rstd


def _bwd_plain(x2d, gamma, mean, rstd, dy2d):
    """The plain backward: `_bwd_jnp` in torch.  Returns dx in x's dtype and
    float32 dgamma, dbeta."""
    x = x2d.float()
    dy = dy2d.float()
    xhat = (x - mean) * rstd
    gdy = dy * gamma.float()
    m1 = gdy.mean(dim=1, keepdim=True)
    m2 = (gdy * xhat).mean(dim=1, keepdim=True)
    dx = (rstd * (gdy - m1 - xhat * m2)).to(x2d.dtype)
    return dx, (dy * xhat).sum(dim=0), dy.sum(dim=0)


def _lib():
    lib = _build.load("layer_norm")
    fwd, bwd = lib.mxt_layer_norm_fwd, lib.mxt_layer_norm_bwd
    if fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [i, p, p, p, p, p, p, i, i, ctypes.c_float, p]
        fwd.restype = i
        bwd.argtypes = [i] + [p] * 10 + [i, i, i, i, p]
        bwd.restype = i
    return lib


def _check_cuda_args(x2d, gamma, others, what):
    """What the CUDA kernels take; raises `MXNetError` on anything else."""
    n = x2d.shape[1]
    if x2d.dtype not in _DTYPES:
        raise MXNetError("%s: CUDA kernel takes float32 or bfloat16, got %s"
                         % (what, x2d.dtype))
    if gamma.dtype != x2d.dtype or any(t.dtype != x2d.dtype for t in others):
        raise MXNetError("%s: gamma, beta and dy must be in x's dtype %s, "
                         "got %s" % (what, x2d.dtype, [gamma.dtype] +
                                     [t.dtype for t in others]))
    if gamma.shape != (n,):
        raise MXNetError("%s: gamma must be (%d,), got %s"
                         % (what, n, tuple(gamma.shape)))
    if not 1 <= n <= _MAX_N:
        raise MXNetError("%s: the CUDA kernel takes 1 <= N <= %d, got %d"
                         % (what, _MAX_N, n))
    if any(t.device != x2d.device for t in (gamma, *others)):
        raise MXNetError("%s: every operand must be on x's device" % what)
    _build.check_current_device(x2d.device, what)


def _fwd_cuda(x2d, gamma, beta, eps):
    rows, n = x2d.shape
    if beta.shape != (n,):
        raise MXNetError("layer_norm: gamma/beta must be (%d,), got %s and "
                         "%s" % (n, tuple(gamma.shape), tuple(beta.shape)))
    _check_cuda_args(x2d, gamma, (beta,), "layer_norm")
    x2d, gamma, beta = x2d.contiguous(), gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2d.device)
    err = _lib().mxt_layer_norm_fwd(
        _DTYPES[x2d.dtype], x2d.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows,
        n, float(eps), torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "layer_norm launch")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


def _bwd_chunks(rows):
    """(chunks, rows_per_chunk) of the backward's row split: at most
    `_MAX_CHUNKS` blocks, each over consecutive rows."""
    per = -(-rows // min(rows, _MAX_CHUNKS))
    return -(-rows // per), per


def _bwd_cuda(x2d, gamma, mean, rstd, dy2d):
    rows, n = x2d.shape
    if dy2d.shape != x2d.shape:
        raise MXNetError("layer_norm_bwd: dy %s must match x %s"
                         % (tuple(dy2d.shape), tuple(x2d.shape)))
    if mean.shape != (rows, 1) or rstd.shape != (rows, 1) or \
            mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise MXNetError("layer_norm_bwd: mean and rstd must be (%d, 1) "
                         "float32" % rows)
    _check_cuda_args(x2d, gamma, (dy2d,), "layer_norm_bwd")
    if mean.device != x2d.device or rstd.device != x2d.device:
        raise MXNetError("layer_norm_bwd: every operand must be on x's "
                         "device")
    x2d, gamma, dy2d = x2d.contiguous(), gamma.contiguous(), dy2d.contiguous()
    mean, rstd = mean.contiguous(), rstd.contiguous()
    dx = torch.empty_like(x2d)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    if rows == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    chunks, per = _bwd_chunks(rows)
    part = torch.empty((2, chunks, n), dtype=torch.float32,
                       device=x2d.device)
    err = _lib().mxt_layer_norm_bwd(
        _DTYPES[x2d.dtype], x2d.data_ptr(), gamma.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dy2d.data_ptr(), dx.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), rows, n, chunks, per,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "layer_norm_bwd launch")
    layer_norm_bwd.launches += 1
    return dx, dgamma, dbeta


def _on(x2d, what, plain, cuda, *args):
    if x2d.dim() != 2:
        raise MXNetError("%s expects (rows, N), got %s"
                         % (what, tuple(x2d.shape)))
    if x2d.device.type == "cpu":
        return plain(x2d, *args)
    if x2d.device.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (what, x2d.device))
    return cuda(x2d, *args)


def layer_norm_fwd(x2d, gamma, beta, eps=1e-5):
    """(y, mean, rstd) of LayerNorm over the last axis of x2d (rows, N)."""
    return _on(x2d, "layer_norm_fwd", _fwd_plain, _fwd_cuda, gamma, beta,
               eps)


def layer_norm_bwd(x2d, gamma, mean, rstd, dy2d):
    """(dx, dgamma, dbeta) of LayerNorm from the forward's statistics.
    dx is in x's dtype; dgamma and dbeta are float32 sums on the CPU and
    in gamma's dtype from the kernel (`_LayerNormFn` casts both alike)."""
    return _on(x2d, "layer_norm_bwd", _bwd_plain, _bwd_cuda, gamma, mean,
               rstd, dy2d)


# kernel launches since the counts were last set to 0 (CUDA path only)
layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm with the backward of `_ln_bwd_vjp`: dx in x's dtype,
    dgamma and dbeta cast to gamma's dtype.  ``plain`` runs both passes
    through the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, plain):
        x2d = x.reshape(-1, x.shape[-1])
        fwd = _fwd_plain if plain else layer_norm_fwd
        y, mean, rstd = fwd(x2d, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, mean, rstd)
        ctx.plain = plain
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma, mean, rstd = ctx.saved_tensors
        bwd = _bwd_plain if ctx.plain else layer_norm_bwd
        dx, dg, db = bwd(x2d, gamma, mean, rstd, dy.reshape(x2d.shape))
        return (dx.reshape(dy.shape), dg.to(gamma.dtype), db.to(gamma.dtype),
                None, None)


def _wants_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def layer_norm(x, gamma, beta, eps=1e-5):
    """y = (x - mean)/sqrt(var+eps) * gamma + beta over the last axis of x
    (any leading shape), as the JAX package's public `layer_norm`, with its
    gradient through the backward kernel."""
    if _wants_grad(x, gamma, beta):
        return _LayerNormFn.apply(x, gamma, beta, float(eps), False)
    y, _, _ = layer_norm_fwd(x.reshape(-1, x.shape[-1]), gamma, beta, eps)
    return y.reshape(x.shape)


def layer_norm_plain(x, gamma, beta, eps=1e-5):
    """`layer_norm` through the plain versions on any device, gradient
    included: the reference that `chip_smoke.py` holds the kernels
    against on the card."""
    if _wants_grad(x, gamma, beta):
        return _LayerNormFn.apply(x, gamma, beta, float(eps), True)
    y, _, _ = _fwd_plain(x.reshape(-1, x.shape[-1]), gamma, beta, eps)
    return y.reshape(x.shape)
