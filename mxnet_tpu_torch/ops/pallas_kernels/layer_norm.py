"""LayerNorm forward and backward: CUDA kernels for the card, plain
versions beside them.

Replaces `mxnet_tpu/ops/pallas_kernels/layer_norm.py` `_fwd_pallas` (the
TPU kernel `_fwd_kernel`) and `_bwd_pallas` (`_bwd_kernel`); the plain
versions are `_fwd_jnp` and `_bwd_jnp` in torch.  The kernels
(`csrc/layer_norm.cu`) are bounded by bytes on the H100; the source's
note gives the layouts and how the backward sums dgamma/dbeta over
persistent blocks without atomics.

`layer_norm_fwd` takes x as (rows, N) in float32 or bfloat16, with gamma
and beta (N,) in x's dtype, and returns y in x's dtype plus mean and rstd
as (rows, 1) float32.  `layer_norm_bwd` takes x, gamma, mean, rstd and dy
and returns dx in x's dtype with dgamma and dbeta in gamma's dtype.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The TPU kernel's ``N % 128`` gate does not apply: the kernels
take any N >= 1.

The launch plan is Python (`_plan_fwd`, `_plan_bwd`), handed to the C
entries, which check it: the layout (a warp a row up to N = 1024, up to
8 rows a block; a block of 2, 4 or 8 warps a row up to `_REGISTER_N`; a
256-thread block looping over a wider row; with fewer rows than 8 an SM,
as in a prefill, a block of 4 warps a row, and of 8 below one row an SM,
as in decode), the vector width (`_vec_bytes`: 16
bytes where N and every pointer allow, down to one element), the
elements a thread holds, rows a block and the grid; for the backward,
persistent blocks (`_sm_count` SMs times the blocks an SM the occupancy
query allows), the static split of rows over their teams (`_bwd_split`)
and the (blocks, N) workspace.

`layer_norm` is the public function: a `torch.autograd.Function` whose
forward is the forward kernel (saving x, gamma, mean and rstd) and whose
backward is the backward kernel, with ``_ln_bwd_vjp``'s casts.  Where no
gradient is wanted (serving, under `torch.no_grad`) it calls the forward
alone and saves nothing.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from ...base import MXNetError
from . import _build

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "layer_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # a block's threads at most (`kThreads` in the source)
_EPT = (8, 16, 24, 32)  # elements a thread holds: the kernels' templates
_REGISTER_N = _THREADS * _EPT[-1]  # the widest row held in registers
_LAYOUTS = {"warp": 0, "warps": 1, "wide": 2}  # the C entries' codes

# A launch plan: layout, vector width in bytes, elements a thread holds
# (None on 'wide'), warps a row, rows a block at once (the backward's
# teams), blocks, and the backward's (blocks, N) workspace (None forward).
Plan = collections.namedtuple(
    "Plan", "layout vec_bytes ept warps rows_per_block blocks workspace")


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


# -- the launch plan -----------------------------------------------------------


def _alignment(*ptrs):
    """The largest of 16, 8, 4, 2, 1 bytes that divides every pointer."""
    bits = 16
    for p in ptrs:
        bits |= p
    return bits & -bits


def _vec_bytes(n, itemsize, alignment):
    """The vector width: the largest of 16, 8, 4 and 2 bytes, at least one
    element, that divides a row's n * itemsize bytes and ``alignment``."""
    return next((v for v in (16, 8, 4, 2) if v >= itemsize
                 and (n * itemsize) % v == 0 and alignment % v == 0),
                itemsize)


def _layout(n, vw, rows, sms):
    """(layout, elements a thread holds, warps a row) for ``rows`` rows of
    n at ``vw`` elements a vector: the fewest warps a row whose threads
    hold the row in at most 32 elements each; where a call's few rows
    leave SMs short of warps, at least 8 warps a row below one row an SM
    (decode) and 4 below 8 rows an SM (a prefill's), so that each row's
    latency, the call's, is shorter; past `_REGISTER_N` the wide loop."""
    if n > _REGISTER_N:
        return "wide", None, _THREADS // 32
    fewest = 8 if rows < sms else 4 if rows < 8 * sms else 1
    for warps in (w for w in (1, 2, 4, 8) if w >= fewest):
        need = -(-n // (32 * warps * vw)) * vw
        if need <= _EPT[-1]:
            ept = next(e for e in _EPT if e >= need)
            return ("warp" if warps == 1 else "warps"), ept, warps
    raise AssertionError("n <= _REGISTER_N fits 8 warps a row")


@functools.lru_cache(maxsize=1024)
def _plan_fwd(rows, n, dtype, ptrs_alignment, sms):
    """The forward's plan: on 'warp' up to 8 rows a block (a row a warp),
    ceil(rows / sms) when that is fewer, so that every SM takes about as
    many rows; one row a block on 'warps' and 'wide'."""
    itemsize = dtype.itemsize
    vec = _vec_bytes(n, itemsize, ptrs_alignment)
    layout, ept, warps = _layout(n, vec // itemsize, rows, sms)
    per_block = 1 if layout != "warp" else min(
        _THREADS // 32, -(-rows // max(sms, 1)))
    return Plan(layout, vec, ept, warps, per_block, -(-rows // per_block),
                None)


def _plan_bwd(rows, n, dtype, ptrs_alignment, sms, occupancy):
    """The backward's plan: persistent blocks of up to 8 teams (a warp a
    row) or of one (a block a row), each team over every teams-th row
    (`_bwd_split`).  ``occupancy(layout, vec_bytes, ept, warps,
    rows_per_block)`` is the blocks an SM holds at once ('wide' takes one
    an SM).  The grid is the fewest blocks whose teams take no more rows
    each than ``sms`` full SMs' teams would, and never more teams than
    rows."""
    itemsize = dtype.itemsize
    vec = _vec_bytes(n, itemsize, ptrs_alignment)
    layout, ept, warps = _layout(n, vec // itemsize, rows, sms)
    teams = min(_THREADS // 32, rows) if layout == "warp" else 1
    # 'wide' keeps its partial sums in the workspace row: one block an SM
    # keeps those rows (SMs x N x 8 bytes) in L2
    most = max(1, sms * (1 if layout == "wide" else occupancy(
        layout, vec, ept, warps, teams)))
    per_team = -(-rows // (most * teams))  # the most rows a team takes
    busy = -(-rows // per_team)  # the fewest teams that take no more
    blocks = max(1, min(-(-busy // teams), rows // teams))
    return Plan(layout, vec, ept, warps, teams, blocks, (blocks, n))


def _bwd_split(rows, teams):
    """The rows of each of ``teams`` teams: the kernels' static split, team
    k (block k // rows_per_block) taking rows k, k + teams, ..., so that
    the teams at work at any moment read neighbouring rows."""
    return [range(k, rows, teams) for k in range(teams)]


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_occupancy_cache = {}


def _occupancy(dtype, n):
    """The occupancy query of the backward kernel of a plan, for
    `_plan_bwd`, cached by its arguments."""
    def blocks_per_sm(layout, vec, ept, warps, teams):
        key = (_DTYPES[dtype], n, _LAYOUTS[layout], vec, ept or 0, warps,
               teams)
        if key not in _occupancy_cache:
            out = ctypes.c_int(0)
            err = _lib().mxt_layer_norm_bwd_occupancy(
                key[0], n, *key[2:], ctypes.byref(out))
            _build.check(err, "layer_norm_bwd occupancy")
            if out.value < 1:
                raise MXNetError("layer_norm_bwd: the plan %s fits no block "
                                 "on an SM" % (key,))
            _occupancy_cache[key] = out.value
        return _occupancy_cache[key]
    return blocks_per_sm


@functools.lru_cache(maxsize=1024)
def _fwd_args(rows, n, dtype, ptrs_alignment, index):
    """`_plan_fwd` on CUDA device ``index``, as the C entry's arguments
    (one cached call: decode's forward is bound by the host)."""
    return _plan_args(_plan_fwd(rows, n, dtype, ptrs_alignment,
                                _sm_count(index)))


@functools.lru_cache(maxsize=1024)
def _bwd_plan_on(rows, n, dtype, ptrs_alignment, index):
    """`_plan_bwd` on CUDA device ``index``: its SMs and occupancy."""
    return _plan_bwd(rows, n, dtype, ptrs_alignment, _sm_count(index),
                     _occupancy(dtype, n))


def _plan_args(plan):
    return (_LAYOUTS[plan.layout], plan.vec_bytes, plan.ept or 0, plan.warps,
            plan.rows_per_block, plan.blocks)


# -- the CUDA kernels -----------------------------------------------------------


def _lib():
    lib = _build.load("layer_norm")
    fwd, bwd = lib.mxt_layer_norm_fwd, lib.mxt_layer_norm_bwd
    if fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [i] + [p] * 6 + [i, i, ctypes.c_float] + [i] * 6 + [p]
        fwd.restype = i
        bwd.argtypes = [i] + [p] * 10 + [i] * 8 + [p]
        bwd.restype = i
        occ = lib.mxt_layer_norm_bwd_occupancy
        occ.argtypes = [i] * 7 + [ctypes.POINTER(i)]
        occ.restype = i
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
    if n < 1:
        raise MXNetError("%s: the CUDA kernel takes N >= 1, got %d"
                         % (what, n))
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
    if rows == 0:
        return y, mean, rstd
    # y, like the backward's dx, is a fresh allocation, on the allocator's
    # 512-byte boundary
    px, pg, pb = x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    args = _fwd_args(rows, n, x2d.dtype, _alignment(px, pg, pb),
                     x2d.device.index)
    err = _lib().mxt_layer_norm_fwd(
        _DTYPES[x2d.dtype], px, pg, pb, y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), rows, n, float(eps), *args,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "layer_norm launch")
    with _COUNT_LOCK:
        layer_norm_fwd.launches += 1
    return y, mean, rstd


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
    plan = _bwd_plan_on(rows, n, x2d.dtype, _alignment(
        x2d.data_ptr(), dy2d.data_ptr(), gamma.data_ptr()), x2d.device.index)
    part = torch.empty((2, *plan.workspace), dtype=torch.float32,
                       device=x2d.device)
    err = _lib().mxt_layer_norm_bwd(
        _DTYPES[x2d.dtype], x2d.data_ptr(), gamma.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dy2d.data_ptr(), dx.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), rows, n, *_plan_args(plan),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "layer_norm_bwd launch")
    with _COUNT_LOCK:
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


# kernel launches since the counts were last set to 0 (CUDA path only),
# under a lock: the scheduler threads of several serving replicas launch
# at once
_COUNT_LOCK = threading.Lock()
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
