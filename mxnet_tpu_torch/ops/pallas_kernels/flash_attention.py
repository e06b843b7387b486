"""Flash-attention forward: a CUDA kernel for the card, a plain version
beside it.

Replaces `mxnet_tpu/ops/pallas_kernels/flash_attention.py`
`_flash_fwd_pallas` (the TPU kernel `_fwd_kernel`, hsd layout); the plain
version mirrors `_flash_fwd_jnp`, the same online-softmax recurrence over
K blocks.  The kernel (`csrc/flash_attention.cu`) runs the recurrence in
float32, one block per (batch, head, 64-query tile), and cuts each tile's
K loop at the causal diagonal; its note gives the H100 bound and what
the design does about it.

Operands are (B, H, S, D) in float32 or bfloat16.  The kernel takes D in
{64, 128} and raises on others; it reads and writes through the batch,
head and sequence strides, so a transposed view costs no copy, but the
last axis must be contiguous.  The output is allocated with q's strides
(``empty_like``), so the serving prefill's transpose back is free too.

One deliberate difference from the JAX functions: a query row that sees
no key at all gets ``out = 0`` (and ``lse = -1e30``, as in JAX).  The JAX
recurrence gives such a row ``exp(-1e30 - (-1e30)) = 1`` for every
masked score of a visited K block, so its output there is the mean of
that block's V rows and depends on the block size.  Rows that see at
least one key agree.  The backward is a later slice.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_plain"]

_NEG_INF = -1e30
_BLOCK_K = 256  # the plain version's K block: the JAX default on the CPU
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _flash_fwd_plain(q, k, v, q_off, k_off, scale, causal):
    """The plain version: `_flash_fwd_jnp`'s recurrence over K blocks of
    `_BLOCK_K` keys, with masked scores contributing an exact 0.
    Returns (out in q's dtype, lse float32)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    block_k = max(1, min(_BLOCK_K, skv))
    qf = q.float() * scale
    q_pos = q_off + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, skv, block_k):
        kb = k[:, :, start:start + block_k].float()
        vb = v[:, :, start:start + block_k].float()
        s = qf @ kb.transpose(-1, -2)
        if causal:
            k_pos = k_off + start + torch.arange(kb.shape[2], device=q.device)
            mask = q_pos >= k_pos[None, :]
            s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.mxt_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, i, p, p, p, p, p, i, i, i, i] + [ll] * 12
                       + [i, i, i, ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(q, k, v):
    """What the CUDA kernel takes; raises `MXNetError` on anything else."""
    b, h, sq, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention: CUDA kernel takes q, k, v all "
                         "float32 or all bfloat16, got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if d not in _HEAD_DIMS:
        raise MXNetError("flash_attention: CUDA kernel takes head_dim in %s, "
                         "got %d" % (_HEAD_DIMS, d))
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[3] != d:
        raise MXNetError("flash_attention: k and v must be (%d, %d, Skv, %d),"
                         " got %s and %s" % (b, h, d, tuple(k.shape),
                                             tuple(v.shape)))
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise MXNetError("flash_attention: the head_dim axis of q, k and v "
                         "must be contiguous")
    if b > 65535 or h > 65535:
        raise MXNetError("flash_attention: batch and heads must be <= 65535")
    if k.device != q.device or v.device != q.device:
        raise MXNetError("flash_attention: q, k and v must share a device")
    _build.check_current_device(q.device, "flash_attention")


def _flash_fwd_cuda(q, k, v, q_off, k_off, scale, causal, with_lse):
    _check_cuda_args(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    if out.stride(3) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _lib()(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, h, sq, k.shape[2], *strides, q_off, k_off, int(causal),
                 float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    return out, lse


def _offset(x, what):
    if int(x) != x:
        raise MXNetError("flash_attention: %s must be a whole number, got %r"
                         % (what, x))
    return int(x)


def flash_attention(q, k, v, *, causal=False, scale=None, q_offset=0,
                    k_offset=0, with_lse=False):
    """Fused attention over (batch, heads, seq, head_dim) tensors.

    ``scale`` defaults to 1/sqrt(head_dim).  ``q_offset``/``k_offset`` are
    the global positions of row/column 0 for causal masking.  Returns the
    output in q's dtype; with ``with_lse=True`` also the per-row logsumexp
    of the scaled scores, (batch, heads, seq) float32.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention expects (B, H, S, D) inputs")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q_off = _offset(q_offset, "q_offset")
    k_off = _offset(k_offset, "k_offset")
    if q.device.type == "cpu":
        out, lse = _flash_fwd_plain(q, k, v, q_off, k_off, float(scale),
                                    bool(causal))
    elif q.device.type == "cuda":
        out, lse = _flash_fwd_cuda(q, k, v, q_off, k_off, float(scale),
                                   bool(causal), with_lse)
    else:
        raise MXNetError("flash_attention: unsupported device %s" % q.device)
    return (out, lse) if with_lse else out


# kernel launches since the count was last set to 0 (CUDA path only)
flash_attention.launches = 0


def flash_attention_plain(q, k, v, *, causal=False, scale=None, q_offset=0,
                          k_offset=0, with_lse=False):
    """`flash_attention` through the plain version on any device: the
    reference that `chip_smoke.py` holds the kernel against on the card."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = _flash_fwd_plain(q, k, v, _offset(q_offset, "q_offset"),
                                _offset(k_offset, "k_offset"), float(scale),
                                bool(causal))
    return (out, lse) if with_lse else out
