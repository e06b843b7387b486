"""Flash attention, forward and backward: CUDA kernels for the card, plain
versions beside them.

Replaces `mxnet_tpu/ops/pallas_kernels/flash_attention.py`
`_flash_fwd_pallas` (the TPU kernel `_fwd_kernel`, hsd layout) and
`_flash_bwd_pallas` (`_bwd_dq_kernel`, `_bwd_dkv_kernel`), and, through
strides, their bsd twins `_flash_fwd_pallas_bsd` and
`_flash_bwd_pallas_bsd`.  The plain versions mirror `_flash_fwd_jnp`
(the online-softmax recurrence over K blocks) and `_flash_bwd` (the
recompute from the saved lse over K blocks).  The kernels
(`csrc/flash_attention.cu`) run their sums in float32: the forward and
the dq pass take one block per (batch, head, 64-query tile) and cut the
K loop at the causal diagonal; the dk/dv pass takes one block per
(batch, head, 64-key tile) and starts its Q loop at the first query tile
that reaches it.  The source's note gives the H100 bound and what the
design does about it.

Operands are (B, H, S, D) in float32 or bfloat16.  The kernels take D in
{64, 128} and raise on others; they read and write through the batch,
head and sequence strides, so a transposed view costs no copy, but the
last axis must be contiguous.  Outputs and gradients are allocated with
q's (k's, v's) strides (``empty_like``), so the transposes around them
are free too.  `flash_attention_bsd` takes (B, S, E) operands and hands
the (B, H, S, D) view of their heads to the same kernels: no copy.

`flash_attention` and `flash_attention_bsd` are `torch.autograd.Function`s
over (out, lse): the backward folds the lse cotangent into delta_i =
sum(dO_i * O_i) - glse_i (plain torch, as the JAX package computes it
outside its kernels) and returns no gradient for the offsets.  Where no
gradient is wanted (serving, under `torch.no_grad`) they run the forward
alone, with lse only when asked.

One deliberate difference from the JAX functions: a query row that sees
no key at all gets ``out = 0`` (and ``lse = -1e30``, as in JAX), and a
zero gradient.  The JAX recurrence gives such a row ``exp(-1e30 -
(-1e30)) = 1`` for every masked score of a visited K block, so its output
there is the mean of that block's V rows and depends on the block size;
the TPU kernel body skips the block and agrees with the port.  Rows that
see at least one key agree with both.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bsd",
           "flash_attention_bsd_plain"]

_NEG_INF = -1e30
_BLOCK_K = 256  # the plain versions' K block: the JAX default on the CPU
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


def _delta(o, g, glse):
    """delta_i = sum_d dO_id O_id - glse_i, float32 (B, H, Sq)."""
    delta = (g.float() * o.float()).sum(dim=-1)
    return delta if glse is None else delta - glse.float()


def _flash_bwd_plain(q, k, v, o, lse, g, glse, q_off, k_off, scale, causal):
    """The plain backward: `_flash_bwd`'s recompute over K blocks of
    `_BLOCK_K` keys, with p exactly 0 wherever the mask hides a key (so a
    row that sees no key gets a zero gradient).  ``glse`` may be None (no
    lse cotangent).  Returns (dq, dk, dv) in the inputs' dtypes."""
    sq, skv = q.shape[2], k.shape[2]
    block_k = max(1, min(_BLOCK_K, skv))
    qf, gf = q.float(), g.float()
    delta = _delta(o, g, glse)[..., None]
    lse = lse[..., None]
    q_pos = q_off + torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for start in range(0, skv, block_k):
        kb = k[:, :, start:start + block_k].float()
        vb = v[:, :, start:start + block_k].float()
        p = torch.exp(qf @ kb.transpose(-1, -2) * scale - lse)
        if causal:
            k_pos = k_off + start + torch.arange(kb.shape[2], device=q.device)
            p = torch.where(q_pos >= k_pos[None, :], p, 0.0)
        dv[:, :, start:start + block_k] = p.transpose(-1, -2) @ gf
        ds = p * (gf @ vb.transpose(-1, -2) - delta) * scale
        dq += ds @ kb
        dk[:, :, start:start + block_k] = ds.transpose(-1, -2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = _build.load("flash_attention")
    fwd, bwd = lib.mxt_flash_attention_fwd, lib.mxt_flash_attention_bwd
    if fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fwd.argtypes = ([i, i, p, p, p, p, p, i, i, i, i] + [ll] * 12
                        + [i, i, i, ctypes.c_float, p])
        fwd.restype = i
        bwd.argtypes = ([i, i, i] + [p] * 8 + [i, i, i, i] + [ll] * 18
                        + [i, i, i, ctypes.c_float, p])
        bwd.restype = i
    return lib


def _check_cuda_args(q, k, v):
    """What the CUDA kernels take; raises `MXNetError` on anything else."""
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


def _like(t):
    """An empty tensor shaped as t, with t's strides where its last axis is
    contiguous (so a transposed view's gradient is the same view)."""
    out = torch.empty_like(t)
    if out.stride(3) != 1:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _flash_fwd_cuda(q, k, v, q_off, k_off, scale, causal, with_lse, entry):
    _check_cuda_args(q, k, v)
    b, h, sq, d = q.shape
    out = _like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    err = _lib().mxt_flash_attention_fwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, sq,
        k.shape[2], *_strides(q, k, v, out), q_off, k_off, int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention launch")
    entry.launches += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, o, lse, g, glse, q_off, k_off, scale, causal,
                    entry):
    _check_cuda_args(q, k, v)
    b, h, sq, d = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise MXNetError("flash_attention backward: the out cotangent must "
                         "be %s %s, got %s %s" % (tuple(q.shape), q.dtype,
                                                  tuple(g.shape), g.dtype))
    if g.stride(3) != 1:
        g = g.contiguous()
    delta = _delta(o, g, glse).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = _like(q), _like(k), _like(v)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              g.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (q_off, k_off, int(causal), float(scale), stream)
    err = lib.mxt_flash_attention_bwd(
        0, *common, dq.data_ptr(), None, b, h, sq, k.shape[2],
        *_strides(q, k, v, g, dq, dq), *tail)
    _build.check(err, "flash_attention dq launch")
    entry.dq_launches += 1
    err = lib.mxt_flash_attention_bwd(
        1, *common, dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[2],
        *_strides(q, k, v, g, dk, dv), *tail)
    _build.check(err, "flash_attention dk/dv launch")
    entry.dkv_launches += 1
    return dq, dk, dv


def _device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention: unsupported device %s" % q.device)
    return q.device.type


def _fwd(q, k, v, q_off, k_off, scale, causal, with_lse, entry):
    """The forward on q's device: the kernel on the card (its launches
    counted on ``entry``), the plain version on the CPU or where ``entry``
    is None."""
    if _device(q) == "cpu" or entry is None:
        return _flash_fwd_plain(q, k, v, q_off, k_off, scale, causal)
    return _flash_fwd_cuda(q, k, v, q_off, k_off, scale, causal, with_lse,
                           entry)


class _FlashFn(torch.autograd.Function):
    """Attention over (out, lse) with the backward of `_flash_bwd_pallas`:
    dq, dk, dv from the two backward passes; no gradient for the offsets.
    ``entry`` is the public function whose counters take the launches, or
    None for the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, scale, causal, entry):
        out, lse = _fwd(q, k, v, q_off, k_off, scale, causal, True, entry)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_off, k_off, scale, causal, entry)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, glse):
        q, k, v, out, lse = ctx.saved_tensors
        q_off, k_off, scale, causal, entry = ctx.args
        if g is None:
            g = torch.zeros_like(out)
        if _device(q) == "cpu" or entry is None:
            grads = _flash_bwd_plain(q, k, v, out, lse, g, glse, q_off,
                                     k_off, scale, causal)
        else:
            grads = _flash_bwd_cuda(q, k, v, out, lse, g, glse, q_off, k_off,
                                    scale, causal, entry)
        return grads + (None,) * 5


def _offset(x, what):
    if int(x) != x:
        raise MXNetError("flash_attention: %s must be a whole number, got %r"
                         % (what, x))
    return int(x)


def _attend(q, k, v, causal, scale, q_offset, k_offset, with_lse, entry):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    args = (_offset(q_offset, "q_offset"), _offset(k_offset, "k_offset"),
            float(scale), bool(causal))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashFn.apply(q, k, v, *args, entry)
    else:
        out, lse = _fwd(q, k, v, *args, with_lse, entry)
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, *, causal=False, scale=None, q_offset=0,
                    k_offset=0, with_lse=False):
    """Fused attention over (batch, heads, seq, head_dim) tensors.

    ``scale`` defaults to 1/sqrt(head_dim).  ``q_offset``/``k_offset`` are
    the global positions of row/column 0 for causal masking.  Returns the
    output in q's dtype; with ``with_lse=True`` also the per-row logsumexp
    of the scaled scores, (batch, heads, seq) float32.  Differentiable in
    q, k and v through out and lse.  A CPU tensor takes the plain
    versions; a CUDA tensor launches the kernels or raises."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention expects (B, H, S, D) inputs")
    return _attend(q, k, v, causal, scale, q_offset, k_offset, with_lse,
                   flash_attention)


def flash_attention_plain(q, k, v, *, causal=False, scale=None, q_offset=0,
                          k_offset=0, with_lse=False):
    """`flash_attention` through the plain versions on any device, gradient
    included: the reference that `chip_smoke.py` holds the kernels against
    on the card."""
    return _attend(q, k, v, causal, scale, q_offset, k_offset, with_lse,
                   None)


def _bsd_to_heads(t, num_heads):
    """The (B, H, S, D) view of a (B, S, E) tensor's heads: head h is
    columns h*D .. (h+1)*D of E.  A view, no copy."""
    b, s, e = t.shape
    return t.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset, with_lse,
         entry):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise MXNetError("flash_attention_bsd expects (B, S, E) inputs")
    b, s, e = q.shape
    if num_heads < 1 or e % num_heads != 0:
        raise MXNetError("flash_attention_bsd: embed dim %d not divisible by "
                         "num_heads %d" % (e, num_heads))
    out = _attend(*(_bsd_to_heads(t, num_heads) for t in (q, k, v)), causal,
                  scale, q_offset, k_offset, with_lse, entry)
    out, lse = out if with_lse else (out, None)
    out = out.transpose(1, 2).reshape(b, s, e)
    return (out, lse) if with_lse else out


def flash_attention_bsd(q, k, v, num_heads, *, causal=False, scale=None,
                        q_offset=0, k_offset=0, with_lse=False):
    """Fused attention over (batch, seq, embed) tensors with ``num_heads``
    heads on the embed axis: the same kernels as `flash_attention`, on the
    (B, H, S, D) view of each operand's heads.  Returns out (B, S, E) and,
    with ``with_lse=True``, lse (B, H, S) float32.  Head widths 64 and 128
    both reach the kernels (the JAX package's 128-lane gate is a TPU
    fact).  Its launches are counted on this function."""
    return _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset,
                with_lse, flash_attention_bsd)


def flash_attention_bsd_plain(q, k, v, num_heads, *, causal=False,
                              scale=None, q_offset=0, k_offset=0,
                              with_lse=False):
    """`flash_attention_bsd` through the plain versions on any device."""
    return _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset,
                with_lse, None)


# kernel launches since the counts were last set to 0 (CUDA path only), by
# the public entry that led to them: the forward, the dq pass and the
# dk/dv pass
for _entry in (flash_attention, flash_attention_bsd):
    _entry.launches = _entry.dq_launches = _entry.dkv_launches = 0
del _entry
