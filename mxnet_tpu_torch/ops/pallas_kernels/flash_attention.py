"""Flash attention, forward and backward: CUDA kernels for the card, plain
versions beside them, and the router that picks a kernel route.

Replaces `mxnet_tpu/ops/pallas_kernels/flash_attention.py`
`_flash_fwd_pallas` (the TPU kernel `_fwd_kernel`, hsd layout) and
`_flash_bwd_pallas` (`_bwd_dq_kernel`, `_bwd_dkv_kernel`); their dS-layout
twins `_flash_fwd_pallas_ds` and `_flash_bwd_pallas_ds`; and, through
strides, the bsd families: the loop kernels `_flash_fwd_pallas_bsd` and
`_flash_bwd_pallas_bsd` and the grid-streamed `_flash_fwd_pallas_bsd_gs`
and `_flash_bwd_pallas_bsd_gs`.  The plain versions mirror `_flash_fwd_jnp`
(the online-softmax recurrence over K blocks) and `_flash_bwd` (the
recompute from the saved lse over K blocks).  The kernels run their sums
in float32: the forward and the dq pass take one block per (batch, head,
64-query tile) and cut the K loop at the causal diagonal; the dk/dv pass
takes one block per (batch, head, 64-key tile) and starts its Q loop at
the first query tile that reaches it.  `csrc/flash_attention.cu` holds
the forward and the float32 backward (CUDA cores);
`csrc/flash_attention_bwd.cu` the bfloat16 backward on the tensor cores
(`wgmma`, p and ds rounded to bf16 where the Pallas kernels round
them).  Each source's note gives the H100 bound and what the design does
about it.

Operands are (B, H, S, D) in float32 or bfloat16.  The kernels take D in
{64, 128} and raise on others; they read and write through the batch,
head and sequence strides, so a transposed view costs no copy, but the
last axis must be contiguous.  The bf16 backward copies 16-byte rows, so
its operands must also be 16-byte aligned with strides that are multiples
of 8 elements (it raises on others; the out cotangent is copied).
Outputs and gradients are allocated with q's (k's, v's) strides
(``empty_like``) where those are aligned, so the transposes around them
are free too; the 'ds' route's copies and outputs pad the storage of
their sequence axis to a multiple of 16 bytes.  `flash_attention_bsd`
takes (B, S, E) operands and hands the (B, H, S, D) view of their heads
to the same kernels: no copy.

Routes.  Each call resolves its route from the environment, read at
every call as the JAX package reads it at every trace, and counts its
launches on that route's own counters:

* ``hsd`` (`flash_attention`'s default): the kernels on (B, H, S, D)
  operands; counters ``flash_attention.launches``, ``.dq_launches``,
  ``.dkv_launches``.
* ``ds`` (``MXNET_FLASH_LAYOUT=ds`` or ``MXNET_FLASH_IMPL=pallas_ds``):
  the JAX function's boundary swap, then the kernels' S-contiguous
  orientation.  q, k and v are copied to contiguous (B, H, D, S); the
  forward writes out in that layout and returns its transposed view; the
  residuals stay in dS layout, as `_flash_fwd_rule` keeps them; the
  backward takes the out cotangent to dS layout and returns the
  gradients as (B, H, S, D) views.  Counters ``.ds_launches``,
  ``.ds_dq_launches``, ``.ds_dkv_launches``.
* ``bsd_loop`` (`flash_attention_bsd`'s default at every length): the
  kernels on the (B, H, S, D) view of (B, S, E) heads; counters
  ``flash_attention_bsd.launches``, ``.dq_launches``, ``.dkv_launches``.
* ``bsd_stream`` (``MXNET_FLASH_BSD_KERNEL=stream``): the same kernels,
  counted on ``flash_attention_bsd.stream_launches``,
  ``.stream_dq_launches``, ``.stream_dkv_launches``.  On the TPU the
  grid-streamed structure exists because the loop kernels hold a head's
  whole K/V (or Q/dO) in VMEM under a ~12 MB model, which S=8192 at head
  128 in bf16 exceeds; it computes the loop kernels' function (the two
  TPU families even cast ds and p to the input dtype at the same
  points).  The CUDA kernels have no such cap (they stream 64-key and
  64-query tiles through shared memory at every length), so they are
  that route's counterpart as well.
* ``jnp`` (``MXNET_FLASH_IMPL=jnp``): the plain versions, asked for by
  name; no kernel runs.  ``MXNET_FLASH_BWD=jnp`` takes the plain backward
  after a kernel route's forward.

An unrecognized ``MXNET_FLASH_BSD_KERNEL`` raises `MXNetError`, as in
the JAX package.  Two JAX gates are TPU facts and are not ported: the
whole-K/V VMEM model `_stream_residency_fits` (unpinned, bsd is
``bsd_loop`` at every length) and the 512 x 512 size gate to the jnp
path.  ``MXNET_FLASH_BLOCK_K`` and the ``block_k`` argument set the plain
versions' K block; the plain versions have no Q block, so there is no
``block_q`` (``MXNET_FLASH_BLOCK_Q`` is not read), and the kernels keep
their 64-position tiles.

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
import os

import torch

from ...base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bsd",
           "flash_attention_bsd_plain"]

_NEG_INF = -1e30
_BLOCK_K = 256  # the plain versions' default K block: the JAX one on the CPU
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _flash_fwd_plain(q, k, v, q_off, k_off, scale, causal,
                     block_k=_BLOCK_K):
    """The plain version: `_flash_fwd_jnp`'s recurrence over K blocks of
    ``block_k`` keys, with masked scores contributing an exact 0.
    Returns (out in q's dtype, lse float32)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    block_k = max(1, min(block_k, skv))
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


def _delta(o, g, glse, dim=3):
    """delta_i = sum_d dO_id O_id - glse_i, float32 (B, H, Sq); ``dim`` is
    the head_dim axis (2 in dS layout)."""
    delta = (g.float() * o).sum(dim=dim)
    return delta if glse is None else delta - glse.float()


def _flash_bwd_plain(q, k, v, o, lse, g, glse, q_off, k_off, scale, causal,
                     block_k=_BLOCK_K):
    """The plain backward: `_flash_bwd`'s recompute over K blocks of
    ``block_k`` keys, with p exactly 0 wherever the mask hides a key (so a
    row that sees no key gets a zero gradient).  ``glse`` may be None (no
    lse cotangent).  Returns (dq, dk, dv) in the inputs' dtypes."""
    sq, skv = q.shape[2], k.shape[2]
    block_k = max(1, min(block_k, skv))
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


# -- the router ---------------------------------------------------------------


def _hsd_route():
    """`flash_attention`'s route: `_pick_impl`'s pins, without its TPU
    gates."""
    forced = os.environ.get("MXNET_FLASH_IMPL")
    if forced == "jnp":
        return "jnp"
    if forced in ("pallas_ds", "pallas_hsd"):
        return forced[len("pallas_"):]
    if os.environ.get("MXNET_FLASH_LAYOUT", "hsd") == "ds":
        return "ds"
    return "hsd"


def _bsd_structure():
    """`_bsd_structure`'s pin: 'loop' or 'stream'; unset (or 'auto') is
    'loop' at every length, the VMEM model being a TPU fact."""
    raw = os.environ.get("MXNET_FLASH_BSD_KERNEL")
    if raw in ("loop", "stream"):
        return raw
    if raw not in (None, "", "auto"):
        raise MXNetError(
            "MXNET_FLASH_BSD_KERNEL must be 'loop', 'stream' or "
            "unset/'auto', got %r" % raw)
    return "loop"


def _bsd_route():
    """`flash_attention_bsd`'s route: the plain versions under
    ``MXNET_FLASH_IMPL=jnp``, else the pinned (or loop) structure."""
    if os.environ.get("MXNET_FLASH_IMPL") == "jnp":
        return "jnp"
    return "bsd_" + _bsd_structure()


def _plain_block(block_k):
    """The plain versions' K block: ``MXNET_FLASH_BLOCK_K`` over the
    caller's ``block_k``; `_BLOCK_K` where neither is positive."""
    raw = os.environ.get("MXNET_FLASH_BLOCK_K")
    if raw is not None:
        try:
            block_k = int(raw)
        except ValueError:
            raise MXNetError("MXNET_FLASH_BLOCK_K must be an integer, got %r"
                             % raw) from None
    return int(block_k) if int(block_k) > 0 else _BLOCK_K


def _count(route, kind):
    fn, prefix = _COUNTERS[route]
    name = prefix + kind
    setattr(fn, name, getattr(fn, name) + 1)


# -- the CUDA kernels ---------------------------------------------------------


# the backward's C entry for each dtype: (source, function), both with
# `mxt_flash_attention_bwd`'s argument list
_BWD_ENTRIES = {
    torch.float32: ("flash_attention", "mxt_flash_attention_bwd"),
    torch.bfloat16: ("flash_attention_bwd", "mxt_flash_attention_bwd_bf16")}


def _lib(name="flash_attention"):
    """The loaded library of source ``name``, its entries typed."""
    lib = _build.load(name)
    bwd = getattr(lib, dict(_BWD_ENTRIES.values())[name])
    if bwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        bwd.argtypes = ([i, i, i, i] + [p] * 8 + [i, i, i, i] + [ll] * 18
                        + [i, i, i, ctypes.c_float, p])
        bwd.restype = i
        if name == "flash_attention":
            fwd = lib.mxt_flash_attention_fwd
            fwd.argtypes = ([i, i, i, p, p, p, p, p, i, i, i, i] + [ll] * 12
                            + [i, i, i, ctypes.c_float, p])
            fwd.restype = i
    return lib


def _dims(q, k, ds):
    """(batch, heads, Sq, Skv, head_dim) of (B, H, S, D) operands or, with
    ``ds``, of (B, H, D, S) ones."""
    if ds:
        return q.shape[0], q.shape[1], q.shape[3], k.shape[3], q.shape[2]
    return q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]


def _check_cuda_args(q, k, v, ds=False):
    """What the CUDA kernels take; raises `MXNetError` on anything else.
    ``ds``: operands in dS layout (B, H, D, S)."""
    b, h, _, _, d = _dims(q, k, ds)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention: CUDA kernel takes q, k, v all "
                         "float32 or all bfloat16, got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if d not in _HEAD_DIMS:
        raise MXNetError("flash_attention: CUDA kernel takes head_dim in %s, "
                         "got %d" % (_HEAD_DIMS, d))
    d_axis = 2 if ds else 3
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[d_axis] != d:
        raise MXNetError("flash_attention: k and v must be (%d, %d, %s),"
                         " got %s and %s" % (
                             b, h, "%d, Skv" % d if ds else "Skv, %d" % d,
                             tuple(k.shape), tuple(v.shape)))
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise MXNetError("flash_attention: the %s axis of q, k and v must be "
                         "contiguous" % ("sequence" if ds else "head_dim"))
    if b > 65535 or h > 65535:
        raise MXNetError("flash_attention: batch and heads must be <= 65535")
    if k.device != q.device or v.device != q.device:
        raise MXNetError("flash_attention: q, k and v must share a device")
    _build.check_current_device(q.device, "flash_attention")


def _aligned(t):
    """Whether the bf16 backward can copy t's rows: 16-byte aligned, the
    batch, head and third strides multiples of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def _empty_aligned(shape, dtype, device):
    """An empty 4-D tensor whose last axis is contiguous and whose storage
    pads that axis to a multiple of 16 bytes, so `_aligned` holds."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    padded = -(-shape[3] // per) * per
    return torch.empty((*shape[:3], padded), dtype=dtype,
                       device=device)[..., :shape[3]]


def _like(t):
    """An empty tensor shaped as t, with t's strides where its last axis is
    contiguous and they are aligned (so a transposed view's gradient is the
    same view), else `_empty_aligned`."""
    out = torch.empty_like(t)
    if out.stride(3) != 1 or not _aligned(out):
        out = _empty_aligned(t.shape, t.dtype, t.device)
    return out


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _flash_fwd_cuda(q, k, v, q_off, k_off, scale, causal, with_lse, route):
    """The forward kernel on ``route``'s layout: (B, H, S, D) operands, or
    (B, H, D, S) ones on 'ds' (out in the same layout)."""
    ds = route == "ds"
    _check_cuda_args(q, k, v, ds)
    b, h, sq, skv, d = _dims(q, k, ds)
    out = _like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    err = _lib().mxt_flash_attention_fwd(
        _DTYPES[q.dtype], d, int(ds), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, sq, skv,
        *_strides(q, k, v, out), q_off, k_off, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention launch")
    _count(route, "launches")
    return out, lse


def _flash_bwd_cuda(q, k, v, o, lse, g, glse, q_off, k_off, scale, causal,
                    route):
    """The dq and dk/dv kernels on ``route``'s layout: every operand and
    gradient, ``g`` included, in (B, H, D, S) on 'ds'."""
    ds = route == "ds"
    _check_cuda_args(q, k, v, ds)
    b, h, sq, skv, d = _dims(q, k, ds)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise MXNetError("flash_attention backward: the out cotangent must "
                         "be %s %s, got %s %s" % (tuple(q.shape), q.dtype,
                                                  tuple(g.shape), g.dtype))
    if q.dtype == torch.bfloat16 and not all(
            _aligned(t) for t in (q, k, v)):
        raise MXNetError("flash_attention backward: the bf16 kernels copy "
                         "16-byte rows, so q, k and v must be 16-byte "
                         "aligned with batch, head and %s strides that are "
                         "multiples of 8 elements, got strides %s %s %s"
                         % ("head_dim" if ds else "sequence", q.stride(),
                            k.stride(), v.stride()))
    if g.stride(3) != 1 or not _aligned(g):
        g = _like(g).copy_(g)
    delta = _delta(o, g, glse, 2 if ds else 3).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = _like(q), _like(k), _like(v)
    source, entry = _BWD_ENTRIES[q.dtype]
    launch = getattr(_lib(source), entry)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (_DTYPES[q.dtype], d, int(ds), q.data_ptr(), k.data_ptr(),
              v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (q_off, k_off, int(causal), float(scale), stream)
    err = launch(0, *common, dq.data_ptr(), None, b, h, sq, skv,
                 *_strides(q, k, v, g, dq, dq), *tail)
    _build.check(err, "flash_attention dq launch")
    _count(route, "dq_launches")
    err = launch(1, *common, dk.data_ptr(), dv.data_ptr(), b, h, sq, skv,
                 *_strides(q, k, v, g, dk, dv), *tail)
    _build.check(err, "flash_attention dk/dv launch")
    _count(route, "dkv_launches")
    return dq, dk, dv


# -- the two passes on a route ------------------------------------------------


def _device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention: unsupported device %s" % q.device)
    return q.device.type


def _plain(q, route):
    """Whether the plain versions run: on the CPU, or asked for by name."""
    return _device(q) == "cpu" or route == "jnp"


def _to_ds(t):
    """The (B, H, D, S) copy of a (B, H, S, D) tensor, the JAX function's
    boundary swap: S contiguous, its storage padded to a multiple of 16
    bytes (`_empty_aligned`)."""
    b, h, s, d = t.shape
    return _empty_aligned((b, h, d, s), t.dtype, t.device).copy_(
        t.transpose(2, 3))


def _forward(q, k, v, args, with_lse, route, block):
    """The forward of (B, H, S, D) operands on ``route``: the kernel on the
    card, the plain version on the CPU or on 'jnp'.  Returns (out, lse,
    residuals (q, k, v, out)); on 'ds' the residuals are (B, H, D, S) and
    out is the transposed view of the residual out."""
    ds = route == "ds"
    if ds:
        q, k, v = (_to_ds(t) for t in (q, k, v))
    if _plain(q, route):
        if ds:
            o, lse = _flash_fwd_plain(*(t.transpose(2, 3) for t in (q, k, v)),
                                      *args, block)
            o = o.transpose(2, 3)
        else:
            o, lse = _flash_fwd_plain(q, k, v, *args, block)
    else:
        o, lse = _flash_fwd_cuda(q, k, v, *args, with_lse, route)
    return (o.transpose(2, 3) if ds else o), lse, (q, k, v, o)


def _backward(res, lse, g, glse, args, route, block):
    """dq, dk, dv in (B, H, S, D) from `_forward`'s residuals and the out
    cotangent ``g`` (B, H, S, D): the kernels on the card, the plain
    backward on the CPU, on 'jnp' or under ``MXNET_FLASH_BWD=jnp``."""
    q, k, v, o = res
    ds = route == "ds"
    if _plain(q, route) or os.environ.get("MXNET_FLASH_BWD",
                                          "pallas") == "jnp":
        if ds:
            q, k, v, o = (t.transpose(2, 3) for t in res)
        return _flash_bwd_plain(q, k, v, o, lse, g, glse, *args, block)
    if ds:
        grads = _flash_bwd_cuda(q, k, v, o, lse, _to_ds(g), glse, *args,
                                route)
        return tuple(t.transpose(2, 3) for t in grads)
    return _flash_bwd_cuda(q, k, v, o, lse, g, glse, *args, route)


class _FlashFn(torch.autograd.Function):
    """Attention over (out, lse) with the backward of `_flash_bwd_pallas`
    (`_flash_bwd_pallas_ds` on 'ds'): dq, dk, dv from the two backward
    passes; no gradient for the offsets.  ``route`` is the route resolved
    for this call, ``block`` the plain versions' K block."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, scale, causal, route, block):
        args = (q_off, k_off, scale, causal)
        out, lse, res = _forward(q, k, v, args, True, route, block)
        ctx.save_for_backward(*res, lse)
        ctx.args, ctx.route, ctx.block = args, route, block
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, glse):
        *res, lse = ctx.saved_tensors
        if g is None:
            o = res[3]
            g = torch.zeros_like(o.transpose(2, 3) if ctx.route == "ds"
                                 else o)
        grads = _backward(res, lse, g, glse, ctx.args, ctx.route, ctx.block)
        return tuple(grads) + (None,) * 6


def _offset(x, what):
    if int(x) != x:
        raise MXNetError("flash_attention: %s must be a whole number, got %r"
                         % (what, x))
    if not -2 ** 31 <= int(x) < 2 ** 31:
        raise MXNetError("flash_attention: %s must fit in 32 bits, got %r"
                         % (what, x))
    return int(x)


def _attend(q, k, v, causal, scale, q_offset, k_offset, with_lse, route,
            block_k):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    args = (_offset(q_offset, "q_offset"), _offset(k_offset, "k_offset"),
            float(scale), bool(causal))
    block = _plain_block(block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashFn.apply(q, k, v, *args, route, block)
    else:
        out, lse, _ = _forward(q, k, v, args, with_lse, route, block)
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, *, causal=False, scale=None, q_offset=0,
                    k_offset=0, block_k=0, with_lse=False):
    """Fused attention over (batch, heads, seq, head_dim) tensors.

    ``scale`` defaults to 1/sqrt(head_dim).  ``q_offset``/``k_offset`` are
    the global positions of row/column 0 for causal masking.  Returns the
    output in q's dtype; with ``with_lse=True`` also the per-row logsumexp
    of the scaled scores, (batch, heads, seq) float32.  Differentiable in
    q, k and v through out and lse.  The route ('hsd', 'ds' or 'jnp') is
    read from the environment (see the module's note); ``block_k`` is the
    plain versions' K block.  A CPU tensor takes the plain versions; a
    CUDA tensor launches the kernels or raises."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention expects (B, H, S, D) inputs")
    return _attend(q, k, v, causal, scale, q_offset, k_offset, with_lse,
                   _hsd_route(), block_k)


def flash_attention_plain(q, k, v, *, causal=False, scale=None, q_offset=0,
                          k_offset=0, block_k=0, with_lse=False):
    """`flash_attention` through the plain versions on any device, gradient
    included: the reference that `chip_smoke.py` holds the kernels against
    on the card."""
    return _attend(q, k, v, causal, scale, q_offset, k_offset, with_lse,
                   "jnp", block_k)


def _bsd_to_heads(t, num_heads):
    """The (B, H, S, D) view of a (B, S, E) tensor's heads: head h is
    columns h*D .. (h+1)*D of E.  A view, no copy."""
    b, s, e = t.shape
    return t.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset, with_lse,
         route, block_k):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise MXNetError("flash_attention_bsd expects (B, S, E) inputs")
    b, s, e = q.shape
    if num_heads < 1 or e % num_heads != 0:
        raise MXNetError("flash_attention_bsd: embed dim %d not divisible by "
                         "num_heads %d" % (e, num_heads))
    out = _attend(*(_bsd_to_heads(t, num_heads) for t in (q, k, v)), causal,
                  scale, q_offset, k_offset, with_lse, route, block_k)
    out, lse = out if with_lse else (out, None)
    out = out.transpose(1, 2).reshape(b, s, e)
    return (out, lse) if with_lse else out


def flash_attention_bsd(q, k, v, num_heads, *, causal=False, scale=None,
                        q_offset=0, k_offset=0, block_k=0, with_lse=False):
    """Fused attention over (batch, seq, embed) tensors with ``num_heads``
    heads on the embed axis: the same kernels as `flash_attention`, on the
    (B, H, S, D) view of each operand's heads.  Returns out (B, S, E) and,
    with ``with_lse=True``, lse (B, H, S) float32.  Head widths 64 and 128
    both reach the kernels (the JAX package's 128-lane gate is a TPU
    fact).  The route ('bsd_loop', 'bsd_stream' or 'jnp') is read from the
    environment and its launches are counted on this function (see the
    module's note)."""
    return _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset,
                with_lse, _bsd_route(), block_k)


def flash_attention_bsd_plain(q, k, v, num_heads, *, causal=False,
                              scale=None, q_offset=0, k_offset=0, block_k=0,
                              with_lse=False):
    """`flash_attention_bsd` through the plain versions on any device."""
    return _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset,
                with_lse, "jnp", block_k)


# each route's launch counters: (public function, prefix of its counters).
# A counter counts the kernel launches since it was last set to 0 (CUDA
# path only): the forward, the dq pass and the dk/dv pass.
_COUNTERS = {"hsd": (flash_attention, ""), "ds": (flash_attention, "ds_"),
             "bsd_loop": (flash_attention_bsd, ""),
             "bsd_stream": (flash_attention_bsd, "stream_")}
for _fn, _prefix in _COUNTERS.values():
    for _kind in ("launches", "dq_launches", "dkv_launches"):
        setattr(_fn, _prefix + _kind, 0)
del _fn, _prefix, _kind
