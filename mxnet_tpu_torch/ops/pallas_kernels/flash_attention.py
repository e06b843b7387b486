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
query tile: 64 queries, 128 in the float32 forward) and cut the K loop
at the causal diagonal; the dk/dv pass takes one block per (batch, head,
64-key tile) and starts its Q loop at the first query tile that reaches
it.  Every kernel runs on the tensor
cores (`wgmma`): `csrc/flash_attention_fwd.cu` and
`csrc/flash_attention_bwd.cu` the bfloat16 forward and backward (p and ds
rounded to bf16 where the mma takes them);
`csrc/flash_attention_fwd_f32.cu` and `csrc/flash_attention_bwd_f32.cu`
the float32 forward and backward through 3xTF32 (each operand split into
two TF32 terms, three products a product).  Each source's note gives the
H100 bound and what the design does about it.

Operands are (B, H, S, D) in float32 or bfloat16.  The kernels take D in
{64, 128}; they read and write through the batch, head and sequence
strides, so a transposed view costs no copy.  The kernels copy 16-byte
rows, so an operand whose last axis is not contiguous, or that is not
16-byte aligned with strides that are multiples of 16 bytes, is copied
first, in both dtypes (`_readable`; the out cotangent too).  The kernels
put heads on the grid's y and batch on its z, at most 65535 each: a
larger batch is launched in chunks of 65535 (past 65535 heads, each
batch index's heads in such chunks), each at its pointers' offset and
each counted as a launch.
Outputs and gradients are allocated with q's (k's, v's) strides
(``empty_like``) where those are aligned, so the transposes around them
are free too; the 'ds' route's copies and outputs pad the storage of
their sequence axis to a multiple of 16 bytes.  `flash_attention_bsd`
takes (B, S, E) operands and hands the (B, H, S, D) view of their heads
to the same kernels: no copy.

Head widths.  On a kernel route, a head_dim of 32 to 127 other than 64 is
zero-padded along D to 64 or 128 before the kernels and the result sliced
back (scale from the true head_dim): the padded columns add exact zeros
to every score and give zero output and gradient columns, so the result
is the unpadded function.  Such calls count on the route's
``padded_calls``.  A head_dim below 32 takes the plain versions, as the
JAX package's `_use_pallas` sends it to its jnp path, counted on the
route's ``narrow_calls``; above 128 the kernel routes raise `MXNetError`.

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
  points).  The CUDA kernels have no such cap (they stream key and
  query tiles through shared memory at every length), so they are
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
_HEAD_DIMS = (64, 128)  # the kernels' widths; narrower heads are padded
_MIN_KERNEL_D = 32      # narrower heads take the plain versions


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


# the forward's and the backward's C entry for each dtype: (source,
# function), with `mxt_flash_attention_fwd_bf16`'s and
# `mxt_flash_attention_bwd_bf16`'s argument lists
_FWD_ENTRIES = {
    torch.float32: ("flash_attention_fwd_f32", "mxt_flash_attention_fwd_f32"),
    torch.bfloat16: ("flash_attention_fwd", "mxt_flash_attention_fwd_bf16")}
_BWD_ENTRIES = {
    torch.float32: ("flash_attention_bwd_f32", "mxt_flash_attention_bwd_f32"),
    torch.bfloat16: ("flash_attention_bwd", "mxt_flash_attention_bwd_bf16")}


def _lib(name):
    """The loaded library of source ``name``, its entries typed."""
    lib = _build.load(name)
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    argtypes = (
        (_FWD_ENTRIES, [i, i, i] + [p] * 5 + [i] * 4 + [ll] * 12
         + [i, i, i, f, p]),
        (_BWD_ENTRIES, [i] * 4 + [p] * 8 + [i] * 4 + [ll] * 18
         + [i, i, i, f, p]))
    for entries, types in argtypes:
        for source, entry in entries.values():
            fn = getattr(lib, entry) if source == name else None
            if fn is not None and fn.argtypes is None:
                fn.argtypes, fn.restype = types, i
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
    if k.device != q.device or v.device != q.device:
        raise MXNetError("flash_attention: q, k and v must share a device")
    _build.check_current_device(q.device, "flash_attention")


def _aligned(t):
    """Whether the tensor-core kernels can copy t's rows: 16-byte aligned,
    the batch, head and third strides multiples of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def _readable(t):
    """``t`` itself where the kernels can read it in place (last axis
    contiguous, `_aligned`), else a copy they can (`_like`)."""
    return t if t.stride(3) == 1 and _aligned(t) else _like(t).copy_(t)


# the kernels put heads on the grid's y and batch on its z
_GRID_MAX = 65535


def _grid_chunks(b, h):
    """The launches that cover (batch b, heads h) within the grid's 65535:
    (first batch, batches, first head, heads) each; one launch up to
    65535 of both, chunks of 65535 batches past that, and past 65535
    heads each batch index's heads in chunks of 65535."""
    if h <= _GRID_MAX:
        return [(b0, min(_GRID_MAX, b - b0), 0, h)
                for b0 in range(0, max(b, 1), _GRID_MAX)]
    return [(b0, 1, h0, min(_GRID_MAX, h - h0))
            for b0 in range(b) for h0 in range(0, h, _GRID_MAX)]


def _at(t, b0, h0, heads=None):
    """The address of t[b0, h0]: a 4-D operand through its strides, or, with
    ``heads``, a contiguous (B, heads, S) float32 row statistic."""
    if t is None:
        return None
    if heads is not None:
        return t.data_ptr() + (b0 * heads + h0) * t.shape[-1] * 4
    return t.data_ptr() + (b0 * t.stride(0) + h0 * t.stride(1)) * \
        t.element_size()


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
    q, k, v = (_readable(t) for t in (q, k, v))
    b, h, sq, skv, d = _dims(q, k, ds)
    out = _like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    source, entry = _FWD_ENTRIES[q.dtype]
    launch = getattr(_lib(source), entry)
    strides = _strides(q, k, v, out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for b0, nb, h0, nh in _grid_chunks(b, h):
        err = launch(
            _DTYPES[q.dtype], d, int(ds), *(_at(t, b0, h0)
                                            for t in (q, k, v, out)),
            _at(lse, b0, h0, h), nb, nh, sq, skv, *strides, q_off, k_off,
            int(causal), float(scale), stream)
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
    # as in the forward, an operand the kernels cannot read in place is
    # copied, the out cotangent too
    q, k, v, g = (_readable(t) for t in (q, k, v, g))
    delta = _delta(o, g, glse, 2 if ds else 3).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = _like(q), _like(k), _like(v)
    source, entry = _BWD_ENTRIES[q.dtype]
    launch = getattr(_lib(source), entry)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (q_off, k_off, int(causal), float(scale), stream)
    passes = ((0, dq, None, "dq"), (1, dk, dv, "dk/dv"))
    for which, out0, out1, what in passes:
        strides = _strides(q, k, v, g, out0, out0 if out1 is None else out1)
        for b0, nb, h0, nh in _grid_chunks(b, h):
            err = launch(
                which, _DTYPES[q.dtype], d, int(ds),
                *(_at(t, b0, h0) for t in (q, k, v, g)),
                _at(lse, b0, h0, h), _at(delta, b0, h0, h),
                _at(out0, b0, h0), _at(out1, b0, h0), nb, nh, sq, skv,
                *strides, *tail)
            _build.check(err, "flash_attention %s launch" % what)
            _count(route, "dq_launches" if which == 0 else "dkv_launches")
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


def _kernel_width(d, route):
    """The head width the kernels run for head_dim ``d`` on kernel route
    ``route``: 64 or 128, counting a padded call on the route's
    ``padded_calls``; None below `_MIN_KERNEL_D`, counting the call on
    ``narrow_calls`` (the plain versions run).  Raises above 128."""
    if d in _HEAD_DIMS:
        return d
    if d > _HEAD_DIMS[-1]:
        raise MXNetError("flash_attention: the CUDA kernels take head_dim up "
                         "to %d (%d and %d natively, %d to %d zero-padded, "
                         "below %d the plain versions), got %d"
                         % (_HEAD_DIMS[-1], *_HEAD_DIMS, _MIN_KERNEL_D,
                            _HEAD_DIMS[-1] - 1, _MIN_KERNEL_D, d))
    if d < _MIN_KERNEL_D:
        _count(route, "narrow_calls")
        return None
    _count(route, "padded_calls")
    return next(w for w in _HEAD_DIMS if w > d)


def _attend(q, k, v, causal, scale, q_offset, k_offset, with_lse, route,
            block_k):
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    args = (_offset(q_offset, "q_offset"), _offset(k_offset, "k_offset"),
            float(scale), bool(causal))
    block = _plain_block(block_k)
    width = d
    if not _plain(q, route) and d not in _HEAD_DIMS:
        width = _kernel_width(d, route)
        if width is None:
            route, width = "jnp", d
        elif k.shape[-1] == d and v.shape[-1] == d:
            q, k, v = (torch.nn.functional.pad(t, (0, width - d))
                       for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashFn.apply(q, k, v, *args, route, block)
    else:
        out, lse, _ = _forward(q, k, v, args, with_lse, route, block)
    if width != d:
        out = out[..., :d]
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
    with ``with_lse=True``, lse (B, H, S) float32.  Every head width of
    32 to 128 reaches the kernels, padded where it is not 64 or 128 (the
    JAX package's 128-lane gate is a TPU fact).  The route ('bsd_loop',
    'bsd_stream' or 'jnp') is read from the environment and its launches
    are counted on this function (see the module's note)."""
    return _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset,
                with_lse, _bsd_route(), block_k)


def flash_attention_bsd_plain(q, k, v, num_heads, *, causal=False,
                              scale=None, q_offset=0, k_offset=0, block_k=0,
                              with_lse=False):
    """`flash_attention_bsd` through the plain versions on any device."""
    return _bsd(q, k, v, num_heads, causal, scale, q_offset, k_offset,
                with_lse, "jnp", block_k)


# each route's launch counters: (public function, prefix of its counters).
# A counter counts, since it was last set to 0 (CUDA path only), the
# kernel launches of the forward, the dq pass and the dk/dv pass, and the
# calls whose head width was padded or sent to the plain versions.
_COUNTERS = {"hsd": (flash_attention, ""), "ds": (flash_attention, "ds_"),
             "bsd_loop": (flash_attention_bsd, ""),
             "bsd_stream": (flash_attention_bsd, "stream_")}
for _fn, _prefix in _COUNTERS.values():
    for _kind in ("launches", "dq_launches", "dkv_launches", "padded_calls",
                  "narrow_calls"):
        setattr(_fn, _prefix + _kind, 0)
del _fn, _prefix, _kind
