"""Fused projection + softmax cross-entropy head: CUDA kernels for the
card, plain versions beside them.

The loss of ``softmax(x @ W.T + b)`` at each token's label, and its
loss-head gradient, without the (tokens x vocab) logits ever reaching
device memory.  Replaces the five Pallas functions of
`mxnet_tpu/ops/pallas_kernels/fused_ce.py`; their math reduces to four
kernels (modes of one template on the tensor cores: `csrc/fused_ce_f32.cu`
in float32, through 3xTF32, `csrc/fused_ce_bf16.cu` in bfloat16):

* A, `fused_ce_fwd` — `_fwd_pallas` (`_fwd_kernel`): the online (m, l)
  and the picked logit a over vocabulary tiles; lse and nll = lse - a,
  zeroed on ignored rows.
* B, `fused_ce_fwd_sp` — `_fwd_sp_pallas` (`_fwd_sp_kernel`): the same
  statistics plus the rescaled f32 accumulator of exp(s - m) @ W, giving
  lse, a and the residual dxp = p @ W as (n, d) float32.
* C, `fused_ce_bwd_dw` — `_bwd_dw_rs_pallas` (`_bwd_dw_rs_kernel`) and
  `_bwd_pallas`'s `_bwd_dw_kernel`: dW = dl^T x and db = sum dl, with
  dl = (exp(s - lse) - onehot) * r recomputed per tile.
* D, `fused_ce_bwd_dx` — `_bwd_dx_rs_pallas` (`_bwd_dx_rs_kernel`) and
  `_bwd_pallas`'s `_bwd_dx_kernel`: dx = dl @ W.

The 5-pass backward (`_bwd_pallas`, row 12 of the kernel table) is
`fused_ce_bwd`: kernels D and C with the per-row coefficient r =
grad_scale * valid (`_valid_coef`).  The plain versions are the JAX
package's jnp twins in torch, tiling the vocabulary in a Python loop as
its `lax.scan`s do: `_fwd_plain` (`_fwd_jnp`), `_bwd_plain`
(`_bwd_jnp`), `_fwd_sp_plain` (`_fwd_sp_jnp`), `_bwd_dw_rs_plain` and
`_bwd_dx_rs_plain`.  Cast points are the Pallas kernels': logits and
bias in float32, p cast to W's dtype before p @ W, dl cast to x's dtype
before dl^T x and to W's before dl @ W, db from the float32 dl, dW and
db cast to W's dtype once.

Labels are int32 class ids.  A label < 0 or >= V matches no column: it
picks no logit, subtracts no onehot and no W row.  (The JAX functions
agree except for a label inside their last tile's padding, [V, V rounded
up to block_v), which picks the padding's -1e30 mask there and gives an
nll of ~1e30; the kernels' tiles are not the TPU's, so the port keeps
the rule that does not depend on a tile size.)

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises `MXNetError`: x, W and b of one dtype, any n, any V and any
d >= 1.  float32 runs `csrc/fused_ce_f32.cu` (d a multiple of 4, the
depth dealt out over a cluster of up to 8 blocks, past 1536 in windows);
bfloat16 runs `csrc/fused_ce_bf16.cu` (d a multiple of 8, the cluster's
depth up to 3072, past it in windows).
Any other d is zero-padded to the next multiple of the kernels' 16-byte
granule (4 float32 or 8 bfloat16 columns), counted on the wrapper's
``padded_calls``; the columns added contribute nothing to s and are cut
from dxp, dx and dW.  The kernels stream tiles of 32 (float32) or 64
(bf16) rows: a pinned ``block_n``/``block_v`` (`MXNET_CE_BLOCK_N`/`_V`,
or the op's parameters) retiles only the plain versions (``block_v``;
``block_n`` is kept for the JAX signature), and the TPU's cap of
``block_v`` at 1024 (its VMEM) does not apply.

`fused_softmax_ce` is the public entry, with the JAX package's
signature and loss-head contract: the backward ignores the incoming
cotangent and bakes ``grad_scale`` into dl.  ``MXNET_CE_SINGLE_PASS``
(default 1) picks the single-pass structure (`_FusedCESinglePass`:
kernel B forward, dx from its residual in plain torch, kernel C
backward) or the 5-pass one (`_FusedCEFivePass`: kernel A forward,
kernels D and C backward), read at each call as JAX reads it at each
trace.  Where no gradient is wanted it calls kernel A alone and saves
nothing, as JAX's primal forward does.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ...base import MXNetError
from . import _build

__all__ = ["fused_softmax_ce", "fused_softmax_ce_plain", "fused_ce_fwd",
           "fused_ce_fwd_sp", "fused_ce_bwd", "fused_ce_bwd_dw",
           "fused_ce_bwd_dx", "single_pass_enabled"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# each dtype's source and the suffix of its C entries
_SOURCES = {torch.float32: ("fused_ce_f32", "_f32"),
            torch.bfloat16: ("fused_ce_bf16", "_bf16")}


def single_pass_enabled():
    """MXNET_CE_SINGLE_PASS (default 1); `0` selects the 5-pass
    structure."""
    return os.environ.get("MXNET_CE_SINGLE_PASS", "1") != "0"


# -- plain versions: the jnp twins, tiled over the vocabulary ---------------


def _tiles(w, b, block_v):
    """W and b cut into ``num_j`` vocabulary tiles of ``block_v`` rows, the
    last padded with zeros (`_tiles`)."""
    v, d = w.shape
    block_v = min(block_v, v)
    pad_v = (-v) % block_v
    if pad_v:
        w = torch.cat([w, w.new_zeros((pad_v, d))])
        b = torch.cat([b, b.new_zeros((pad_v,))])
    num_j = (v + pad_v) // block_v
    return (w.reshape(num_j, block_v, d), b.reshape(num_j, block_v), num_j,
            block_v)


def _logit_tile(xf, w_j, b_j, j, block_v, v):
    """One (n, block_v) float32 logit tile, masked to -1e30 past V, and
    its column ids."""
    s = xf @ w_j.float().T + b_j.float()
    col = j * block_v + torch.arange(block_v, device=xf.device)
    return torch.where(col < v, s, _NEG_INF), col


def _onehot(col, label, v):
    """(n, block_v) bool: the label's column, for labels in [0, V) only."""
    return (col[None, :] == label[:, None]) & (col < v)[None, :]


def _fwd_plain(x, w, b, label, ignore_label, use_ignore, block_v):
    """`_fwd_jnp`: (nll, lse) float32 (n,), nll zeroed on ignored rows."""
    v = w.shape[0]
    wt, bt, num_j, block_v = _tiles(w, b, block_v)
    xf = x.float()
    lbl = label.long()
    m = torch.full((x.shape[0],), _NEG_INF, device=x.device)
    l = torch.zeros_like(m)
    a = torch.zeros_like(m)
    for j in range(num_j):
        s, col = _logit_tile(xf, wt[j], bt[j], j, block_v, v)
        a = a + torch.where(_onehot(col, lbl, v), s, 0.0).sum(dim=1)
        m_new = torch.maximum(m, s.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(1)
        m = m_new
    lse = m + torch.log(l)
    nll = lse - a
    if use_ignore:
        nll = torch.where(lbl != int(ignore_label), nll, 0.0)
    return nll, lse


def _valid_coef(label, grad_scale, ignore_label, use_ignore):
    """`_valid_coef`: the per-row gradient coefficient r and the validity
    mask, both float32 (n,)."""
    valid = torch.ones(label.shape, dtype=torch.float32, device=label.device)
    if use_ignore:
        valid = torch.where(label.long() != int(ignore_label), valid, 0.0)
    return grad_scale * valid, valid


def _bwd_plain(x, w, b, label, lse, grad_scale, ignore_label, use_ignore,
               block_v):
    """`_bwd_jnp`, the 5-pass backward: (dx in x's dtype, dW and db in W's
    dtype) from the forward's lse."""
    v, d = w.shape
    wt, bt, num_j, block_v = _tiles(w, b, block_v)
    xf = x.float()
    lbl = label.long()
    r, _ = _valid_coef(label, grad_scale, ignore_label, use_ignore)
    dx = torch.zeros_like(xf)
    dw, db = [], []
    for j in range(num_j):
        s, col = _logit_tile(xf, wt[j], bt[j], j, block_v, v)
        dl = (torch.exp(s - lse[:, None]) - _onehot(col, lbl, v).float()) \
            * r[:, None]
        dlc = dl.to(x.dtype).float()
        dx = dx + dlc @ wt[j].float()
        dw.append((dlc.T @ xf).to(w.dtype))
        db.append(dl.sum(dim=0))
    return (dx.to(x.dtype), torch.cat(dw)[:v],
            torch.cat(db)[:v].to(w.dtype))


def _fwd_sp_plain(x, w, b, label, block_v):
    """`_fwd_sp_jnp`: (lse, picked logit a, dxp = p @ W) with lse and a
    float32 (n,) and dxp float32 (n, d), in one sweep."""
    v = w.shape[0]
    wt, bt, num_j, block_v = _tiles(w, b, block_v)
    xf = x.float()
    lbl = label.long()
    m = torch.full((x.shape[0],), _NEG_INF, device=x.device)
    l = torch.zeros_like(m)
    a = torch.zeros_like(m)
    acc = torch.zeros_like(xf)
    for j in range(num_j):
        s, col = _logit_tile(xf, wt[j], bt[j], j, block_v, v)
        a = a + torch.where(_onehot(col, lbl, v), s, 0.0).sum(dim=1)
        m_new = torch.maximum(m, s.amax(dim=1))
        p = torch.exp(s - m_new[:, None])
        factor = torch.exp(m - m_new)
        l = l * factor + p.sum(dim=1)
        acc = acc * factor[:, None] + p.to(w.dtype).float() @ wt[j].float()
        m = m_new
    return m + torch.log(l), a, acc / l[:, None]


def _dl_rs(xf, w_j, b_j, j, block_v, v, lbl, lse, r):
    s, col = _logit_tile(xf, w_j, b_j, j, block_v, v)
    return (torch.exp(s - lse[:, None]) - _onehot(col, lbl, v).float()) \
        * r[:, None]


def _bwd_dw_rs_plain(x, w, b, label, lse, r, block_v):
    """`_bwd_dw_rs_jnp`: dW (V, d) and db (V,) in W's dtype, with dl scaled
    by the per-row coefficient r."""
    v = w.shape[0]
    wt, bt, num_j, block_v = _tiles(w, b, block_v)
    xf = x.float()
    lbl = label.long()
    dw, db = [], []
    for j in range(num_j):
        dl = _dl_rs(xf, wt[j], bt[j], j, block_v, v, lbl, lse, r)
        dw.append((dl.to(x.dtype).float().T @ xf).to(w.dtype))
        db.append(dl.sum(dim=0))
    return torch.cat(dw)[:v], torch.cat(db)[:v].to(w.dtype)


def _bwd_dx_rs_plain(x, w, b, label, lse, r, block_v):
    """`_bwd_dx_rs_jnp`: dx (n, d) in x's dtype, with dl scaled by r."""
    v = w.shape[0]
    wt, bt, num_j, block_v = _tiles(w, b, block_v)
    xf = x.float()
    lbl = label.long()
    dx = torch.zeros_like(xf)
    for j in range(num_j):
        dl = _dl_rs(xf, wt[j], bt[j], j, block_v, v, lbl, lse, r)
        dx = dx + dl.to(w.dtype).float() @ wt[j].float()
    return dx.to(x.dtype)


# -- the CUDA kernels ---------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int
# each C entry's arguments before the stream
_SIGNATURES = {"mxt_fused_ce_fwd": [_I] + [_P] * 6 + [_I] * 5,
               "mxt_fused_ce_fwd_sp": [_I] + [_P] * 7 + [_I] * 3,
               "mxt_fused_ce_bwd_dw": [_I] + [_P] * 8 + [_I] * 3,
               "mxt_fused_ce_bwd_dx": [_I] + [_P] * 7 + [_I] * 3}


def _lib(source):
    lib = _build.load(source)
    suffix = dict(_SOURCES.values())[source]
    if getattr(lib, "mxt_fused_ce_fwd" + suffix).argtypes is None:
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name + suffix)
            fn.argtypes = args + [_P]
            fn.restype = _I
    return lib


def _entry(dtype, name):
    """The C entry ``name`` of ``dtype``'s source: `fused_ce_f32.cu`'s
    ``name + '_f32'`` for float32, `fused_ce_bf16.cu`'s ``name + '_bf16'``
    for bfloat16."""
    source, suffix = _SOURCES[dtype]
    return getattr(_lib(source), name + suffix)


def _aligned(t):
    """``t`` contiguous, its data on a 16-byte boundary (the kernels load
    four elements at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda_args(x, w, b, label, what, rows=()):
    """What the CUDA kernels take; raises `MXNetError` on anything else
    before a launch.  ``rows`` are per-token float32 operands (lse, r).
    Returns the operands ready for the C entry (x and W zero-padded to the
    next multiple of 16 bytes a row where d needs it), labels as int32,
    and the number of columns added."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise MXNetError("%s: x must be (n, d) and W (V, d), got %s and %s"
                         % (what, tuple(x.shape), tuple(w.shape)))
    n, d = x.shape
    v = w.shape[0]
    if x.dtype not in _DTYPES:
        raise MXNetError("%s: CUDA kernel takes float32 or bfloat16, got %s"
                         % (what, x.dtype))
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise MXNetError("%s: W and b must be in x's dtype %s, got %s and %s"
                         % (what, x.dtype, w.dtype, b.dtype))
    if b.shape != (v,) or label.shape != (n,) or v < 1:
        raise MXNetError("%s: b must be (%d,) and label (%d,), got %s and %s"
                         % (what, v, n, tuple(b.shape), tuple(label.shape)))
    if d < 1:
        raise MXNetError("%s: the CUDA kernels take d >= 1 (zero-padded to "
                         "a positive multiple of 4 or 8), got %d" % (what, d))
    for t in rows:
        if t.shape != (n,) or t.dtype != torch.float32:
            raise MXNetError("%s: lse and r must be (%d,) float32, got %s %s"
                             % (what, n, tuple(t.shape), t.dtype))
    if label.is_floating_point() or label.dtype == torch.bool:
        raise MXNetError("%s: labels must be integer class ids, got %s"
                         % (what, label.dtype))
    if any(t.device != x.device for t in (w, b, label, *rows)):
        raise MXNetError("%s: every operand must be on x's device" % what)
    _build.check_current_device(x.device, what)
    pad = -d % (8 if x.dtype == torch.bfloat16 else 4)
    if pad:
        x, w = (torch.nn.functional.pad(t, (0, pad)) for t in (x, w))
    return ([_aligned(t) for t in (x, w, b)],
            _aligned(label.to(torch.int32)),
            [_aligned(t) for t in rows], pad)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_cuda(x, w, b, label, ignore_label, use_ignore):
    (x, w, b), lbl, _, pad = _check_cuda_args(x, w, b, label,
                                              "fused_ce_fwd")
    n, d = x.shape
    nll = torch.empty((n,), dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    err = _entry(x.dtype, "mxt_fused_ce_fwd")(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        lbl.data_ptr(), nll.data_ptr(), lse.data_ptr(), n, d, w.shape[0],
        int(ignore_label), int(bool(use_ignore)), _stream(x))
    _build.check(err, "fused_ce_fwd launch")
    fused_ce_fwd.launches += 1
    fused_ce_fwd.padded_calls += bool(pad)
    return nll, lse


def _fwd_sp_cuda(x, w, b, label):
    (x, w, b), lbl, _, pad = _check_cuda_args(x, w, b, label,
                                              "fused_ce_fwd_sp")
    n, d = x.shape
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    a = torch.empty_like(lse)
    dxp = torch.empty((n, d), dtype=torch.float32, device=x.device)
    err = _entry(x.dtype, "mxt_fused_ce_fwd_sp")(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        lbl.data_ptr(), lse.data_ptr(), a.data_ptr(), dxp.data_ptr(), n, d,
        w.shape[0], _stream(x))
    _build.check(err, "fused_ce_fwd_sp launch")
    fused_ce_fwd_sp.launches += 1
    fused_ce_fwd_sp.padded_calls += bool(pad)
    return lse, a, (dxp[:, :d - pad] if pad else dxp)


def _bwd_dw_cuda(x, w, b, label, lse, r):
    (x, w, b), lbl, (lse, r), pad = _check_cuda_args(
        x, w, b, label, "fused_ce_bwd_dw", (lse, r))
    n, d = x.shape
    dw = torch.empty_like(w)
    db = torch.empty_like(b)
    err = _entry(x.dtype, "mxt_fused_ce_bwd_dw")(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        lbl.data_ptr(), lse.data_ptr(), r.data_ptr(), dw.data_ptr(),
        db.data_ptr(), n, d, w.shape[0], _stream(x))
    _build.check(err, "fused_ce_bwd_dw launch")
    fused_ce_bwd_dw.launches += 1
    fused_ce_bwd_dw.padded_calls += bool(pad)
    return (dw[:, :d - pad].contiguous() if pad else dw), db


def _bwd_dx_cuda(x, w, b, label, lse, r):
    (x, w, b), lbl, (lse, r), pad = _check_cuda_args(
        x, w, b, label, "fused_ce_bwd_dx", (lse, r))
    n, d = x.shape
    dx = torch.empty_like(x)
    err = _entry(x.dtype, "mxt_fused_ce_bwd_dx")(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        lbl.data_ptr(), lse.data_ptr(), r.data_ptr(), dx.data_ptr(), n, d,
        w.shape[0], _stream(x))
    _build.check(err, "fused_ce_bwd_dx launch")
    fused_ce_bwd_dx.launches += 1
    fused_ce_bwd_dx.padded_calls += bool(pad)
    return dx[:, :d - pad].contiguous() if pad else dx


def _on(x, what):
    """True for a CPU tensor (the plain version), False for a CUDA one."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (what, x.device))
    return False


def fused_ce_fwd(x, w, b, label, ignore_label=-1.0, use_ignore=False,
                 block_n=512, block_v=2048):
    """Kernel A (`_fwd_pallas`): (nll, lse), float32 (n,)."""
    if _on(x, "fused_ce_fwd"):
        return _fwd_plain(x, w, b, label, ignore_label, use_ignore, block_v)
    return _fwd_cuda(x, w, b, label, ignore_label, use_ignore)


def fused_ce_fwd_sp(x, w, b, label, block_n=512, block_v=2048):
    """Kernel B (`_fwd_sp_pallas`): (lse, a, dxp), float32."""
    if _on(x, "fused_ce_fwd_sp"):
        return _fwd_sp_plain(x, w, b, label, block_v)
    return _fwd_sp_cuda(x, w, b, label)


def fused_ce_bwd_dw(x, w, b, label, lse, r, block_n=512, block_v=2048):
    """Kernel C (`_bwd_dw_rs_pallas`): (dW, db) in W's dtype."""
    if _on(x, "fused_ce_bwd_dw"):
        return _bwd_dw_rs_plain(x, w, b, label, lse, r, block_v)
    return _bwd_dw_cuda(x, w, b, label, lse, r)


def fused_ce_bwd_dx(x, w, b, label, lse, r, block_n=512, block_v=2048):
    """Kernel D (`_bwd_dx_rs_pallas`): dx in x's dtype."""
    if _on(x, "fused_ce_bwd_dx"):
        return _bwd_dx_rs_plain(x, w, b, label, lse, r, block_v)
    return _bwd_dx_cuda(x, w, b, label, lse, r)


def fused_ce_bwd(x, w, b, label, lse, grad_scale=1.0, ignore_label=-1.0,
                 use_ignore=False, block_n=512, block_v=2048):
    """The 5-pass backward (`_bwd_pallas`): (dx, dW, db).  On the card,
    kernels D and C with r = grad_scale * valid, each counted on its own
    wrapper; on the CPU, `_bwd_plain`."""
    if _on(x, "fused_ce_bwd"):
        return _bwd_plain(x, w, b, label, lse, grad_scale, ignore_label,
                          use_ignore, block_v)
    r, _ = _valid_coef(label, grad_scale, ignore_label, use_ignore)
    dx = fused_ce_bwd_dx(x, w, b, label, lse, r, block_n, block_v)
    dw, db = fused_ce_bwd_dw(x, w, b, label, lse, r, block_n, block_v)
    return dx, dw, db


# kernel launches since the counts were last set to 0 (CUDA path only),
# and the calls among them whose d was zero-padded to the 16-byte granule
for _fn in (fused_ce_fwd, fused_ce_fwd_sp, fused_ce_bwd_dw, fused_ce_bwd_dx):
    _fn.launches = 0
    _fn.padded_calls = 0
del _fn


# -- autograd: the two structures ---------------------------------------------


class _FusedCESinglePass(torch.autograd.Function):
    """`_fused_ce_sp_fwd_rule` / `_fused_ce_sp_bwd_rule`: kernel B, then
    dx = r * (dxp - W[label]) in plain torch, saved as the residual;
    the backward returns it with kernel C's dW and db."""

    @staticmethod
    def forward(ctx, x, w, b, label, grad_scale, ignore_label, use_ignore,
                block_n, block_v, plain):
        lbl = label.to(torch.int32)
        if plain:
            lse, a, dxp = _fwd_sp_plain(x, w, b, lbl, block_v)
        else:
            lse, a, dxp = fused_ce_fwd_sp(x, w, b, lbl, block_n, block_v)
        r, valid = _valid_coef(lbl, grad_scale, ignore_label, use_ignore)
        nll = torch.where(valid > 0, lse - a, 0.0)
        # the -onehot @ W term is a row gather; a label outside [0, V)
        # subtracts nothing
        v = w.shape[0]
        in_range = (lbl >= 0) & (lbl < v)
        wl = torch.where(in_range[:, None],
                         w[lbl.clamp(0, v - 1).long()].float(), 0.0)
        dx = (r[:, None] * (dxp - wl)).to(x.dtype)
        ctx.save_for_backward(x, w, b, lbl, lse, r, dx)
        ctx.args = (block_n, block_v, plain)
        return nll

    @staticmethod
    def backward(ctx, g):
        # loss-head contract: the incoming cotangent is ignored
        x, w, b, lbl, lse, r, dx = ctx.saved_tensors
        block_n, block_v, plain = ctx.args
        if plain:
            dw, db = _bwd_dw_rs_plain(x, w, b, lbl, lse, r, block_v)
        else:
            dw, db = fused_ce_bwd_dw(x, w, b, lbl, lse, r, block_n, block_v)
        return (dx, dw, db.to(b.dtype)) + (None,) * 7


class _FusedCEFivePass(torch.autograd.Function):
    """`_fused_ce_fwd_rule` / `_fused_ce_bwd_rule`: kernel A saves the lse;
    the backward recomputes the logit tiles in kernels D and C."""

    @staticmethod
    def forward(ctx, x, w, b, label, grad_scale, ignore_label, use_ignore,
                block_n, block_v, plain):
        lbl = label.to(torch.int32)
        if plain:
            nll, lse = _fwd_plain(x, w, b, lbl, ignore_label, use_ignore,
                                  block_v)
        else:
            nll, lse = fused_ce_fwd(x, w, b, lbl, ignore_label, use_ignore,
                                    block_n, block_v)
        ctx.save_for_backward(x, w, b, lbl, lse)
        ctx.args = (grad_scale, ignore_label, use_ignore, block_n, block_v,
                    plain)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, b, lbl, lse = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, block_n, block_v, plain = \
            ctx.args
        if plain:
            dx, dw, db = _bwd_plain(x, w, b, lbl, lse, grad_scale,
                                    ignore_label, use_ignore, block_v)
        else:
            dx, dw, db = fused_ce_bwd(x, w, b, lbl, lse, grad_scale,
                                      ignore_label, use_ignore, block_n,
                                      block_v)
        return (dx, dw, db.to(b.dtype)) + (None,) * 7


def _wants_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _fused_ce(x, weight, bias, label, grad_scale, ignore_label, use_ignore,
              block_n, block_v, plain):
    if x.dim() != 2 or weight.dim() != 2:
        raise ValueError("fused_softmax_ce expects 2-D x and weight")
    block_n = int(os.environ.get("MXNET_CE_BLOCK_N", block_n))
    block_v = int(os.environ.get("MXNET_CE_BLOCK_V", block_v))
    if bias is None:
        bias = weight.new_zeros((weight.shape[0],))
    if not _wants_grad(x, weight, bias):
        # the primal forward: statistics only, nothing saved
        lbl = label.to(torch.int32)
        if plain:
            nll, _ = _fwd_plain(x, weight, bias, lbl, ignore_label,
                                use_ignore, block_v)
        else:
            nll, _ = fused_ce_fwd(x, weight, bias, lbl, ignore_label,
                                  use_ignore, block_n, block_v)
        return nll
    fn = _FusedCESinglePass if single_pass_enabled() else _FusedCEFivePass
    return fn.apply(x, weight, bias, label, float(grad_scale),
                    float(ignore_label), bool(use_ignore), block_n, block_v,
                    plain)


def fused_softmax_ce(x, weight, bias, label, *, grad_scale=1.0,
                     ignore_label=-1.0, use_ignore=False, block_n=512,
                     block_v=2048):
    """Per-token CE loss of ``softmax(x @ weight.T + bias)`` against
    ``label``, without the logits.

    x: (tokens, features); weight: (vocab, features); bias: (vocab,) or
    None; label: (tokens,) class ids (float or int).  Returns float32
    (tokens,) negative log-likelihoods, zeroed where ``label ==
    ignore_label`` under ``use_ignore``.  ``grad_scale`` scales only the
    gradient.  The gradient is the loss-head rule dlogits = (softmax -
    onehot) * grad_scale with the incoming cotangent ignored
    (`softmax_output-inl.h`), through the kernels."""
    return _fused_ce(x, weight, bias, label, grad_scale, ignore_label,
                     use_ignore, block_n, block_v, False)


def fused_softmax_ce_plain(x, weight, bias, label, *, grad_scale=1.0,
                           ignore_label=-1.0, use_ignore=False, block_n=512,
                           block_v=2048):
    """`fused_softmax_ce` through the plain versions on any device,
    gradient included: the reference `chip_smoke.py` holds the kernels
    against on the card."""
    return _fused_ce(x, weight, bias, label, grad_scale, ignore_label,
                     use_ignore, block_n, block_v, True)
