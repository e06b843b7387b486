"""The float32 flash-attention forward on the tensor cores, on the CPU.

`mxnet_tpu_torch/csrc/flash_attention_fwd_f32.cu` runs only on the card,
where `chip_smoke.py` holds it against the plain float32 forward.  What
the CPU can pin:

* The arithmetic.  The kernel computes both of the forward's products in
  3xTF32 (every operand split into a TF32 hi and lo, the product taken as
  hi hi + hi lo + lo hi; `_tc` of test_torch_flash_bwd_f32.py models the
  tensor cores' adds, rounded toward zero).  S = Q K^T is one such sum over
  D, its cross terms first; the scale goes onto the float32 scores with
  log2(e); p = 2**(x - m) stays float32 and l is summed from it; each
  32-key tile's P V goes into a fresh accumulator, cross terms first, and
  is added to the float32 sum rounded to nearest after the sum's rescale.
  That model, tile by tile, stays within 1e-5 of the largest output and
  lse of the JAX package's float32 forward (its Pallas bodies in
  interpret mode, the hsd and the dS forms); with one TF32 term a product
  it errs at least 10x more, which is why the kernel takes three.  Over a
  row of 2048 keys one accumulator carried (and rescaled) across the
  tiles errs at least 10x more than a fresh one a tile, which is why the
  kernel takes a fresh one.
* The dispatch (beside `test_fwd_dispatch_by_dtype` in
  test_torch_flash_fwd_bf16.py, which sends float32 on every route to the
  new C entry): `_lib` types the new entry as the bf16 one, and
  `_flash_fwd_cuda` copies a float32 operand whose rows it cannot hand
  over 16 bytes at a time instead of refusing it.
* The build: the new source is in `_build.KERNELS` and compiles for
  ``sm_90a`` into a library named by the hash of its source, the shared
  headers and the flags; the CUDA-core forward `flash_attention.cu` is
  gone from `KERNELS` and from the tree.
"""
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import flash_attention_mod as jfa
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa
from test_torch_flash_bwd_f32 import _tc
from test_torch_flash_fwd_bf16 import _launches, fake_lib  # noqa: F401
from test_torch_kernels import _one_thread, fake_toolchain  # noqa: F401

TOL_3XTF32 = 1e-5  # of the largest reference value
KEYS = 32          # the kernel's key tile
BLOCK = 128        # the Pallas kernels' tiles here
LOG2E = np.float32(math.log2(math.e))
LN2 = np.float32(math.log(2.0))


@pytest.fixture()
def interpret(monkeypatch):
    if not jfa._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfa, "_INTERPRET", True)


# -- the arithmetic ---------------------------------------------------------


def _kernel_model(q, k, v, q_off, k_off, scale, causal, terms=3,
                  fresh=True):
    """out and lse of one (batch, head), (S, D) float32 operands, with the
    kernel's arithmetic: S one tensor-core sum over D; x = s * (scale *
    log2 e) in float32; 32-key tiles up to the causal diagonal, the
    online max m and l in float32; each tile's P V in a fresh accumulator
    added to o * corr or, not ``fresh``, one accumulator carried and
    rescaled across the tiles; out = o * (1 / l), 0 where l = 0; lse = m
    ln 2 + ln l, -1e30 where l = 0."""
    sq, d = q.shape
    skv = k.shape[0]
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    s_all = _tc(torch.zeros(sq, skv), q, k.T, terms, True)
    rows = q_off + torch.arange(sq)[:, None]
    m = torch.full((sq,), -1e30)
    l = torch.zeros(sq)
    o = torch.zeros(sq, d)
    nkb = -(-skv // KEYS)
    if causal:
        nkb = max(0, min(nkb, (q_off + sq - 1 - k_off) // KEYS + 1))
    for k0 in range(0, nkb * KEYS, KEYS):
        cols = k_off + k0 + torch.arange(min(KEYS, skv - k0))[None, :]
        vis = rows >= cols if causal else torch.ones(sq, cols.shape[1],
                                                      dtype=torch.bool)
        x = torch.where(vis, s_all[:, k0:k0 + KEYS] * sl2, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.where(vis, torch.exp2(x - m_new[:, None]), 0.0)
        l = l * corr + p.sum(-1)
        vb = v[k0:k0 + KEYS]
        if fresh:
            o = o * corr[:, None] + _tc(torch.zeros(sq, d), p, vb, terms,
                                        True)
        else:
            o = _tc(o * corr[:, None], p, vb, terms, True)
        m = m_new
    seen = l > 0
    l_safe = torch.where(seen, l, 1.0)
    out = torch.where(seen[:, None], o * (1.0 / l_safe)[:, None], 0.0)
    lse = torch.where(seen, m * LN2 + torch.log(l_safe), -1e30)
    return out, lse


def _model(q, k, v, q_off, k_off, scale, causal, terms=3):
    """`_kernel_model` over every (batch, head) of (B, H, S, D) arrays."""
    b, h, sq, d = q.shape
    out, lse = np.zeros_like(q), np.zeros((b, h, sq), np.float32)
    for i in range(b):
        for j in range(h):
            o, s = _kernel_model(*(torch.from_numpy(a[i, j])
                                   for a in (q, k, v)),
                                 q_off, k_off, scale, causal, terms)
            out[i, j], lse[i, j] = o.numpy(), s.numpy()
    return out, lse


def _operands(b, h, sq, skv, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32)
                 for s in (sq, skv, skv))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# (batch, heads, Sq, Skv, head_dim, q_offset, causal, the Pallas form):
# ragged lengths, the causal diagonal inside a key tile, both head widths,
# the hsd and the dS forms
MODEL_CASES = [(1, 2, 72, 100, 64, 28, True, "hsd"),
               (1, 2, 72, 100, 128, 28, True, "ds"),
               (1, 2, 72, 100, 64, 0, False, "ds"),
               (1, 2, 72, 100, 128, 0, False, "hsd")]


@pytest.mark.parametrize("b,h,sq,skv,d,q_off,causal,form", MODEL_CASES)
def test_3xtf32_model_matches_the_jax_f32_forward(interpret, b, h, sq, skv,
                                                  d, q_off, causal, form):
    """The kernel's 3xTF32 arithmetic, tile by tile, against the JAX
    package's float32 Pallas forward: out and lse within 1e-5 of their
    largest reference value; one TF32 term a product errs 10x more
    (measured: 3xTF32 5.7e-7 to 1.4e-6, one term 3.4e-4 to 6.4e-4)."""
    q, k, v = _operands(b, h, sq, skv, d, seed=sq + skv + d + q_off)
    scale = 1.0 / math.sqrt(d)
    if form == "ds":
        out, lse = jfa._flash_fwd_pallas_ds(
            *(jnp.asarray(a).swapaxes(2, 3) for a in (q, k, v)), q_off, 0,
            scale, causal, BLOCK, BLOCK)
        out = np.asarray(out).swapaxes(2, 3)
    else:
        out, lse = jfa._flash_fwd_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                                         q_off, 0, scale, causal, BLOCK,
                                         BLOCK)
    want = np.asarray(out), np.asarray(lse)
    errs = {}
    for terms in (3, 1):
        got = _model(q, k, v, q_off, 0, scale, causal, terms)
        errs[terms] = max(_rel(g, w) for g, w in zip(got, want))
    assert errs[3] <= TOL_3XTF32, errs
    assert errs[1] >= 10 * errs[3], errs


def test_rows_that_see_no_key_give_zero_and_the_floor_lse():
    """Causal with k_offset past some rows: those rows see no key, and the
    model, as the kernel, gives them out 0 and lse -1e30, as the plain
    version does; the others agree with the plain version to 1e-5."""
    q, k, v = (torch.from_numpy(a[0, 0]) for a in _operands(1, 1, 70, 90,
                                                             64, seed=3))
    scale = 0.125
    out, lse = _kernel_model(q, k, v, 0, 40, scale, True)
    want = tfa._flash_fwd_plain(*(t[None, None] for t in (q, k, v)), 0, 40,
                                scale, True)
    wout, wlse = want[0][0, 0], want[1][0, 0]
    blind = torch.arange(70) < 40
    assert (out[blind] == 0).all() and (lse[blind] == -1e30).all()
    assert (wout[blind] == 0).all() and (wlse[blind] == -1e30).all()
    assert _rel(out[~blind], wout[~blind]) <= TOL_3XTF32
    assert _rel(lse[~blind], wlse[~blind]) <= TOL_3XTF32


def test_fresh_tile_accumulators_stop_the_round_toward_zero_drift():
    """A row of 2048 keys (64 tiles of 32, non-causal): P V summed in one
    accumulator carried across the tiles takes 768 roundings toward zero
    and drifts; a fresh accumulator a tile takes 12 before a sum rounded
    to nearest.  Against the float64 forward the carried one errs at
    least 10x more (measured: 2.1e-5 against 9.7e-7)."""
    q, k, v = (torch.from_numpy(a[0, 0]) for a in _operands(1, 1, 8, 2048,
                                                             64, seed=11))
    scale = 0.125
    s = q.double() @ k.double().T * scale
    want = torch.softmax(s, -1) @ v.double()
    err = {}
    for fresh in (True, False):
        out, _ = _kernel_model(q, k, v, 0, 0, scale, False, fresh=fresh)
        err[fresh] = float((out.double() - want).abs().max()
                           / want.abs().max())
    assert err[True] <= TOL_3XTF32, err
    assert err[False] >= 10 * err[True], err


# -- the dispatch -----------------------------------------------------------


def test_the_f32_entry_takes_the_bf16_argument_list(monkeypatch):
    """`_lib` types the new forward entry exactly as the bf16 one."""
    class Entry:
        argtypes = restype = None

    libs = {}
    monkeypatch.setattr(tfa._build, "load", lambda name: libs.setdefault(
        name, types.SimpleNamespace(**{
            n: Entry() for n in ("mxt_flash_attention_fwd_f32",
                                 "mxt_flash_attention_fwd_bf16")})))
    f32 = tfa._lib("flash_attention_fwd_f32").mxt_flash_attention_fwd_f32
    bf16 = tfa._lib("flash_attention_fwd").mxt_flash_attention_fwd_bf16
    assert f32.argtypes == bf16.argtypes and len(f32.argtypes) == 29
    assert f32.restype is bf16.restype
    assert tfa._FWD_ENTRIES[torch.float32] == (
        "flash_attention_fwd_f32", "mxt_flash_attention_fwd_f32")


@pytest.mark.parametrize("route", ["hsd", "bsd_loop"])
def test_misaligned_f32_operands_are_copied_not_refused(fake_lib, route):
    """A float32 q whose sequence stride is no multiple of 4 elements and
    a k that starts 4 bytes past a 16-byte boundary reach the kernel as
    aligned copies: one launch of the new entry, counted on the route,
    every stride it is handed a multiple of 4 and out aligned."""
    q, k, v = (torch.randn(1, 2, 72, 64) for _ in range(3))
    bad_q = torch.zeros(1, 2, 72, 66)[..., :64]
    bad_q.copy_(q)
    bad_k = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    bad_k.copy_(k)
    assert not tfa._aligned(bad_q) and not tfa._aligned(bad_k)
    before = _launches(route)
    out, lse = tfa._flash_fwd_cuda(bad_q, bad_k, v, 0, 0, 0.125, True, True,
                                   route)
    assert [c[:2] for c in fake_lib] == [
        ("flash_attention_fwd_f32", "mxt_flash_attention_fwd_f32")]
    assert _launches(route) == before + 1
    (_, _, _, _, _, (q_strides, o_strides), pointers), = fake_lib
    assert all(s % 4 == 0 for s in q_strides + o_strides)
    assert all(p % 16 == 0 for p in pointers)
    assert tfa._aligned(out) and out.shape == q.shape
    assert lse.shape == (1, 2, 72)


# -- the build ---------------------------------------------------------------


def test_new_source_builds_for_sm90a_once_per_source_hash(fake_toolchain):
    """The 3xTF32 forward is one of the sources `_build` compiles, for
    ``sm_90a`` with the common flags, into a library named by the hash of
    its source, the shared headers and those flags."""
    _build_mod, csrc = fake_toolchain
    assert "flash_attention_fwd_f32" in _build.KERNELS
    real = Path(tfa.__file__).parents[2] / "csrc"
    text = (real / "flash_attention_fwd_f32.cu").read_text()
    assert '#include "tf32.cuh"' in text
    for name in ("mxt_flash_attention_fwd_f32", "mxt_error_string",
                 "flash_fwd_tf32_kernel"):
        assert name in text
    (csrc / "tf32.cuh").write_text("// h1\n")
    (csrc / "flash_attention_fwd_f32.cu").write_text("// v1\n")
    took = _build_mod.build(("flash_attention_fwd_f32",))
    lib = _build_mod._target("flash_attention_fwd_f32")[1]
    assert took["flash_attention_fwd_f32"] > 0 and lib.exists()
    assert "-gencode arch=compute_90a,code=sm_90a" in lib.read_text()
    assert _build_mod.build(("flash_attention_fwd_f32",)) == {
        "flash_attention_fwd_f32": 0.0}
    (csrc / "tf32.cuh").write_text("// h2\n")
    assert _build_mod._target("flash_attention_fwd_f32")[1] != lib


def test_the_cuda_core_forward_is_gone():
    """`flash_attention.cu` is in neither `KERNELS` nor the tree, and no
    flash source keeps its entry to fall back to."""
    csrc = Path(tfa.__file__).parents[2] / "csrc"
    assert "flash_attention" not in _build.KERNELS
    assert not (csrc / "flash_attention.cu").exists()
    for src in csrc.glob("flash_attention*.cu"):
        assert "mxt_flash_attention_fwd(" not in src.read_text()
