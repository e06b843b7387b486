"""The fused CE head's float32 kernels on the tensor cores, on the CPU.

`mxnet_tpu_torch/csrc/fused_ce_f32.cu` runs only on the card, where
`chip_smoke.py` holds each of its four modes against the plain float32
version.  What the CPU can pin:

* The arithmetic.  The kernels compute both products of a streamed tile
  in 3xTF32 (each operand split into hi = cvt.rna.tf32(x) and lo =
  cvt.rna.tf32(x - hi), each product hi hi + hi lo + lo hi), and the
  tensor cores add each k step's products into their accumulator rounded
  toward zero.  S is formed per warpgroup over its columns of the depth
  (the cross terms in one accumulator, hi hi in another), the partials
  added in the kernel's fixed order; coef . streamed is taken a tile of
  32 streamed rows at a time in a fresh accumulator (cross terms first)
  and added to a float32 sum rounded to nearest.  A model of that
  arithmetic here, built on the primitives of
  test_torch_flash_bwd_f32.py, runs modes A, B, C and D at a ragged shape
  (d a multiple of 4 and not of 8, V no multiple of the tiles, labels
  past V, ignored rows) within 1e-5 of the largest value of the JAX
  package's float32 Pallas bodies (interpret mode); one TF32 term a
  product errs at least 10x more, which is why the kernels take three.
  Over 2048 tokens (C's dW) one accumulator carried across the tiles
  errs at least 10x more than fresh ones, which is why the kernels take a
  fresh one a tile.
* The dispatch: with the C library faked, float32 reaches the ``_f32``
  entries of `fused_ce_f32.cu` with the bf16 entries' argument lists at
  every width class of the kernel's clusters, unpadded; bfloat16 is
  unchanged (test_torch_fused_ce_bf16.py).
* The build: the new source is in `_build.KERNELS` and compiles for
  ``sm_90a`` into a library named by the hash of its source, the shared
  headers and the flags; the CUDA-core kernel is gone.
"""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import fused_ce_mod as jfc
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.ops.pallas_kernels import fused_ce as tfc
from test_torch_kernels import _one_thread  # noqa: F401
from test_torch_flash_bwd_f32 import _rz_add, _split, _tc, _tiled
from test_torch_fused_ce_bf16 import _WRAPPERS, _call_all
from test_torch_fused_ce_bf16 import fake_lib  # noqa: F401
from test_torch_kernels import fake_toolchain  # noqa: F401

TOL_3XTF32 = 1e-5  # of the largest reference value
ROWS = 32          # the kernel's streamed tile
N, D, V = 72, 100, 300
BLOCK_N, BLOCK_V = 24, 128     # the Pallas bodies' own tiles here
HEAD = (1.7, 5.0, True)        # grad_scale, ignore_label, use_ignore
NEG_INF = -1e30


def _cluster(d):
    """The kernel's cluster size and columns a warpgroup at width d
    (`launch_d`); past 1536 a window is 1536 columns."""
    cl = next((c for c in (1, 2, 4, 8) if 192 * c >= d), 8)
    return cl, 64 if 128 * cl >= d else 96


# -- the arithmetic ---------------------------------------------------------


def _partial(a, b, terms):
    """a . b^T over one warpgroup's columns as the kernel forms it: per k
    step of 8 the hi lo and lo hi products into one accumulator and hi hi
    into another, each step added rounded toward zero; then the two
    added.  With one term, hi hi alone."""
    ah, al = _split(a)
    bh, bl = _split(b)
    x = torch.zeros(a.shape[0], b.shape[0])
    hh = torch.zeros_like(x)
    for k in range(0, a.shape[1], 8):
        c = slice(k, k + 8)
        if terms == 3:
            x = _rz_add(x, ah[:, c].double() @ bl[:, c].double().T)
            x = _rz_add(x, al[:, c].double() @ bh[:, c].double().T)
        hh = _rz_add(hh, ah[:, c].double() @ bh[:, c].double().T)
    return x + hh


def _scores(own, st, terms):
    """S = own . st^T as the cluster forms it: the depth zero-filled to
    the cluster's 2 CL CW columns, a partial per warpgroup, the two of a
    block added, the blocks' pair sums added in rank order.  (Below 1536
    columns: one window.)"""
    d = own.shape[1]
    cl, cw = _cluster(d)
    width = 2 * cl * cw
    own = torch.nn.functional.pad(own, (0, width - d))
    st = torch.nn.functional.pad(st, (0, width - d))
    parts = [_partial(own[:, i * cw:(i + 1) * cw], st[:, i * cw:(i + 1) * cw],
                      terms) for i in range(2 * cl)]
    s = parts[0] + parts[1]
    for r in range(1, cl):
        s = s + (parts[2 * r] + parts[2 * r + 1])
    return s


def _product(acc, coef, st, terms):
    """acc + coef . st, the tile's sum in a fresh accumulator (cross
    terms first), added rounded to nearest."""
    return acc + _tc(torch.zeros_like(acc), coef, st, terms, True)


def _tiles(n_str):
    for s0 in range(0, n_str, ROWS):
        j = s0 + torch.arange(ROWS)
        yield s0, j, j < n_str


def _pad_rows(t, s0):
    out = torch.zeros((ROWS,) + tuple(t.shape[1:]), dtype=t.dtype)
    part = t[s0:s0 + ROWS]
    out[:part.shape[0]] = part
    return out


def _model_stats(x, w, b, label, terms, single_pass):
    """Modes A (lse, the pick) and B (lse, the pick, dxp): the online
    softmax over 32-row tiles of W."""
    n, v = x.shape[0], w.shape[0]
    m = torch.full((n,), NEG_INF)
    l = torch.zeros(n)
    pick = torch.zeros(n)
    acc = torch.zeros_like(x)
    lbl = label.long()
    for s0, j, valid in _tiles(v):
        wt, bt = _pad_rows(w, s0), _pad_rows(b, s0)
        s = torch.where(valid, _scores(x, wt, terms) + bt, NEG_INF)
        pick = pick + torch.where(valid & (j == lbl[:, None]), s, 0.0).sum(1)
        m_new = torch.maximum(m, s.amax(1))
        factor = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * factor + p.sum(1)
        if single_pass:
            acc = _product(acc * factor[:, None], p, wt, terms)
        m = m_new
    return m + torch.log(l), pick, acc / l[:, None]


def _model_dx(x, w, b, label, lse, r, terms):
    """Mode D: dx = dl W over 32-row tiles of W."""
    v = w.shape[0]
    lbl = label.long()
    dx = torch.zeros_like(x)
    for s0, j, valid in _tiles(v):
        wt, bt = _pad_rows(w, s0), _pad_rows(b, s0)
        s = _scores(x, wt, terms) + bt
        dl = (torch.exp(s - lse[:, None]) - (j == lbl[:, None]).float()) \
            * r[:, None]
        dx = _product(dx, torch.where(valid, dl, 0.0), wt, terms)
    return dx


def _model_dw(x, w, b, label, lse, r, terms):
    """Mode C: dW = dl^T x and db over 32-token tiles of x, the owned rows
    W's."""
    n, v = x.shape[0], w.shape[0]
    lbl = label.long()
    dw = torch.zeros_like(w)
    db = torch.zeros(v)
    vocab = torch.arange(v)[:, None]
    for s0, j, valid in _tiles(n):
        xt = _pad_rows(x, s0)
        lt, rt = _pad_rows(lse, s0), _pad_rows(r, s0)
        s = _scores(w, xt, terms) + b[:, None]
        dl = (torch.exp(s - lt) - (_pad_rows(lbl, s0) == vocab).float()) * rt
        dl = torch.where(valid, dl, 0.0)
        db = db + dl.sum(1)
        dw = _product(dw, dl, xt, terms)
    return dw, db


def _inputs(seed=0):
    """x, W, b, int32 labels (some -1, some past the Pallas tiles'
    padding, some the ignore label 5) and r, as numpy float32."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, D) * 0.8).astype(np.float32)
    w = (rng.randn(V, D) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    label = rng.randint(0, V, N).astype(np.int32)
    label[::7] = -1
    label[3::11] = V + 2 * BLOCK_V
    label[1::5] = 5
    r = (rng.rand(N) * 2).astype(np.float32)
    return x, w, b, label, r


@pytest.fixture()
def ce_interpret(monkeypatch):
    if not jfc._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfc, "_INTERPRET", True)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("mode", ["A", "B", "C", "D"])
def test_3xtf32_model_matches_the_jax_f32_pallas_bodies(ce_interpret, mode):
    """Each mode's outputs through the model of the kernel's arithmetic,
    against the JAX package's float32 Pallas body in interpret mode:
    within 1e-5 of each output's largest value; one TF32 term a product
    errs at least 10x more (measured: A 3.0e-7, B 8.7e-7, C 6.6e-7, D
    1.5e-6; one term 1.0e-4 to 5.6e-4)."""
    x, w, b, label, r = _inputs()
    jx, jw, jb, jl, jr = (jnp.asarray(a) for a in (x, w, b, label, r))
    tx, tw, tb, tl, tr = (torch.from_numpy(a) for a in (x, w, b, label, r))
    jnll, jlse = jfc._fwd_pallas(jx, jw, jb, jl, *HEAD, BLOCK_N, BLOCK_V)
    lse = torch.from_numpy(np.array(jlse))
    if mode == "A":
        want = (jnll, jlse)
    elif mode == "B":
        want = jfc._fwd_sp_pallas(jx, jw, jb, jl, BLOCK_N, BLOCK_V)
    elif mode == "C":
        want = jfc._bwd_dw_rs_pallas(jx, jw, jb, jl, jlse, jr, BLOCK_N,
                                     BLOCK_V)
    else:
        want = (jfc._bwd_dx_rs_pallas(jx, jw, jb, jl, jlse, jr, BLOCK_N,
                                      BLOCK_V),)
    errs = {}
    for terms in (3, 1):
        if mode in "AB":
            lse_m, pick, dxp = _model_stats(tx, tw, tb, tl, terms, mode == "B")
            if mode == "A":
                valid = tl.long() != int(HEAD[1])
                got = (torch.where(valid, lse_m - pick, 0.0), lse_m)
            else:
                got = (lse_m, pick, dxp)
        elif mode == "C":
            got = _model_dw(tx, tw, tb, tl, lse, tr, terms)
        else:
            got = (_model_dx(tx, tw, tb, tl, lse, tr, terms),)
        errs[terms] = max(_rel(g, wt) for g, wt in zip(got, want))
    assert errs[3] <= TOL_3XTF32, errs
    assert errs[1] >= 10 * errs[3], errs


def test_fresh_tile_accumulators_stop_the_round_toward_zero_drift():
    """C's dW over 2048 tokens (64 tiles of 32): one accumulator carried
    across the tiles takes 768 roundings toward zero, which drift; a fresh
    one a tile takes 12 before a sum rounded to nearest.  Against the
    exact sum of the same float32 dl and x the carried one errs at least
    10x more (measured: 1.7e-5 against 2.9e-7)."""
    rng = np.random.RandomState(3)
    n, d, v = 2048, 64, 64
    x = torch.from_numpy((rng.randn(n, d) * 0.8).astype(np.float32))
    w = torch.from_numpy((rng.randn(v, d) * 0.3).astype(np.float32))
    s = w.double() @ x.double().T
    label = torch.from_numpy(rng.randint(0, v, n))
    dl = (torch.softmax(s, 0) - (label[None, :] == torch.arange(v)[:, None])
          .double()).float()
    want = dl.double() @ x.double()
    err = {fresh: float((_tiled(dl, x, ROWS, 3, fresh).double() - want)
                        .abs().max() / want.abs().max())
           for fresh in (True, False)}
    assert err[True] <= 1e-6, err
    assert err[False] >= 10 * err[True], err


# -- the dispatch -----------------------------------------------------------


@pytest.mark.parametrize("d", [4, 100, 192, 260, 512, 772, 1024, 1600, 4096])
def test_f32_reaches_the_3xtf32_entries_at_every_width(fake_lib, d):
    """float32 launches `fused_ce_f32.cu`'s ``_f32`` entries, each wrapper
    once and counted, at every cluster size and past the widest cluster's
    1536 columns; a d of 4 more than a multiple of 8 goes unpadded."""
    n, v = 6, 70
    before = {k: (f.launches, f.padded_calls) for k, f in _WRAPPERS.items()}
    outs = _call_all(torch.float32, n, d, v)
    assert fake_lib == [("fused_ce_f32", name + "_f32", 0, n, d, v)
                        for name in _WRAPPERS]
    for name, f in _WRAPPERS.items():
        assert (f.launches, f.padded_calls) == (before[name][0] + 1,
                                                before[name][1]), name
    assert outs["mxt_fused_ce_fwd_sp"][2].shape == (n, d)
    assert outs["mxt_fused_ce_bwd_dw"][0].dtype == torch.float32
    assert outs["mxt_fused_ce_bwd_dx"][0].shape == (n, d)


def test_the_f32_entries_take_the_bf16_argument_lists(monkeypatch):
    """`_lib` types each ``_f32`` entry exactly as its ``_bf16`` one."""
    class Entry:
        argtypes = restype = None

    libs = {}
    monkeypatch.setattr(tfc._build, "load", lambda name: libs.setdefault(
        name, types.SimpleNamespace(**{
            e + suffix: Entry() for e in tfc._SIGNATURES
            for suffix in ("_f32", "_bf16")})))
    for name in tfc._SIGNATURES:
        f32 = getattr(tfc._lib("fused_ce_f32"), name + "_f32")
        bf16 = getattr(tfc._lib("fused_ce_bf16"), name + "_bf16")
        assert f32.argtypes == bf16.argtypes
        assert f32.argtypes[:-1] == tfc._SIGNATURES[name]
        assert f32.restype is bf16.restype


# -- the build ---------------------------------------------------------------


def test_new_source_builds_for_sm90a_once_per_source_hash(fake_toolchain):
    """The 3xTF32 CE kernels are one of the sources `_build` compiles, for
    ``sm_90a`` with the common flags, into a library named by the hash of
    its source, the shared headers and those flags."""
    _build_mod, csrc = fake_toolchain
    assert "fused_ce_f32" in _build.KERNELS
    real = Path(tfc.__file__).parents[2] / "csrc"
    text = (real / "fused_ce_f32.cu").read_text()
    assert '#include "tf32.cuh"' in text
    assert '#include "wgmma.cuh"' in (real / "tf32.cuh").read_text()
    for entry in tfc._SIGNATURES:
        assert "int %s_f32(" % entry in text
    (csrc / "fused_ce_f32.cu").write_text("// v1\n")
    (csrc / "tf32.cuh").write_text("// h1\n")
    took = _build_mod.build(("fused_ce_f32",))
    lib = _build_mod._target("fused_ce_f32")[1]
    assert took["fused_ce_f32"] > 0 and lib.exists()
    assert "-gencode arch=compute_90a,code=sm_90a" in lib.read_text()
    assert _build_mod.build(("fused_ce_f32",)) == {"fused_ce_f32": 0.0}
    (csrc / "tf32.cuh").write_text("// h2\n")
    assert _build_mod._target("fused_ce_f32")[1] != lib


def test_the_cuda_core_ce_kernel_is_gone():
    """`fused_ce.cu` is neither built nor in the tree, and both fused CE
    sources share the TF32 and cluster blocks through the headers: no
    CUDA-core kernel is left to fall back to."""
    csrc = Path(tfc.__file__).parents[2] / "csrc"
    assert "fused_ce" not in _build.KERNELS
    assert not (csrc / "fused_ce.cu").exists()
    assert dict(tfc._SOURCES.values()) == {"fused_ce_f32": "_f32",
                                           "fused_ce_bf16": "_bf16"}
    flash = (csrc / "flash_attention_bwd_f32.cu").read_text()
    assert '#include "tf32.cuh"' in flash
    assert "uint32_t tf32_rna(" not in flash
