"""The fused CE head's bf16 tensor-core kernels and the lifted width cap,
on the CPU.

`mxnet_tpu_torch/csrc/fused_ce_bf16.cu` runs only on the card, where
`chip_smoke.py` holds each of its four modes against the plain version
in bf16.  What the CPU can pin:

* The rounding points.  The kernel rounds where the Pallas kernels and
  the plain versions do (p to W's dtype before p @ W, dl to x's before
  dl^T x and to W's before dl @ W, everything else float32), and tiles
  the vocabulary by 64.  So the plain versions in bf16 at ``block_v`` 64
  stay within `REL_TOL` (chip_smoke.py's bf16 bar) of the five Pallas
  bodies run in interpret mode in bf16, and their float32 outputs (nll,
  lse, the picked logit) within `F32_TOL`, at a ragged shape whose d is
  no multiple of 64.  So does a model of the kernel's arithmetic written
  here: S summed from per-warpgroup partials over the depth's 64-column
  chunks in one fixed order, the online softmax in the log2 domain over
  64-column tiles, float32 accumulators.
* The width: `fused_softmax_ce` at GPT-2 medium's d = 1024 agrees with
  the JAX package's and its `jax.vjp` in float32, in both structures.
* The dispatch: with the C library faked, bf16 reaches the ``_bf16``
  entries of `fused_ce_bf16.cu` and float32 the ``_f32`` ones of
  `fused_ce_f32.cu`, for
  all four wrappers, once each; d = 772, 1024 and 1600 are taken; a bf16
  d of 4 more than a multiple of 8 is zero-padded to the 16-byte granule
  and counted on ``padded_calls``; a bf16 d past the widest cluster's
  3072 columns reaches the kernel as well.
* The build: the new source is in `_build.KERNELS` and compiles for
  ``sm_90a`` into a library named by the hash of its source, the shared
  header and the flags.
"""
import ctypes
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import fused_ce_mod as jfc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.ops.pallas_kernels import fused_ce as tfc
from test_torch_kernels import _one_thread, fake_toolchain  # noqa: F401


REL_TOL = 7e-3    # chip_smoke.py's REL_TOL[bfloat16], of max |ref|
F32_TOL = 1e-4    # chip_smoke.py's REL_TOL[float32]: nll, lse, the pick
TILE = 64         # the kernel's tiles, both operands
N, D, V = 40, 72, 100          # ragged: d = 1.125 chunks, V = 1.56 tiles
BLOCK_N, BLOCK_V = 16, 32      # the Pallas bodies' own tiles here
HEAD = (1.7, 5.0, True)        # grad_scale, ignore_label, use_ignore


def _inputs(seed, n=N, d=D, v=V):
    """x, W, b, int32 labels (some -1, some past V, some the ignore label
    5) and r, as numpy float32."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 0.8).astype(np.float32)
    w = (rng.randn(v, d) * 0.3).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    label = rng.randint(0, v, n).astype(np.int32)
    label[3] = -1
    label[11] = v + 70
    label[5] = label[17] = 5
    r = (rng.rand(n) * 2).astype(np.float32)
    return x, w, b, label, r


def _rel_err(got, want):
    """max |got - want| over max |want|, in float32."""
    got = np.asarray(got, np.float32) if not isinstance(got, torch.Tensor) \
        else got.detach().float().numpy()
    want = np.asarray(want, np.float32) if not isinstance(
        want, torch.Tensor) else want.detach().float().numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16_pair(seed):
    """The same bf16 operands for JAX and torch; labels int32, r float32."""
    x, w, b, label, r = _inputs(seed)
    j = tuple(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)) + (
        jnp.asarray(label), jnp.asarray(r))
    t = tuple(torch.from_numpy(a).bfloat16() for a in (x, w, b)) + (
        torch.from_numpy(label), torch.from_numpy(r))
    return j, t


@pytest.fixture()
def ce_interpret(monkeypatch):
    if not jfc._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfc, "_INTERPRET", True)


# -- the rounding points: the plain versions at the kernel's tile ----------


@pytest.mark.parametrize("fn", ["fwd", "bwd", "fwd_sp", "bwd_dw_rs",
                                "bwd_dx_rs"])
def test_bf16_plain_at_the_kernel_tile_matches_pallas_body(ce_interpret,
                                                           fn):
    """Each Pallas body in bf16 (interpret mode, its own 16 x 32 tiles)
    against the plain version in bf16 at ``block_v`` 64, with grad_scale
    1.7, use_ignore, labels out of range and a d that is no multiple of
    64."""
    (jx, jw, jb, jl, jr), (x, w, b, lbl, r) = _bf16_pair(seed=1)
    lse = tfc._fwd_plain(x, w, b, lbl, 5.0, True, TILE)[1]
    jlse = jnp.asarray(lse.numpy())
    if fn == "fwd":
        want = jfc._fwd_pallas(jx, jw, jb, jl, *HEAD, BLOCK_N, BLOCK_V)
        got = tfc._fwd_plain(x, w, b, lbl, 5.0, True, TILE)
        f32 = 2
    elif fn == "bwd":
        want = jfc._bwd_pallas(jx, jw, jb, jl, jlse, *HEAD, BLOCK_N,
                               BLOCK_V)
        got = tfc._bwd_plain(x, w, b, lbl, lse, *HEAD, TILE)
        f32 = 0
    elif fn == "fwd_sp":
        want = jfc._fwd_sp_pallas(jx, jw, jb, jl, BLOCK_N, BLOCK_V)
        got = tfc._fwd_sp_plain(x, w, b, lbl, TILE)
        f32 = 2
    elif fn == "bwd_dw_rs":
        want = jfc._bwd_dw_rs_pallas(jx, jw, jb, jl, jlse, jr, BLOCK_N,
                                     BLOCK_V)
        got = tfc._bwd_dw_rs_plain(x, w, b, lbl, lse, r, TILE)
        f32 = 0
    else:
        want = (jfc._bwd_dx_rs_pallas(jx, jw, jb, jl, jlse, jr, BLOCK_N,
                                      BLOCK_V),)
        got = (tfc._bwd_dx_rs_plain(x, w, b, lbl, lse, r, TILE),)
        f32 = 0
    assert len(got) == len(want)
    for i, (g, wnt) in enumerate(zip(got, want)):
        wnt = np.asarray(jnp.asarray(wnt, jnp.float32))
        assert g.shape == wnt.shape, (fn, i)
        tol = F32_TOL if i < f32 else REL_TOL
        assert _rel_err(g, wnt) <= tol, (fn, i, _rel_err(g, wnt))


# -- a model of the kernel's arithmetic -----------------------------------


def _partial_scores(own, streamed, parts):
    """own . streamed^T in float32 as the kernel forms it: the depth zero-
    padded to ``parts`` equal runs of 64-column chunks, one run a
    warpgroup, the partials added in warpgroup order."""
    d = own.shape[1]
    cpw = -(-d // (TILE * parts))
    width = cpw * TILE
    own = torch.nn.functional.pad(own.float(), (0, parts * width - d))
    streamed = torch.nn.functional.pad(streamed.float(),
                                       (0, parts * width - d))
    s = None
    for k in range(parts):
        cols = slice(k * width, (k + 1) * width)
        p = own[:, cols] @ streamed[:, cols].T
        s = p if s is None else s + p
    return s


def _exp(x):
    return torch.exp2(x * math.log2(math.e))


def _model(mode, x, w, b, label, lse=None, r=None, parts=4):
    """The kernel's four modes: 'A' (nll, lse), 'B' (lse, a, dxp), 'C'
    (dW, db), 'D' (dx), for one owned tile of all the rows (the rows are
    independent), 64-row streamed tiles, p and dl rounded to bf16 before
    the product, every sum float32."""
    n, v = x.shape[0], w.shape[0]
    lbl = label.long()
    if mode == "C":
        s = _partial_scores(w, x, parts)          # (V, n): vocab x tokens
        p = _exp(s + b.float()[:, None] - lse[None, :])
        onehot = lbl[None, :] == torch.arange(v)[:, None]
        dl = (p - onehot.float()) * r[None, :]
        acc = torch.zeros(v, x.shape[1])
        for t0 in range(0, n, TILE):
            acc += dl[:, t0:t0 + TILE].bfloat16().float() @ \
                x[t0:t0 + TILE].float()
        return acc.bfloat16(), dl.sum(dim=1).bfloat16()
    s = _partial_scores(x, w, parts) + b.float()[None, :]
    if mode == "D":
        p = _exp(s - lse[:, None])
        onehot = lbl[:, None] == torch.arange(v)[None, :]
        dl = (p - onehot.float()) * r[:, None]
        acc = torch.zeros(n, x.shape[1])
        for v0 in range(0, v, TILE):
            acc += dl[:, v0:v0 + TILE].bfloat16().float() @ \
                w[v0:v0 + TILE].float()
        return (acc.bfloat16(),)
    m = torch.full((n,), -1e30)
    l = torch.zeros(n)
    acc = torch.zeros(n, x.shape[1])
    onehot = lbl[:, None] == torch.arange(v)[None, :]
    pick = torch.where(onehot, s, 0.0).sum(dim=1)
    for v0 in range(0, v, TILE):
        st = s[:, v0:v0 + TILE]
        m_new = torch.maximum(m, st.amax(dim=1))
        factor = _exp(m - m_new)
        p = _exp(st - m_new[:, None])
        l = l * factor + p.sum(dim=1)
        acc = acc * factor[:, None] + p.bfloat16().float() @ \
            w[v0:v0 + TILE].float()
        m = m_new
    out_lse = m + torch.log(l)
    if mode == "A":
        valid = lbl != 5
        return torch.where(valid, out_lse - pick, 0.0), out_lse
    return out_lse, pick, acc / l[:, None]


@pytest.mark.parametrize("parts", [2, 4, 16])
@pytest.mark.parametrize("mode", ["A", "B", "C", "D"])
def test_kernel_model_matches_bf16_plain_version(mode, parts):
    """The kernel's arithmetic at 2, 4 and 16 partials (clusters of 1, 2
    and 8 blocks) against the plain version in bf16 at the bars
    chip_smoke.py holds the kernel to."""
    _, (x, w, b, lbl, r) = _bf16_pair(seed=2)
    lse = tfc._fwd_plain(x, w, b, lbl, 5.0, True, TILE)[1]
    got = _model(mode, x, w, b, lbl, lse, r, parts)
    if mode == "A":
        want, f32 = tfc._fwd_plain(x, w, b, lbl, 5.0, True, TILE), 2
    elif mode == "B":
        want, f32 = tfc._fwd_sp_plain(x, w, b, lbl, TILE), 2
    elif mode == "C":
        want, f32 = tfc._bwd_dw_rs_plain(x, w, b, lbl, lse, r, TILE), 0
    else:
        want, f32 = (tfc._bwd_dx_rs_plain(x, w, b, lbl, lse, r, TILE),), 0
    for i, (g, wnt) in enumerate(zip(got, want)):
        assert g.shape == wnt.shape and g.dtype == wnt.dtype, (mode, i)
        tol = F32_TOL if i < f32 else REL_TOL
        assert _rel_err(g, wnt) <= tol, (mode, i, _rel_err(g, wnt))


# -- GPT-2 medium's width through the public entry ------------------------


@pytest.mark.parametrize("single_pass", ["1", "0"])
def test_fused_softmax_ce_at_d1024_matches_jax_vjp(monkeypatch, single_pass):
    """Loss and gradients at d = 1024 (the width the CUDA kernels refused
    before) against `jax.vjp` of the JAX entry, float32, both
    structures."""
    monkeypatch.setenv("MXNET_CE_SINGLE_PASS", single_pass)
    x, w, b, label, _ = _inputs(seed=3, n=24, d=1024, v=90)
    x *= 0.05
    kw = dict(grad_scale=1.7, ignore_label=5.0, use_ignore=True,
              block_v=BLOCK_V)
    out, vjp = jax.vjp(lambda x_, w_, b_: jfc.fused_softmax_ce(
        x_, w_, b_, jnp.asarray(label), **kw), jnp.asarray(x),
        jnp.asarray(w), jnp.asarray(b))
    want = (out,) + vjp(jnp.ones_like(out))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    nll = tfc.fused_softmax_ce(*leaves, torch.from_numpy(label), **kw)
    got = (nll,) + torch.autograd.grad(nll, leaves, torch.ones_like(nll))
    for name, g, wnt in zip(("nll", "dx", "dw", "db"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wnt),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# -- the dispatch ------------------------------------------------------------


@pytest.fixture()
def fake_lib(monkeypatch):
    """`_lib` replaced by fake libraries whose entries record (source,
    entry, dtype, n, d, v) and launch nothing; the device and stream
    lookups answered for CPU tensors.  Returns the calls."""
    calls = []

    def entry(source, name, suffix):
        # n, d and v follow the entry's pointers
        k = tfc._SIGNATURES[name].count(ctypes.c_void_p)

        def launch(dtype, *rest):
            calls.append((source, name + suffix, dtype) + rest[k:k + 3])
            return 0
        return launch

    def lib(source):
        suffix = dict(tfc._SOURCES.values())[source]
        return types.SimpleNamespace(**{
            name + suffix: entry(source, name, suffix)
            for name in tfc._SIGNATURES})

    monkeypatch.setattr(tfc, "_lib", lib)
    monkeypatch.setattr(tfc._build, "check_current_device",
                        lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


_WRAPPERS = {"mxt_fused_ce_fwd": tfc.fused_ce_fwd,
             "mxt_fused_ce_fwd_sp": tfc.fused_ce_fwd_sp,
             "mxt_fused_ce_bwd_dw": tfc.fused_ce_bwd_dw,
             "mxt_fused_ce_bwd_dx": tfc.fused_ce_bwd_dx}


def _call_all(dtype, n, d, v):
    """Each of the four CUDA wrappers once, on CPU tensors; their
    outputs."""
    x = torch.randn(n, d).to(dtype)
    w = torch.randn(v, d).to(dtype)
    b = torch.zeros(v, dtype=dtype)
    label = torch.arange(n, dtype=torch.int32) % v
    lse, r = torch.zeros(n), torch.ones(n)
    return {"mxt_fused_ce_fwd": tfc._fwd_cuda(x, w, b, label, -1.0, False),
            "mxt_fused_ce_fwd_sp": tfc._fwd_sp_cuda(x, w, b, label),
            "mxt_fused_ce_bwd_dw": tfc._bwd_dw_cuda(x, w, b, label, lse, r),
            "mxt_fused_ce_bwd_dx": (tfc._bwd_dx_cuda(x, w, b, label, lse,
                                                     r),)}


@pytest.mark.parametrize("d", [768, 772, 1024, 1600])
@pytest.mark.parametrize("dtype,source,suffix", [
    (torch.bfloat16, "fused_ce_bf16", "_bf16"),
    (torch.float32, "fused_ce_f32", "_f32"),
])
def test_dispatch_by_dtype_at_every_width(fake_lib, dtype, source, suffix,
                                          d):
    """bf16 launches the bf16 tensor-core entries, float32 the 3xTF32
    ones, each wrapper once and counted; a bf16 d of 772 reaches the kernel as
    776 (zero-padded, counted on ``padded_calls``) and comes back at 772;
    no other call is padded."""
    n, v = 24, 70
    before = {k: (f.launches, f.padded_calls) for k, f in _WRAPPERS.items()}
    outs = _call_all(dtype, n, d, v)
    pad = 4 if dtype == torch.bfloat16 and d % 8 else 0
    assert fake_lib == [(source, name + suffix, tfc._DTYPES[dtype], n,
                         d + pad, v) for name in _WRAPPERS]
    for name, f in _WRAPPERS.items():
        assert (f.launches, f.padded_calls) == (
            before[name][0] + 1, before[name][1] + bool(pad)), name
    assert outs["mxt_fused_ce_fwd_sp"][2].shape == (n, d)
    assert outs["mxt_fused_ce_bwd_dw"][0].shape == (v, d)
    assert outs["mxt_fused_ce_bwd_dw"][0].dtype == dtype
    assert outs["mxt_fused_ce_bwd_dx"][0].shape == (n, d)
    assert outs["mxt_fused_ce_bwd_dx"][0].dtype == dtype


@pytest.mark.parametrize("d", [3072, 3080, 4096])
def test_bf16_past_the_widest_cluster_reaches_the_kernel(fake_lib, d):
    """Past 3072 columns (the widest cluster's) bf16 still reaches the
    tensor-core entries, which walk the depth in windows: no width cap
    in the wrapper; 3080 is a multiple of 8, so nothing is padded."""
    outs = _call_all(torch.bfloat16, 4, d, 8)
    assert [c[1:] for c in fake_lib] == [
        (name + "_bf16", 1, 4, d, 8) for name in _WRAPPERS]
    assert outs["mxt_fused_ce_bwd_dx"][0].shape == (4, d)


def test_padded_operands_carry_zero_columns(fake_lib, monkeypatch):
    """What the bf16 kernel receives at d = 772: x and W widened by 4
    zero columns, contiguous and 16-byte aligned, labels int32."""
    seen = {}
    real = tfc._entry

    def spy(dtype, name):
        fn = real(dtype, name)

        def launch(dt, x, w, b, label, *rest):
            seen.update(x=x, w=w, label=label)
            return fn(dt, x, w, b, label, *rest)
        return launch

    monkeypatch.setattr(tfc, "_entry", spy)
    captured = {}
    pad = torch.nn.functional.pad

    def record(t, widths):
        out = pad(t, widths)
        captured.setdefault("ops", []).append(out)
        return out

    monkeypatch.setattr(torch.nn.functional, "pad", record)
    x = torch.randn(6, 772).bfloat16()
    w = torch.randn(9, 772).bfloat16()
    tfc._fwd_cuda(x, w, torch.zeros(9, dtype=torch.bfloat16),
                  torch.arange(6).long(), -1.0, False)
    xp, wp = captured["ops"]
    assert xp.shape == (6, 776) and wp.shape == (9, 776)
    assert torch.equal(xp[:, :772], x) and not xp[:, 772:].any()
    assert torch.equal(wp[:, :772], w) and not wp[:, 772:].any()
    assert seen["x"] == xp.data_ptr() and xp.data_ptr() % 16 == 0


# -- the build ---------------------------------------------------------------


def test_new_source_builds_for_sm90a_once_per_source_hash(fake_toolchain):
    """The tensor-core CE kernels are one of the sources `_build` compiles,
    for ``sm_90a`` with the common flags, into a library named by the hash
    of its source, the shared header and those flags."""
    _build_mod, csrc = fake_toolchain
    assert "fused_ce_bf16" in _build.KERNELS
    src = Path(tfc.__file__).parents[2] / "csrc"
    text = (src / "fused_ce_bf16.cu").read_text()
    assert '#include "wgmma.cuh"' in text
    for entry in tfc._SIGNATURES:
        assert "int %s_bf16(" % entry in text
    (csrc / "fused_ce_bf16.cu").write_text("// v1\n")
    (csrc / "wgmma.cuh").write_text("// h1\n")
    took = _build_mod.build(("fused_ce_bf16",))
    lib = _build_mod._target("fused_ce_bf16")[1]
    assert took["fused_ce_bf16"] > 0 and lib.exists()
    assert "-gencode arch=compute_90a,code=sm_90a" in lib.read_text()
    assert _build_mod.build(("fused_ce_bf16",)) == {"fused_ce_bf16": 0.0}
    (csrc / "wgmma.cuh").write_text("// h2\n")
    assert _build_mod._target("fused_ce_bf16")[1] != lib
    (csrc / "wgmma.cuh").write_text("// h1\n")
    (csrc / "fused_ce_bf16.cu").write_text("// v2\n")
    assert _build_mod._target("fused_ce_bf16")[1] != lib
