"""The float32 flash-attention backward on the tensor cores, on the CPU.

`mxnet_tpu_torch/csrc/flash_attention_bwd_f32.cu` runs only on the card,
where `chip_smoke.py` holds it against the plain float32 backward.  What
the CPU can pin:

* The arithmetic.  The kernels compute each of the backward's five
  products in 3xTF32: every operand x split into hi = cvt.rna.tf32(x) and
  lo = cvt.rna.tf32(x - hi), the product taken as hi hi + hi lo + lo hi.
  The tensor cores add each k step's eight products into their float32
  accumulator rounded toward zero.  S and dP are one such sum over D;
  dQ, dK and dV sum each streamed tile in a fresh accumulator (cross
  terms first, then hi hi) and add it to a float32 sum rounded to
  nearest.  A model of that arithmetic here (cvt.rna as an integer add
  of 0x1000 and a mask of 0xFFFFE000, which the card's cvt matches bit
  for bit), run tile by tile as the kernels run it, stays within 1e-5 of
  the largest gradient of the JAX package's float32 backward; the same
  model with one TF32 term a product errs at least 10x more, which is
  why the kernels take three.  Over hundreds of keys one accumulator
  carried across the tiles errs at least 10x more than the fresh ones,
  which is why the kernels take a fresh one a tile.
* The dispatch (beside `test_bwd_dispatch_by_dtype` in
  test_torch_flash_bwd_bf16.py, which sends float32 on every route to
  the new C entry): `_lib` types the new entry as the bf16 one, and
  `_flash_bwd_cuda` copies a float32 operand whose rows it cannot hand
  over 16 bytes at a time instead of refusing it.
* The build: the new source is in `_build.KERNELS` and compiles for
  ``sm_90a`` into a library named by the hash of its source, the shared
  headers (its TF32 blocks in `tf32.cuh`, over `wgmma.cuh`) and the
  flags; no flash kernel is left on the CUDA cores.
"""
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import flash_attention_mod as jfa
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa
from test_torch_flash_bwd_bf16 import _bwd_inputs, _counts
from test_torch_flash_bwd_bf16 import fake_lib  # noqa: F401
from test_torch_kernels import fake_toolchain  # noqa: F401

TOL_3XTF32 = 1e-5  # of the largest reference gradient


# -- the arithmetic ---------------------------------------------------------


def _tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (an add of half the dropped part, then a mask)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _rz_add(acc, s):
    """acc + s (a float64 sum) rounded toward zero to float32, as the
    tensor cores add a k step's products into their accumulator."""
    exact = acc.double() + s
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _tc(acc, a, b, terms, cross_first):
    """acc + a @ b on the tensor cores from float32 operands: a k step of
    8 at a time, each step's products exact and summed in float64, then
    added into ``acc`` by `_rz_add`.  3xTF32 (hi hi, hi lo, lo hi) per
    step, or, ``cross_first``, every step's hi lo and lo hi before the hi
    hi terms (the streamed tiles' order); or one TF32 term."""
    ah, al = _split(a)
    bh, bl = _split(b)
    steps = range(0, a.shape[1], 8)
    if terms == 1:
        seq = [(ah, bh, k) for k in steps]
    elif cross_first:
        seq = ([x for k in steps for x in ((ah, bl, k), (al, bh, k))]
               + [(ah, bh, k) for k in steps])
    else:
        seq = [x for k in steps
               for x in ((ah, bh, k), (ah, bl, k), (al, bh, k))]
    for x, y, k in seq:
        acc = _rz_add(acc, x[:, k:k + 8].double() @ y[k:k + 8].double())
    return acc


def _mm(a, b, terms):
    """a @ b as one tensor-core sum (S and dP over D)."""
    return _tc(torch.zeros(a.shape[0], b.shape[1]), a, b, terms, False)


def _tiled(a, b, tile, terms, fresh=True):
    """a @ b over the contraction axis a tile at a time, as the kernels
    sum dQ, dK and dV: each tile in a fresh accumulator added into a
    float32 sum rounded to nearest; or, not ``fresh``, one accumulator
    carried across the tiles."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for s0 in range(0, a.shape[1], tile):
        x, y = a[:, s0:s0 + tile], b[s0:s0 + tile]
        if fresh:
            out += _tc(torch.zeros_like(out), x, y, terms, True)
        else:
            out = _tc(out, x, y, terms, True)
    return out


def _p_ds(q, k, v, g, lse, delta, q_off, k_off, scale, causal, terms):
    """p and ds of one (batch, head) in float32, S and dP one tensor-core
    sum over D each."""
    s = _mm(q, k.T, terms)
    dp = _mm(g, v.T, terms)
    p = torch.exp(s * scale - lse[:, None])
    if causal:
        qpos = q_off + torch.arange(q.shape[0])[:, None]
        kpos = k_off + torch.arange(k.shape[0])[None, :]
        p = torch.where(kpos <= qpos, p, 0.0)
    return p, p * (dp - delta[:, None]) * scale


def _model_bwd(q, k, v, g, lse, delta, q_off, k_off, scale, causal, terms):
    """dq, dk, dv of one (batch, head), (S, D) float32 operands, with the
    kernels' arithmetic: dQ summed over 32-key tiles and dK, dV over
    query tiles of the dk/dv pass's length (64 at D = 64, 32 at D =
    128)."""
    tile = 32 if q.shape[1] == 128 else 64
    p, ds = _p_ds(q, k, v, g, lse, delta, q_off, k_off, scale, causal,
                  terms)
    return (_tiled(ds, k, 32, terms), _tiled(ds.T, q, tile, terms),
            _tiled(p.T, g, tile, terms))


@pytest.fixture(autouse=True)
def _one_thread():
    """The models run thousands of tiny products, which a pool of threads
    only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(b, h, sq, skv, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, skv, d).astype(np.float32) for _ in range(2))
    glse = rng.randn(b, h, sq).astype(np.float32)
    return q, k, v, g, glse


# (batch, heads, Sq, Skv, head_dim, q_offset, causal): a ragged causal
# shape whose offset moves the diagonal into the middle of the key tiles,
# and a non-causal one at the other head width
MODEL_CASES = [(1, 2, 72, 136, 64, 64, True), (1, 2, 40, 100, 128, 0, False)]


@pytest.mark.parametrize("b,h,sq,skv,d,q_off,causal", MODEL_CASES)
def test_3xtf32_model_matches_the_jax_f32_backward(b, h, sq, skv, d, q_off,
                                                   causal):
    """The kernels' 3xTF32 arithmetic, tile by tile, against `jax.vjp` of
    the JAX function in float32 (lse cotangent included): within 1e-5 of
    the largest gradient; one TF32 term a product errs 10x more
    (measured: 3.1e-6 and 6.8e-6, most of it S's roundings toward zero;
    one term 5.9e-4 and 1.1e-3)."""
    q, k, v, g, glse = _operands(b, h, sq, skv, d, seed=sq + skv + d)
    scale = 1.0 / math.sqrt(d)
    kw = dict(causal=causal, q_offset=q_off)
    (out, lse), vjp = jax.vjp(
        lambda *a: jfa.flash_attention(*a, with_lse=True, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(t) for t in vjp((jnp.asarray(g), jnp.asarray(glse)))]
    # delta = rowsum(dO * O) - glse, as the wrapper hands it to the kernels
    delta = tfa._delta(torch.from_numpy(np.array(out)), torch.from_numpy(g),
                       torch.from_numpy(glse))
    lse = torch.from_numpy(np.array(lse))
    errs = {}
    for terms in (3, 1):
        got = [np.zeros_like(w) for w in want]
        for i in range(b):
            for j in range(h):
                grads = _model_bwd(
                    *(torch.from_numpy(a[i, j]) for a in (q, k, v, g)),
                    lse[i, j], delta[i, j], q_off, 0, scale, causal, terms)
                for dst, src in zip(got, grads):
                    dst[i, j] = src.numpy()
        errs[terms] = max(float(np.abs(a - w).max() / np.abs(w).max())
                          for a, w in zip(got, want))
    assert errs[3] <= TOL_3XTF32, errs
    assert errs[1] >= 10 * errs[3], errs


@pytest.mark.parametrize("which,tile", [("dq", 32), ("dk", 64)])
def test_fresh_tile_accumulators_stop_the_round_toward_zero_drift(which,
                                                                  tile):
    """Over 512 keys (dQ, 32-key tiles) or 512 queries (dK, 64-query
    tiles at D = 64): one accumulator carried across the tiles takes 192
    roundings toward zero, which drift; a fresh accumulator a tile takes
    12 or 24 before a sum rounded to nearest.  Against the exact sum of
    the same float32 ds and operand the carried one errs at least 10x
    more (measured: dq 3.6e-6 against 2.5e-7, dk 6.4e-6 against
    2.6e-7)."""
    n, d = 512, 64
    q, k, v, g, _ = (torch.from_numpy(a[0, 0]) for a in _operands(
        1, 1, n if which == "dk" else 64, n, d, seed=5))
    q_off = n - q.shape[0]
    scale = 1.0 / math.sqrt(d)
    s = torch.where(torch.arange(n)[None, :]
                    <= q_off + torch.arange(q.shape[0])[:, None],
                    q.double() @ k.double().T * scale, -math.inf)
    lse = torch.logsumexp(s, -1).float()
    delta = ((torch.softmax(s, -1) @ v.double()).float() * g).sum(-1)
    _, ds = _p_ds(q, k, v, g, lse, delta, q_off, 0, scale, True, 3)
    a, b = (ds, k) if which == "dq" else (ds.T, q)
    want = a.double() @ b.double()
    err = {fresh: float((_tiled(a, b, tile, 3, fresh).double() - want)
                        .abs().max() / want.abs().max())
           for fresh in (True, False)}
    assert err[True] <= 1e-6, err
    assert err[False] >= 10 * err[True], err


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated cvt.rna: 1 + 2**-11 (a tie) rounds up, 1 + 2**-12
    down, and a negative tie away from zero; lo carries what hi drops."""
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), math.pi])
    hi, lo = _split(x)
    assert hi.tolist()[:3] == [1 + 2 ** -10, 1.0, -(1 + 2 ** -10)]
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(hi[:3] + lo[:3], x[:3])
    err = float((hi + lo - x).abs().max())
    assert err <= 2 ** -22 * float(x.abs().max())


# -- the dispatch -----------------------------------------------------------


def test_the_f32_entry_takes_the_bf16_argument_list(monkeypatch):
    """`_lib` types the new entry exactly as the bf16 one."""
    class Entry:
        argtypes = restype = None

    libs = {}
    monkeypatch.setattr(tfa._build, "load", lambda name: libs.setdefault(
        name, types.SimpleNamespace(**{
            n: Entry() for n in ("mxt_flash_attention_bwd_f32",
                                 "mxt_flash_attention_bwd_bf16")})))
    f32 = tfa._lib("flash_attention_bwd_f32").mxt_flash_attention_bwd_f32
    bf16 = tfa._lib("flash_attention_bwd").mxt_flash_attention_bwd_bf16
    assert f32.argtypes == bf16.argtypes and len(f32.argtypes) == 39
    assert f32.restype is bf16.restype


def test_misaligned_f32_operands_are_copied_not_refused(fake_lib):
    """A float32 q whose sequence stride is no multiple of 4 elements and
    a k that starts 4 bytes past a 16-byte boundary reach the kernels as
    aligned copies with the same values; the launches count as before."""
    q, k, v, o, lse, g = _bwd_inputs(torch.float32)
    bad_q = torch.zeros(1, 2, 72, 66)[..., :64]
    bad_q.copy_(q)
    bad_k = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    bad_k.copy_(k)
    assert not tfa._aligned(bad_q) and not tfa._aligned(bad_k)
    before = _counts("hsd")
    dq, dk, dv = tfa._flash_bwd_cuda(bad_q, bad_k, v, o, lse, g, None, 0, 0,
                                     0.125, True, "hsd")
    assert len(fake_lib) == 2 and _counts("hsd") == [n + 1 for n in before]
    for *_, args in fake_lib:
        q_ptr, k_ptr = args[4], args[5]
        assert q_ptr % 16 == 0 and k_ptr % 16 == 0
        assert all(s % 4 == 0 for s in args[16:34])
    assert all(tfa._aligned(t) for t in (dq, dk, dv))


# -- the build ---------------------------------------------------------------


def test_new_source_builds_for_sm90a_once_per_source_hash(fake_toolchain):
    """The 3xTF32 backward is one of the sources `_build` compiles, for
    ``sm_90a`` with the common flags, into a library named by the hash of
    its source, the shared headers and those flags."""
    _build_mod, csrc = fake_toolchain
    assert "flash_attention_bwd_f32" in _build.KERNELS
    real = Path(tfa.__file__).parents[2] / "csrc"
    text = (real / "flash_attention_bwd_f32.cu").read_text()
    assert '#include "tf32.cuh"' in text
    assert '#include "wgmma.cuh"' in (real / "tf32.cuh").read_text()
    (csrc / "wgmma.cuh").write_text("// h1\n")
    (csrc / "flash_attention_bwd_f32.cu").write_text("// v1\n")
    took = _build_mod.build(("flash_attention_bwd_f32",))
    lib = _build_mod._target("flash_attention_bwd_f32")[1]
    assert took["flash_attention_bwd_f32"] > 0 and lib.exists()
    assert "-gencode arch=compute_90a,code=sm_90a" in lib.read_text()
    assert _build_mod.build(("flash_attention_bwd_f32",)) == {
        "flash_attention_bwd_f32": 0.0}
    (csrc / "wgmma.cuh").write_text("// h2\n")
    assert _build_mod._target("flash_attention_bwd_f32")[1] != lib


def test_the_cuda_core_backward_is_gone():
    """No CUDA-core flash source is left to fall back to: every flash
    source builds on a tensor-core header, its kernels are the `wgmma`
    ones (`_mma_` in bf16, `_tf32_` in float32), and each dtype's forward
    and backward entries name such a source."""
    csrc = Path(tfa.__file__).parents[2] / "csrc"
    sources = sorted(csrc.glob("flash_attention*.cu"))
    assert [s.stem for s in sources] == [
        "flash_attention_bwd", "flash_attention_bwd_f32",
        "flash_attention_fwd", "flash_attention_fwd_f32"]
    for src in sources:
        text = src.read_text()
        assert '#include "wgmma.cuh"' in text or '#include "tf32.cuh"' in text
        for gone in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                     "flash_fwd_kernel", "mxt_flash_attention_bwd(",
                     "mxt_flash_attention_fwd("):
            assert gone not in text
    entries = list(tfa._FWD_ENTRIES.values()) + list(tfa._BWD_ENTRIES.values())
    assert {s for s, _ in entries} == {s.stem for s in sources}
