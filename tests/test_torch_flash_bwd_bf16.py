"""The bf16 flash-attention backward on the tensor cores, on the CPU.

`mxnet_tpu_torch/csrc/flash_attention_bwd.cu` runs only on the card,
where `chip_smoke.py` holds it against the plain backward run in float32
on the same bf16 operands.  What the CPU can pin:

* The rounding points.  The Pallas kernels round p and the scaled ds to
  the input dtype before the three products (`_bwd_dq_kernel`,
  `_bwd_dkv_kernel` and their dS and bsd forms); the tensor-core kernels
  round at the same points, because the mma takes bf16 operands.  The
  Pallas backward run in interpret mode on bf16 inputs stays within
  `REL_TOL` (chip_smoke.py's bf16 bar, 7e-3 of the largest reference
  gradient) of `_flash_bwd_plain` in float32 on the same bf16 inputs,
  the reference the card's check uses: so a kernel that rounds where
  Pallas rounds passes that check.  Measured here: at most 4.4e-3.
* The dispatch.  `_flash_bwd_cuda` sends bf16 to the new C entry and
  float32 to the 3xTF32 one, counts one dq and one dk/dv launch on the
  route either way, hands the kernels 16-byte-aligned operands (the 'ds'
  route pads the storage of an odd sequence length), copies operands it
  cannot read in place, and launches a batch past the grid's 65535 in
  chunks.
* The build: the new source is in `_build.KERNELS` and compiles for
  ``sm_90a`` into a library named by the hash of its source and flags.
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
from test_torch_kernels import fake_toolchain  # noqa: F401

REL_TOL = 7e-3  # chip_smoke.py's REL_TOL[bfloat16]
BLOCK = 128     # the Pallas kernels' tiles here


@pytest.fixture()
def interpret(monkeypatch):
    if not jfa._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _bf16_operands(b, h, sq, skv, d, seed):
    """q, k, v, the out cotangent (B, H, S, D) and the lse cotangent, N(0,
    1) from `RandomState(seed)` as chip_smoke.py draws them; the four
    (B, H, S, D) ones rounded to bf16, returned as float32 numpy arrays
    holding bf16 values."""
    rng = np.random.RandomState(seed)
    shapes = ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d), (b, h, sq, d))
    q, k, v, g = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                  .bfloat16().float().numpy() for s in shapes)
    glse = rng.randn(b, h, sq).astype(np.float32)
    return q, k, v, g, glse


def _rel_err(got, want):
    """max |got - want| over max |want|, float32."""
    got, want = (np.asarray(jnp.asarray(t, jnp.float32)) for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plain_f32(q, k, v, o, lse, g, glse, q_off, k_off, scale, causal):
    """`_flash_bwd_plain` in float32 on float32 copies of the bf16
    residuals (B, H, S, D): the card's reference."""
    t = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))  # noqa
    return tfa._flash_bwd_plain(t(q), t(k), t(v), t(o), t(lse), t(g),
                                t(glse), q_off, k_off, scale, causal)


# (batch, heads, sq = skv, head_dim, q_off), causal: the probe's shapes
HSD_CASES = [(1, 2, 256, 128, 0), (1, 2, 512, 128, 24), (1, 2, 1000, 128, 0),
             (1, 2, 1000, 128, 24), (1, 1, 2048, 128, 0), (2, 2, 256, 64, 0)]


@pytest.mark.parametrize("b,h,s,d,q_off", HSD_CASES)
def test_pallas_bf16_backward_sits_within_the_bar_of_the_f32_plain(
        interpret, b, h, s, d, q_off):
    """`_flash_bwd_pallas` in bf16 (interpret mode) against the plain
    backward in float32 on the same bf16 inputs and residuals."""
    q, k, v, g, glse = _bf16_operands(b, h, s, s, d, seed=s + d + q_off)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    o, lse = jfa._flash_fwd_pallas(jq, jk, jv, q_off, 0, scale, True, BLOCK,
                                   BLOCK)
    got = jfa._flash_bwd_pallas(scale, True, BLOCK, BLOCK,
                                (jq, jk, jv, o, lse, q_off, 0),
                                (jg, jnp.asarray(glse)))[:3]
    want = _plain_f32(q, k, v, o, lse, g, glse, q_off, 0, scale, True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == jnp.bfloat16
        assert _rel_err(a, w.numpy()) <= REL_TOL, name


def test_pallas_ds_bf16_backward_sits_within_the_bar(interpret):
    """The dS form (`_flash_bwd_pallas_ds`, (B, H, D, S) operands) at a
    ragged length with an offset."""
    q, k, v, g, glse = _bf16_operands(1, 2, 200, 200, 128, seed=7)
    scale = 1.0 / math.sqrt(128)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16).swapaxes(2, 3)
                  for a in (q, k, v))
    o, lse = jfa._flash_fwd_pallas_ds(jq, jk, jv, 24, 0, scale, True, BLOCK,
                                      BLOCK)
    got = jfa._flash_bwd_pallas_ds(scale, True, BLOCK, BLOCK,
                                   (jq, jk, jv, o, lse, 24, 0),
                                   (jnp.asarray(g, jnp.bfloat16),
                                    jnp.asarray(glse)))[:3]
    want = _plain_f32(q, k, v, o.swapaxes(2, 3), lse, g, glse, 24, 0, scale,
                      True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a, w.numpy()) <= REL_TOL, name


def test_pallas_bsd_bf16_backward_sits_within_the_bar(interpret):
    """The bsd form (`_flash_bwd_pallas_bsd`, (B, S, E) operands, 2 heads
    of 128)."""
    b, h, s, d = 1, 2, 256, 128
    q, k, v, g, glse = _bf16_operands(b, h, s, s, d, seed=8)
    to_bsd = lambda a: jnp.asarray(  # noqa
        a.transpose(0, 2, 1, 3).reshape(b, s, h * d), jnp.bfloat16)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (to_bsd(a) for a in (q, k, v))
    o, lse = jfa._flash_fwd_pallas_bsd(jq, jk, jv, 0, 0, scale, True, BLOCK,
                                       BLOCK, h)
    got = jfa._flash_bwd_pallas_bsd(scale, True, BLOCK, BLOCK, h,
                                    (jq, jk, jv, o, lse, 0, 0),
                                    (to_bsd(g), jnp.asarray(glse)))[:3]
    heads = lambda a: np.asarray(jnp.asarray(a, jnp.float32)).reshape(  # noqa
        b, s, h, d).transpose(0, 2, 1, 3)
    want = _plain_f32(q, k, v, heads(o), lse, g, glse, 0, 0, scale, True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(heads(a), w.numpy()) <= REL_TOL, name


# -- the dispatch ----------------------------------------------------------


@pytest.fixture()
def fake_lib(monkeypatch):
    """`_lib` replaced by fake libraries whose backward entries record
    (source, entry, which, dtype, layout, strides of q and out0, all the
    arguments) and launch nothing; the device and stream lookups answered for CPU
    tensors.  Returns the calls."""
    calls = []

    def entry(source, name):
        def launch(which, dtype, d, layout, *rest):
            strides = rest[12:15], rest[24:27]
            calls.append((source, name, which, dtype, layout, strides,
                          (which, dtype, d, layout) + rest))
            return 0
        return launch

    def lib(source):
        return types.SimpleNamespace(**{
            name: entry(source, name) for s, name in
            tfa._BWD_ENTRIES.values() if s == source})

    monkeypatch.setattr(tfa, "_lib", lib)
    monkeypatch.setattr(tfa._build, "check_current_device",
                        lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


def _counts(route):
    fn, prefix = tfa._COUNTERS[route]
    return [getattr(fn, prefix + k) for k in ("dq_launches", "dkv_launches")]


def _bwd_inputs(dtype, s=72, d=64, ds=False):
    q, k, v, g = (torch.randn(1, 2, s, d).to(dtype) for _ in range(4))
    lse = torch.randn(1, 2, s)
    if ds:
        q, k, v, g = (tfa._to_ds(t) for t in (q, k, v, g))
    return q, k, v, g.clone(), lse, g


@pytest.mark.parametrize("dtype,source,entry", [
    (torch.bfloat16, "flash_attention_bwd", "mxt_flash_attention_bwd_bf16"),
    (torch.float32, "flash_attention_bwd_f32", "mxt_flash_attention_bwd_f32"),
])
@pytest.mark.parametrize("route", ["hsd", "ds", "bsd_loop", "bsd_stream"])
def test_bwd_dispatch_by_dtype(fake_lib, dtype, source, entry, route):
    """bf16 launches the bf16 tensor-core entry, float32 the 3xTF32 one,
    dq pass then dk/dv pass, each counted once on the route, with one
    argument list of 39 (which, dtype, head_dim, layout, 8 pointers, 4
    sizes, 18 strides, offsets, causal, scale, stream)."""
    ds = route == "ds"
    q, k, v, o, lse, g = _bwd_inputs(dtype, ds=ds)
    before = _counts(route)
    tfa._flash_bwd_cuda(q, k, v, o, lse, g, None, 3, 1, 0.125, True, route)
    assert [c[:5] for c in fake_lib] == [
        (source, entry, which, tfa._DTYPES[dtype], int(ds))
        for which in (0, 1)]
    for which, (*_, args) in enumerate(fake_lib):
        assert len(args) == 39
        assert args[2] == 64 and args[12:16] == (1, 2, 72, 72)
        assert args[-5:-1] == (3, 1, 1, 0.125)
        assert (args[11] is None) == (which == 0)
    assert _counts(route) == [n + 1 for n in before]


def test_ds_route_hands_the_bf16_kernels_aligned_rows(fake_lib):
    """An odd sequence length in dS layout: the route's copies and the
    gradients pad the storage of S to a multiple of 8, so every stride the
    kernels get is a multiple of 8 elements, and the values are those of
    the (B, H, S, D) tensor."""
    x = torch.randn(1, 2, 333, 128).bfloat16()
    xd = tfa._to_ds(x)
    assert xd.shape == (1, 2, 128, 333) and xd.stride() == (
        2 * 128 * 336, 128 * 336, 336, 1)
    assert torch.equal(xd, x.transpose(2, 3)) and tfa._aligned(xd)
    q, k, v, o, lse, g = _bwd_inputs(torch.bfloat16, s=333, d=128, ds=True)
    dq, dk, dv = tfa._flash_bwd_cuda(q, k, v, o, lse, g, None, 0, 0, 0.1,
                                     True, "ds")
    assert all(tfa._aligned(t) and t.shape == q.shape for t in (dq, dk, dv))
    for _, _, _, _, _, (q_strides, out_strides), _ in fake_lib:
        assert all(s % 8 == 0 for s in q_strides + out_strides)


def test_misaligned_bf16_operands_raise_before_launch(fake_lib):
    """A bf16 q whose sequence stride is no multiple of 8 elements (16
    bytes), and one whose last axis is not contiguous, no longer raise:
    each reaches both bf16 passes as a copy the kernels can read in place
    (16-byte aligned, strides multiples of 8 elements), counted; a
    misaligned out cotangent is copied too, and float32 takes the same
    operands."""
    q, k, v, o, lse, g = _bwd_inputs(torch.bfloat16)
    bad = torch.zeros(1, 2, 72, 68, dtype=torch.bfloat16)[..., :64]
    bad.copy_(q)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)
    before = _counts("hsd")
    for qq in (bad, strided):
        tfa._flash_bwd_cuda(qq, k, v, o, lse, g, None, 0, 0, 0.125, True,
                            "hsd")
    assert _counts("hsd") == [n + 2 for n in before]
    assert len(fake_lib) == 4
    for qq, call in zip((bad, bad, strided, strided), fake_lib):
        args = call[6]
        assert args[4] != qq.data_ptr() and args[4] % 16 == 0
        assert all(s % 8 == 0 for s in call[5][0])
    gbad = torch.zeros(1, 2, 72, 68, dtype=torch.bfloat16)[..., :64]
    gbad.copy_(g)
    tfa._flash_bwd_cuda(q, k, v, o, lse, gbad, None, 0, 0, 0.125, True,
                        "hsd")
    assert len(fake_lib) == 6 and fake_lib[-1][6][7] != gbad.data_ptr()
    # float32 takes any sequence stride, as before
    tfa._flash_bwd_cuda(bad.float(), k.float(), v.float(), o.float(), lse,
                        g.float(), None, 0, 0, 0.125, True, "hsd")
    assert fake_lib[-1][1] == "mxt_flash_attention_bwd_f32"


def test_grids_past_65535_launch_in_chunks(fake_lib):
    """Batch 65537 at one head: each pass launches twice, 65535 batches
    and then 2, each at its first batch's pointers (lse's and delta's rows
    too), each counted; only the chunks' arguments are checked."""
    b, s, d = 65537, 2, 64
    q, k, v, g = (torch.zeros(b, 1, s, d, dtype=torch.bfloat16)
                  for _ in range(4))
    lse = torch.zeros(b, 1, s)
    before = _counts("hsd")
    tfa._flash_bwd_cuda(q, k, v, g.clone(), lse, g, None, 0, 0, 0.125,
                        True, "hsd")
    assert _counts("hsd") == [n + 2 for n in before]
    # (which, q, k, v, dout, lse, delta, out0, out1, batch, heads)
    args = [(c[6][0],) + c[6][4:14] for c in fake_lib]
    assert [(a[0], a[9], a[10]) for a in args] == [
        (0, 65535, 1), (0, 2, 1), (1, 65535, 1), (1, 2, 1)]
    step = 65535 * s * d * 2
    for i in (1, 2, 3, 4, 7):
        assert args[1][i] - args[0][i] == step
        assert args[3][i] - args[2][i] == step
    for i in (5, 6):
        assert args[1][i] - args[0][i] == 65535 * s * 4
    assert args[3][8] - args[2][8] == step and args[0][8] is None


# -- the build -------------------------------------------------------------


def test_new_source_builds_for_sm90a_once_per_source_hash(fake_toolchain):
    """The tensor-core backward is one of the sources `_build` compiles,
    for ``sm_90a`` with the common flags, into a library named by the hash
    of its source and those flags."""
    _build_mod, csrc = fake_toolchain
    assert "flash_attention_bwd" in _build.KERNELS
    assert (Path(tfa.__file__).parents[2] / "csrc" /
            "flash_attention_bwd.cu").exists()
    (csrc / "flash_attention_bwd.cu").write_text("// v1\n")
    took = _build_mod.build(("flash_attention_bwd",))
    lib = _build_mod._target("flash_attention_bwd")[1]
    assert took["flash_attention_bwd"] > 0 and lib.exists()
    assert "-gencode arch=compute_90a,code=sm_90a" in lib.read_text()
    assert _build_mod.build(("flash_attention_bwd",)) == {
        "flash_attention_bwd": 0.0}
    (csrc / "flash_attention_bwd.cu").write_text("// v2\n")
    assert _build_mod._target("flash_attention_bwd")[1] != lib
