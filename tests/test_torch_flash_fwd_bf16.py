"""The bf16 flash-attention forward on the tensor cores, on the CPU.

`mxnet_tpu_torch/csrc/flash_attention_fwd.cu` runs only on the card,
where `chip_smoke.py` holds it against the plain forward run in float32
on the same bf16 operands.  What the CPU can pin:

* The rounding points.  The Pallas forward keeps p in float32; the
  tensor-core kernel rounds p to bf16 as the operand of P V (l is summed
  from the float32 p).  The Pallas forward run in interpret mode on bf16
  inputs stays within `REL_TOL` (chip_smoke.py's bf16 bar, 7e-3 of the
  largest reference value) of `_flash_fwd_plain` in float32 on the same
  bf16 inputs, the reference the card's check uses; so does a model of
  the kernel's arithmetic written here (64-key tiles, the log2-domain
  online softmax, p rounded to bf16 before P V), causal and not, with
  offsets, rows that see no key, and in both layouts.  lse is float32 in
  both and agrees to float32 rounding.
* The dispatch.  `_flash_fwd_cuda` sends bf16 to the new C entry and
  float32 to the 3xTF32 one (test_torch_flash_fwd_f32.py), counts one
  launch on the route either way, copies a bf16 operand it cannot read in
  place (misaligned, or its last axis not contiguous), and launches a
  batch past the grid's 65535 in chunks.
* The build: the new source is in `_build.KERNELS` and compiles for
  ``sm_90a`` into a library named by the hash of its source, the shared
  header and the flags.
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
from test_torch_kernels import _one_thread, fake_toolchain  # noqa: F401


REL_TOL = 7e-3  # chip_smoke.py's REL_TOL[bfloat16]
LSE_ATOL = 1e-5  # float32 in both, of magnitude < 10: ex2 vs exp and the
                 # order of the sums, ~1e-6
BLOCK = 128     # the Pallas kernels' tiles here
TILE = 64       # the CUDA kernel's tiles


@pytest.fixture()
def interpret(monkeypatch):
    if not jfa._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _bf16_operands(b, h, sq, skv, d, seed):
    """q, k, v (B, H, S, D), N(0, 1) from `RandomState(seed)` as
    chip_smoke.py draws them, rounded to bf16, as float32 tensors."""
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
                 .bfloat16().float() for s in (sq, skv, skv))


def _rel_err(got, want):
    """max |got - want| over max |want|, float32."""
    got, want = (t.float() if isinstance(t, torch.Tensor) else
                 torch.from_numpy(np.array(jnp.asarray(t, jnp.float32)))
                 for t in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def _kernel_model(q, k, v, q_off, k_off, scale, causal):
    """The bf16 forward kernel's arithmetic in float32 on (B, H, S, D) bf16
    values: 64-key tiles up to the causal diagonal; x = (q k^T) * scale *
    log2(e); m the running max of x; p = 2**(x - m), 0 where masked; l
    summed from the float32 p; acc += bf16(p) v; out = bf16(acc / l), 0
    where l = 0; lse = m ln 2 + ln l, -1e30 where l = 0."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    sl2 = scale * math.log2(math.e)
    rows = q_off + torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, skv, TILE):
        cols = k_off + k0 + torch.arange(min(TILE, skv - k0))[None, :]
        vis = (rows >= cols) if causal else torch.ones_like(rows >= cols)
        x = q @ k[:, :, k0:k0 + TILE].transpose(-1, -2) * sl2
        x = torch.where(vis, x, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        p = torch.where(vis, torch.exp2(x - m_new[..., None]), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        vb = v[:, :, k0:k0 + TILE]
        acc = acc * corr[..., None] + p.bfloat16().float() @ vb
        m = m_new
    seen = l > 0
    l_safe = torch.where(seen, l, 1.0)
    out = torch.where(seen[..., None], acc / l_safe[..., None], 0.0)
    lse = torch.where(seen, m * math.log(2) + torch.log(l_safe), -1e30)
    return out.bfloat16(), lse


# (batch, heads, sq, skv, head_dim, causal, q_off, k_off): the card's ragged
# cases (the diagonal 37 into a tile, a 13-position tail, rows that see no
# key), Sq != Skv with offsets and no mask, and the training rows' head 64
MODEL_CASES = [(2, 3, 333, 333, 128, True, 37, 0),
               (2, 2, 200, 333, 128, True, 0, 50),
               (2, 4, 300, 700, 64, False, 400, 100),
               (1, 4, 256, 256, 64, True, 0, 0)]


@pytest.mark.parametrize("layout", ["hsd", "ds"])
@pytest.mark.parametrize("b,h,sq,skv,d,causal,q_off,k_off", MODEL_CASES)
def test_kernel_rounding_sits_within_the_bar_of_the_f32_plain(
        layout, b, h, sq, skv, d, causal, q_off, k_off):
    """The kernel's model against the plain forward in float32 on the same
    bf16 operands: out within the bar, lse to float32 rounding, a row that
    sees no key out 0 and lse -1e30 in both.  In the dS layout the model
    reads the (B, H, D, S) copies the 'ds' route makes."""
    q, k, v = _bf16_operands(b, h, sq, skv, d, seed=sq + skv + d)
    scale = 1.0 / math.sqrt(d)
    args = (q_off, k_off, scale, causal)
    if layout == "ds":
        got = _kernel_model(*(tfa._to_ds(t).transpose(2, 3)
                              for t in (q, k, v)), *args)
    else:
        got = _kernel_model(q, k, v, *args)
    want = tfa._flash_fwd_plain(q, k, v, *args)
    assert got[0].dtype == torch.bfloat16
    assert _rel_err(got[0], want[0]) <= REL_TOL
    seen = want[1] > -1e29
    torch.testing.assert_close(got[1][seen], want[1][seen], rtol=0,
                               atol=LSE_ATOL)
    assert (got[1][~seen] == want[1][~seen]).all()
    assert (got[0][~seen] == 0).all() and (want[0][~seen] == 0).all()


# (batch, heads, s, head_dim, q_off), causal
PALLAS_CASES = [(1, 2, 256, 128, 0), (1, 2, 512, 128, 24), (2, 2, 256, 64, 0)]


@pytest.mark.parametrize("b,h,s,d,q_off", PALLAS_CASES)
def test_pallas_bf16_forward_sits_within_the_bar_of_the_f32_plain(
        interpret, b, h, s, d, q_off):
    """`_flash_fwd_pallas` in bf16 (interpret mode) against the plain
    forward in float32 on the same bf16 inputs."""
    q, k, v = _bf16_operands(b, h, s, s, d, seed=s + d + q_off)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, k, v))
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, q_off, 0, scale, True,
                                     BLOCK, BLOCK)
    want = tfa._flash_fwd_plain(q, k, v, q_off, 0, scale, True)
    assert out.dtype == jnp.bfloat16
    assert _rel_err(out, want[0]) <= REL_TOL
    assert _rel_err(lse, want[1]) <= REL_TOL


def test_pallas_ds_bf16_forward_sits_within_the_bar(interpret):
    """The dS form (`_flash_fwd_pallas_ds`, (B, H, D, S) operands) at a
    ragged length with an offset."""
    q, k, v = _bf16_operands(1, 2, 200, 200, 128, seed=7)
    scale = 1.0 / math.sqrt(128)
    jq, jk, jv = (jnp.asarray(t.numpy(), jnp.bfloat16).swapaxes(2, 3)
                  for t in (q, k, v))
    out, lse = jfa._flash_fwd_pallas_ds(jq, jk, jv, 24, 0, scale, True,
                                        BLOCK, BLOCK)
    want = tfa._flash_fwd_plain(q, k, v, 24, 0, scale, True)
    assert _rel_err(out.swapaxes(2, 3), want[0]) <= REL_TOL
    assert _rel_err(lse, want[1]) <= REL_TOL


# -- the dispatch ----------------------------------------------------------


@pytest.fixture()
def fake_lib(monkeypatch):
    """`_lib` replaced by fake libraries whose forward entries record
    (source, entry, dtype, head_dim, layout, strides of q and out,
    pointers of q, k, v and out) and launch nothing; the device and stream
    lookups answered for CPU tensors.  Returns the calls."""
    calls = []

    def entry(source, name):
        def launch(dtype, d, layout, *rest):
            strides = rest[9:12], rest[18:21]
            calls.append((source, name, dtype, d, layout, strides, rest[:4]))
            return 0
        return launch

    def lib(source):
        return types.SimpleNamespace(**{
            name: entry(source, name) for s, name in
            tfa._FWD_ENTRIES.values() if s == source})

    monkeypatch.setattr(tfa, "_lib", lib)
    monkeypatch.setattr(tfa._build, "check_current_device",
                        lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


def _launches(route):
    fn, prefix = tfa._COUNTERS[route]
    return getattr(fn, prefix + "launches")


@pytest.mark.parametrize("dtype,source,entry", [
    (torch.bfloat16, "flash_attention_fwd", "mxt_flash_attention_fwd_bf16"),
    (torch.float32, "flash_attention_fwd_f32", "mxt_flash_attention_fwd_f32"),
])
@pytest.mark.parametrize("route", ["hsd", "ds", "bsd_loop", "bsd_stream"])
def test_fwd_dispatch_by_dtype(fake_lib, dtype, source, entry, route):
    """bf16 launches the bf16 tensor-core entry, float32 the 3xTF32 one,
    once, counted on the route; the output and lse come back in the
    operands' layout."""
    ds = route == "ds"
    q, k, v = (torch.randn(1, 2, 72, 64).to(dtype) for _ in range(3))
    if ds:
        q, k, v = (tfa._to_ds(t) for t in (q, k, v))
    before = _launches(route)
    out, lse = tfa._flash_fwd_cuda(q, k, v, 0, 0, 0.125, True, True, route)
    assert [c[:5] for c in fake_lib] == [
        (source, entry, tfa._DTYPES[dtype], 64, int(ds))]
    assert _launches(route) == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert lse.shape == (1, 2, 72) and lse.dtype == torch.float32
    assert tfa._aligned(out)


def test_misaligned_bf16_operands_raise_before_launch(fake_lib):
    """A bf16 k whose sequence stride is no multiple of 8 elements (16
    bytes), and one whose last axis is not contiguous, no longer raise:
    each reaches the bf16 entry as a copy the kernel can read in place
    (16-byte aligned, its values k's), one counted launch each; float32
    takes them the same way."""
    q, k, v = (torch.randn(1, 2, 72, 64).bfloat16() for _ in range(3))
    bad = torch.zeros(1, 2, 72, 68, dtype=torch.bfloat16)[..., :64]
    bad.copy_(k)
    strided = k.transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.stride(3) != 1 and not tfa._aligned(bad)
    copies = []
    real_like = tfa._like

    def like(t):
        copies.append(t.data_ptr())
        return real_like(t)

    tfa._like = like
    try:
        before = _launches("hsd")
        for kk in (bad, strided):
            tfa._flash_fwd_cuda(q, kk, v, 0, 0, 0.125, True, False, "hsd")
        assert _launches("hsd") == before + 2
        assert [c[1] for c in fake_lib] == [
            "mxt_flash_attention_fwd_bf16"] * 2
        for kk, call in zip((bad, strided), fake_lib):
            assert call[6][1] != kk.data_ptr() and call[6][1] % 16 == 0
            assert kk.data_ptr() in copies
        tfa._flash_fwd_cuda(q.float(), bad.float(), v.float(), 0, 0, 0.125,
                            True, False, "hsd")
        assert fake_lib[-1][1] == "mxt_flash_attention_fwd_f32"
    finally:
        tfa._like = real_like


def test_grids_past_65535_launch_in_chunks(fake_lib, monkeypatch):
    """Batch 65537 at one head: two launches of the forward, 65535
    batches and then 2, each at its first batch's pointers (lse's rows
    too), each counted; only the chunks' arguments are checked."""
    seen = []
    monkeypatch.setattr(tfa, "_lib", lambda source: types.SimpleNamespace(
        mxt_flash_attention_fwd_bf16=lambda *a: seen.append(a) or 0))
    b, s, d = 65537, 2, 64
    q, k, v = (torch.zeros(b, 1, s, d, dtype=torch.bfloat16)
               for _ in range(3))
    before = _launches("hsd")
    out, lse = tfa._flash_fwd_cuda(q, k, v, 0, 0, 0.125, True, True, "hsd")
    assert _launches("hsd") == before + 2
    # (q, k, v, out, lse, batch, heads) of each launch
    args = [a[3:10] for a in seen]
    step = 65535 * s * d * 2  # bytes of 65535 batches of a bf16 operand
    assert [a[5:] for a in args] == [(65535, 1), (2, 1)]
    for t, i in ((q, 0), (k, 1), (v, 2), (out, 3)):
        assert [a[i] for a in args] == [t.data_ptr(), t.data_ptr() + step]
    assert [a[4] for a in args] == [lse.data_ptr(),
                                    lse.data_ptr() + 65535 * s * 4]
    assert tfa._grid_chunks(b, 1) == [(0, 65535, 0, 1), (65535, 2, 0, 1)]
    assert tfa._grid_chunks(2, 70000) == [
        (0, 1, 0, 65535), (0, 1, 65535, 4465),
        (1, 1, 0, 65535), (1, 1, 65535, 4465)]


# -- the build -------------------------------------------------------------


def test_new_source_builds_for_sm90a_once_per_source_hash(fake_toolchain):
    """The tensor-core forward is one of the sources `_build` compiles, for
    ``sm_90a`` with the common flags, into a library named by the hash of
    its source, the shared header and those flags."""
    _build_mod, csrc = fake_toolchain
    assert "flash_attention_fwd" in _build.KERNELS
    src = Path(tfa.__file__).parents[2] / "csrc"
    assert (src / "flash_attention_fwd.cu").exists()
    assert '#include "wgmma.cuh"' in (
        src / "flash_attention_fwd.cu").read_text()
    (csrc / "flash_attention_fwd.cu").write_text("// v1\n")
    (csrc / "wgmma.cuh").write_text("// h1\n")
    took = _build_mod.build(("flash_attention_fwd",))
    lib = _build_mod._target("flash_attention_fwd")[1]
    assert took["flash_attention_fwd"] > 0 and lib.exists()
    assert "-gencode arch=compute_90a,code=sm_90a" in lib.read_text()
    assert _build_mod.build(("flash_attention_fwd",)) == {
        "flash_attention_fwd": 0.0}
    (csrc / "wgmma.cuh").write_text("// h2\n")
    assert _build_mod._target("flash_attention_fwd")[1] != lib
    (csrc / "wgmma.cuh").write_text("// h1\n")
    (csrc / "flash_attention_fwd.cu").write_text("// v2\n")
    assert _build_mod._target("flash_attention_fwd")[1] != lib
