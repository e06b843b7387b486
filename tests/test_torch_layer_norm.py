"""The LayerNorm wrapper's launch plan, on the CPU.

`mxnet_tpu_torch/ops/pallas_kernels/layer_norm.py` plans each launch of
`csrc/layer_norm.cu` in Python (`_plan_fwd`, `_plan_bwd`) and hands the
plan to the C entries, which check it and launch it.  The kernels run
only on the card (`chip_smoke.py` holds them against the plain versions
there); these tests hold the plan to what the kernels assume: every row
covered once, every element of a row loaded once by the vector layout, a
vector width that divides the row and every pointer, the documented
layout at each width, a (blocks, N) backward workspace, no empty block,
and the backward's split and order of sums (a float32 model of the
kernels' partial sums against the plain backward's).  With the C library
faked, the wrappers hand the plan to the entries before any launch and
count one launch a call.  The LayerNorm parity tests against the JAX
package are in `tests/test_torch_kernels.py` and `tests/test_torch_ops.py`.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops.pallas_kernels import layer_norm as tln

SMS = 132  # the H100's SMs
ROWS = (1, 7, 8, 131, 132, 1000, 32768)
WIDTHS = (1, 5, 30, 768, 1000, 1024, 1600, 8192, 8193, 12300, 16384)
DTYPES = (torch.float32, torch.bfloat16)


def _occ(*plan):
    return 2


def _row_elements(plan, n, itemsize):
    """Every element index a row's team loads, one entry per load: chunk c
    of thread t at (c * 32 * warps + t) * VW, VW elements (the wide
    layout: every 32 * warps * VW-th from t * VW on)."""
    vw = plan.vec_bytes // itemsize
    tpr = 32 * plan.warps
    if plan.layout == "wide":
        starts = range(0, n, tpr * vw)
        return [i + t * vw + e for i in starts for t in range(tpr)
                for e in range(vw) if i + t * vw < n]
    return [(c * tpr + t) * vw + e for c in range(plan.ept // vw)
            for t in range(tpr) for e in range(vw)
            if (c * tpr + t) * vw < n]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", WIDTHS)
def test_forward_plan_covers_every_row_and_element_once(dtype, n):
    itemsize = dtype.itemsize
    for rows in ROWS:
        plan = tln._plan_fwd(rows, n, dtype, 16, SMS)
        assert plan.workspace is None
        per = plan.rows_per_block
        assert per >= 1 and 32 * plan.warps * per <= tln._THREADS
        # no empty block, and every row in one
        assert (plan.blocks - 1) * per < rows <= plan.blocks * per
        loaded = _row_elements(plan, n, itemsize)
        assert sorted(loaded) == list(range(n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", WIDTHS)
def test_backward_plan_splits_every_row_once(dtype, n):
    for rows in ROWS:
        plan = tln._plan_bwd(rows, n, dtype, 16, SMS, _occ)
        teams = plan.blocks * plan.rows_per_block
        assert plan.workspace == (plan.blocks, n)
        assert 1 <= teams <= rows  # no team, so no block, without a row
        assert 32 * plan.warps * plan.rows_per_block <= tln._THREADS
        split = tln._bwd_split(rows, teams)
        assert sorted(r for team in split for r in team) == list(
            range(rows))
        assert min(map(len, split)) >= 1
        assert plan.blocks <= SMS * _occ()
        assert sorted(_row_elements(plan, n, dtype.itemsize)) == list(
            range(n))


# (dtype, pointer alignment): every alignment a tensor of the dtype has
ALIGNED = [(torch.float32, a) for a in (16, 8, 4)] + [
    (torch.bfloat16, a) for a in (16, 8, 4, 2)]


@pytest.mark.parametrize("dtype,align", ALIGNED)
@pytest.mark.parametrize("n", (1, 2, 3, 6, 30, 768, 770, 12300, 16384))
def test_vector_width_divides_the_row_and_every_pointer(dtype, align, n):
    itemsize = dtype.itemsize
    for plan in (tln._plan_fwd(4096, n, dtype, align, SMS),
                 tln._plan_bwd(4096, n, dtype, align, SMS, _occ)):
        vec = plan.vec_bytes
        assert vec in (16, 8, 4, 2) and vec >= itemsize
        assert (n * itemsize) % vec == 0 and align % vec == 0
        # the widest such: twice as wide would break one of the two
        if vec < 16:
            assert (n * itemsize) % (2 * vec) or align % (2 * vec)


def test_alignment_of_pointers():
    assert tln._alignment(0x1000, 0x2010) == 16
    assert tln._alignment(0x1000, 0x2008) == 8
    assert tln._alignment(0x1004, 0x2000) == 4
    assert tln._alignment(0x1002) == 2
    assert tln._alignment(0x1001, 0x2000) == 1


# N -> (layout, warps, elements a thread holds) at 16-byte vectors and
# many rows; the same in both dtypes
DOCUMENTED = {30: ("warp", 1, 8), 768: ("warp", 1, 24),
              1000: ("warp", 1, 32), 1024: ("warp", 1, 32),
              8192: ("warps", 8, 32), 8193: ("wide", 8, None),
              16384: ("wide", 8, None)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", sorted(DOCUMENTED))
def test_documented_layout_at_each_width(dtype, n):
    layout, warps, ept = DOCUMENTED[n]
    fwd = tln._plan_fwd(32768, n, dtype, 16, SMS)
    bwd = tln._plan_bwd(32768, n, dtype, 16, SMS, _occ)
    for plan in (fwd, bwd):
        assert (plan.layout, plan.warps, plan.ept) == (layout, warps, ept)
    # a warp a row: 8 rows a block forward, 8 teams a block backward
    assert fwd.rows_per_block == (8 if layout == "warp" else 1)
    assert bwd.rows_per_block == (8 if layout == "warp" else 1)
    # N = 30 cannot take 16-byte vectors in either dtype; 8193 only single
    # elements
    want = {30: 8 if dtype == torch.float32 else 4, 8193: dtype.itemsize}
    assert fwd.vec_bytes == want.get(n, 16)
    # fewer rows than SMs (decode): a block of 8 warps a row, up to 8192;
    # fewer than 8 an SM (a prefill's 1000): at least 4 warps a row
    few = tln._plan_fwd(8, n, dtype, 16, SMS)
    assert (few.layout, few.warps, few.rows_per_block, few.blocks) == (
        ("wide", 8, 1, 8) if n > tln._REGISTER_N else ("warps", 8, 1, 8))
    mid = tln._plan_fwd(1000, n, dtype, 16, SMS)
    assert (mid.layout, mid.warps, mid.blocks) == (
        ("wide", 8, 1000) if n > tln._REGISTER_N else
        ("warps", 8 if n > 4096 else 4, 1000))


def test_plan_constants_match_the_kernel_source():
    """The plan's block size, register templates and layout codes are the
    ones `csrc/layer_norm.cu` instantiates and checks."""
    src = (Path(tln.__file__).parents[2] / "csrc" / "layer_norm.cu"
           ).read_text()
    assert "constexpr int kThreads = %d;" % tln._THREADS in src
    assert "constexpr int kMaxEpt = %d;" % tln._EPT[-1] in src
    assert tln._REGISTER_N == tln._THREADS * tln._EPT[-1]
    dispatch = src[src.index("FwdFn<T> fwd_fn("):
                   src.index("BwdFn<T> bwd_fn(")]
    assert tuple(int(e) for e in re.findall(r"case (\d+):", dispatch)) == \
        tln._EPT
    assert "if (layout == %d) return ln_fwd_wide_kernel" % \
        tln._LAYOUTS["wide"] in src


@pytest.mark.parametrize("sms", (1, 66, 132))
@pytest.mark.parametrize("rows", (9, 513, 4099))
def test_backward_order_of_sums_matches_the_plain_sums(rows, sms):
    """dgamma and dbeta as the kernels sum them: each team over its rows in
    order, the block's teams in team order, the blocks' partial rows by
    the reduction kernel (32 slices of every 32nd block, then the slices in
    order), against the plain backward's sums."""
    n = 24
    rng = np.random.RandomState(rows)
    x = rng.randn(rows, n).astype(np.float32)
    dy = rng.randn(rows, n).astype(np.float32)
    g = (1 + 0.1 * rng.randn(n)).astype(np.float32)
    mean = x.mean(1, keepdims=True)
    rstd = 1 / np.sqrt(((x - mean) ** 2).mean(1, keepdims=True) + 1e-5)
    xt, gt, dyt = (torch.from_numpy(a) for a in (x, g, dy))
    _, want_g, want_b = tln._bwd_plain(
        xt, gt, torch.from_numpy(mean), torch.from_numpy(rstd), dyt)
    plan = tln._plan_bwd(rows, n, torch.float32, 16, sms, _occ)
    teams = plan.blocks * plan.rows_per_block
    terms_g = dy * (x - mean) * rstd
    part = np.zeros((2, plan.blocks, n), np.float32)
    for k, team in enumerate(tln._bwd_split(rows, teams)):
        sg, sb = np.zeros(n, np.float32), np.zeros(n, np.float32)
        for r in team:
            sg += terms_g[r]
            sb += dy[r]
        part[:, k // plan.rows_per_block] += (sg, sb)  # team order
    slices = np.stack([part[:, s::32].sum(1) for s in range(32)], 1)
    got = slices.sum(1)
    np.testing.assert_allclose(got[0], want_g.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want_b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture()
def fake_lib(monkeypatch):
    """`_lib` replaced by a fake library whose entries record their
    arguments and launch nothing (the occupancy query answers 2 blocks an
    SM); 132 SMs; the device and stream lookups answered for CPU
    tensors."""
    calls = []

    def occupancy(*a):
        calls.append(("occupancy",) + a[:-1])
        a[-1]._obj.value = 2
        return 0

    monkeypatch.setattr(tln, "_lib", lambda: types.SimpleNamespace(
        mxt_layer_norm_fwd=lambda *a: calls.append(("fwd",) + a) or 0,
        mxt_layer_norm_bwd=lambda *a: calls.append(("bwd",) + a) or 0,
        mxt_layer_norm_bwd_occupancy=occupancy))
    monkeypatch.setattr(tln, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(tln._build, "check_current_device",
                        lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    tln._occupancy_cache.clear()
    tln._bwd_plan_on.cache_clear()
    tln._fwd_args.cache_clear()
    yield calls
    tln._occupancy_cache.clear()
    tln._bwd_plan_on.cache_clear()
    tln._fwd_args.cache_clear()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n,offset", [(300, 768, 0), (8, 768, 0),
                                           (300, 768, 1), (5, 30, 0),
                                           (3, 12300, 0)])
def test_wrappers_hand_the_plan_to_the_entries(fake_lib, dtype, rows, n,
                                               offset):
    """Each pass hands its plan to its C entry, one call and one counted
    launch each; a view whose data starts ``offset`` elements past an
    aligned base runs at the narrower vector its pointers allow."""
    x = torch.zeros(rows * n + offset, dtype=dtype)[offset:].view(rows, n)
    g, b = torch.ones(n, dtype=dtype), torch.zeros(n, dtype=dtype)
    before = tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches
    _, mean, rstd = tln._fwd_cuda(x, g, b, 1e-5)
    tln._bwd_cuda(x, g, mean, rstd, x)
    assert (tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    fwd = [c for c in fake_lib if c[0] == "fwd"]
    bwd = [c for c in fake_lib if c[0] == "bwd"]
    assert len(fwd) == len(bwd) == 1
    align = tln._alignment(x.data_ptr(), g.data_ptr(), b.data_ptr())
    pf = tln._plan_fwd(rows, n, dtype, min(align, 16), SMS)
    pb = tln._plan_bwd(rows, n, dtype, min(align, 16), SMS, _occ)
    assert fwd[0][8:10] == (rows, n) and fwd[0][11:17] == tln._plan_args(pf)
    assert bwd[0][12:14] == (rows, n) and bwd[0][14:20] == tln._plan_args(pb)
    if offset:  # one element past a 16-byte boundary: single elements
        assert pf.vec_bytes == pb.vec_bytes == dtype.itemsize
    # the workspace the backward hands over holds (blocks, N) twice
    assert pb.workspace == (pb.blocks, n)


def test_zero_rows_launch_nothing(fake_lib):
    x = torch.zeros(0, 64)
    one = torch.ones(64)
    before = tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches
    y, mean, rstd = tln._fwd_cuda(x, one, one, 1e-5)
    dx, dg, db = tln._bwd_cuda(x, one, mean, rstd, x)
    assert y.shape == (0, 64) and mean.shape == (0, 1)
    assert not dg.any() and not db.any()
    assert fake_lib == []
    assert (tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches) == \
        before


def test_an_entry_that_refuses_the_plan_raises(fake_lib, monkeypatch):
    """A plan the C entry refuses (cudaErrorInvalidValue, 1) raises through
    `_build.check` and counts no launch; there is no fallback."""
    lib = tln._lib()
    monkeypatch.setattr(tln, "_lib", lambda: types.SimpleNamespace(
        mxt_layer_norm_fwd=lambda *a: 1,
        mxt_layer_norm_bwd_occupancy=lib.mxt_layer_norm_bwd_occupancy))
    before = tln.layer_norm_fwd.launches
    with pytest.raises(tln.MXNetError, match="layer_norm launch"):
        tln._fwd_cuda(torch.zeros(4, 64), torch.ones(64), torch.ones(64),
                      1e-5)
    assert tln.layer_norm_fwd.launches == before
