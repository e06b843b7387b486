"""The port's kernel modules against the JAX package's functions, on the CPU.

`mxnet_tpu_torch.ops.pallas_kernels` holds, for each Pallas kernel of
the serving and training paths, a CUDA kernel and a plain PyTorch version
beside it; a CPU tensor takes the plain version.  These tests feed the
same numpy inputs (made from a seed) to the plain versions and to the JAX
package: its public functions (which take their jnp bodies on the CPU),
their gradients under `jax.vjp`, and the Pallas kernel bodies themselves,
run in interpret mode the way `tests/test_pallas_interpret.py` runs them.
The CUDA kernels are held against the same plain versions on the card by
`chip_smoke.py`.

Tolerances: everything compares float32 against float32 with the same
formulas, so the only difference is the order of the sums (torch's
reductions vs XLA's, 256-key vs the JAX block size); 1e-5 absolute on
values of magnitude ~1 is ~100 float32 ulp and still catches any wrong
mask, offset or statistic.  Gradients sum over up to 70 keys or 300 rows
of products of such values, so they are held at 1e-4 (`GRAD_ATOL`).
"""
import functools
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import flash_attention_mod as jfa
from mxnet_tpu.ops.pallas_kernels import layer_norm as jln
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa
from mxnet_tpu_torch.ops.pallas_kernels import layer_norm as tln


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one intra-op thread for the whole module: the port's
    tests run many small ops, and the OpenMP team's spinning costs most
    when the suite's workers share the machine.  Other modules take it
    by name (``from test_torch_kernels import _one_thread``).  Restored
    for the worker's next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
GRAD_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


# -- LayerNorm ---------------------------------------------------------------


def _ln_inputs(rows, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, n) * 2 + 0.5
    x[0] *= 1e-3  # a row whose variance is below eps: eps must be added
    x = x.astype(np.float32)
    g = (1 + 0.1 * rng.randn(n)).astype(np.float32)
    b = (0.1 * rng.randn(n)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("rows,n", [(8, 32), (37, 96), (3, 768)])
def test_layer_norm_plain_matches_jax(rows, n):
    x, g, b = _ln_inputs(rows, n)
    want = np.asarray(jln.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), 1e-5))
    got = tln.layer_norm(_t(x), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    # the statistics the backward slice will read: (rows, 1) float32
    y, mean, rstd = tln.layer_norm_fwd(_t(x), _t(g), _t(b), 1e-5)
    jy, jmean, jrstd = jln._fwd_jnp(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b), 1e-5)
    assert mean.shape == (rows, 1) and rstd.shape == (rows, 1)
    assert mean.dtype == torch.float32 and rstd.dtype == torch.float32
    np.testing.assert_allclose(_np(mean), np.asarray(jmean), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(_np(rstd), np.asarray(jrstd), rtol=1e-5)


def test_layer_norm_leading_axes_and_bf16():
    """Any leading shape reshapes to (rows, N); bf16 in gives bf16 out with
    float32 statistics (compared after the same bf16 rounding in JAX)."""
    x, g, b = _ln_inputs(2 * 5, 64, seed=1)
    x3 = x.reshape(2, 5, 64)
    got = tln.layer_norm(_t(x3), _t(g), _t(b))
    want = np.asarray(jln.layer_norm(jnp.asarray(x3), jnp.asarray(g),
                                     jnp.asarray(b)))
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    xb = _t(x).to(torch.bfloat16)
    yb = tln.layer_norm(xb, _t(g).to(torch.bfloat16),
                        _t(b).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    jb = np.asarray(jln.layer_norm(jnp.asarray(_np(xb), jnp.bfloat16),
                                   jnp.asarray(g, jnp.bfloat16),
                                   jnp.asarray(b, jnp.bfloat16)
                                   ).astype(jnp.float32))
    # one bf16 ulp (2**-7 relative) where the two round a float32 tie
    # differently
    np.testing.assert_allclose(_np(yb), jb, rtol=2 ** -7, atol=1e-6)


@pytest.fixture()
def ln_interpret(monkeypatch):
    """Run the JAX LayerNorm's `pl.pallas_call` in interpret mode without
    touching the package: its module-level `pl` is swapped for a shim."""
    if not jln._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    pl = jln.pl
    monkeypatch.setattr(jln, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when))


@pytest.mark.parametrize("rows,n", [(5, 128), (300, 256), (3, 8320)])
def test_layer_norm_plain_matches_pallas_body(ln_interpret, rows, n):
    x, g, b = _ln_inputs(rows, n, seed=2)
    jy, jmean, jrstd = jln._fwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                       jnp.asarray(b), 1e-5)
    y, mean, rstd = tln.layer_norm_fwd(_t(x), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(mean), np.asarray(jmean), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(_np(rstd), np.asarray(jrstd), rtol=1e-5)


def test_layer_norm_cpu_takes_plain_version_and_counts_nothing():
    x, g, b = _ln_inputs(4, 32)
    before = tln.layer_norm_fwd.launches
    tln.layer_norm(_t(x), _t(g), _t(b))
    assert tln.layer_norm_fwd.launches == before


def test_layer_norm_kernel_arguments_checked_before_launch(monkeypatch):
    """What the CUDA wrapper refuses, it refuses before building or
    launching anything (the checks run on any tensor).  A row wider than
    the register layouts hold (N = 8320) is no longer refused: with the C
    library faked, both passes hand it to their C entries with the wide
    layout's plan (layout 2, 8 warps, one row a block; the backward on
    persistent blocks with its (blocks, N) workspace), and count one
    launch each."""
    x, g, b = _ln_inputs(2, 32)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        tln._fwd_cuda(_t(x).half(), _t(g).half(), _t(b).half(), 1e-5)
    with pytest.raises(MXNetError, match="x's dtype"):
        tln._fwd_cuda(_t(x), _t(g).to(torch.bfloat16), _t(b), 1e-5)
    with pytest.raises(MXNetError, match="must be"):
        tln._fwd_cuda(_t(x), _t(g)[:16], _t(b), 1e-5)
    with pytest.raises(MXNetError, match="N >= 1"):
        tln._fwd_cuda(torch.zeros(2, 0), torch.ones(0), torch.ones(0), 1e-5)
    with pytest.raises(MXNetError, match="rows, N"):
        tln.layer_norm_fwd(_t(x)[None], _t(g), _t(b))
    calls = []

    def occupancy(*a):
        a[-1]._obj.value = 2
        return 0
    monkeypatch.setattr(tln, "_lib", lambda: types.SimpleNamespace(
        mxt_layer_norm_fwd=lambda *a: calls.append(
            ("fwd", a[7], a[8]) + a[10:16]) or 0,
        mxt_layer_norm_bwd=lambda *a: calls.append(
            ("bwd", a[11], a[12]) + a[13:19]) or 0,
        mxt_layer_norm_bwd_occupancy=occupancy))
    monkeypatch.setattr(tln, "_sm_count", lambda index: 4)
    tln._occupancy_cache.clear()
    tln._bwd_plan_on.cache_clear()  # plans made for another SM count
    tln._fwd_args.cache_clear()
    monkeypatch.setattr(tln._build, "check_current_device",
                        lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    n = 8320
    assert n > tln._REGISTER_N
    wide, one = torch.zeros(3, n), torch.ones(n)
    before = tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches
    _, mean, rstd = tln._fwd_cuda(wide, one, one, 1e-5)
    tln._bwd_cuda(wide, one, mean, rstd, wide)
    # (layout, vec_bytes, ept, warps, rows a block, blocks): 3 rows of 3
    # blocks forward; backward min(4 SMs * 2, 3 rows) blocks
    assert calls == [("fwd", 3, n, 2, 16, 0, 8, 1, 3),
                     ("bwd", 3, n, 2, 16, 0, 8, 1, 3)]
    assert (tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def _ln_bwd_inputs(rows, n, seed):
    x, g, b = _ln_inputs(rows, n, seed)
    dy = np.random.RandomState(seed + 100).randn(rows, n).astype(np.float32)
    _, mean, rstd = jln._fwd_jnp(jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(b), 1e-5)
    return x, g, np.array(mean), np.array(rstd), dy


def _assert_ln_bwd(got, want):
    # row 0 of `_ln_inputs` is nearly constant, so its rstd, and its dx,
    # reach ~1e3: held relatively there (1e-5, ~100 float32 ulp)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("rows,n", [(8, 32), (37, 96), (300, 768)])
def test_layer_norm_bwd_plain_matches_jax(rows, n):
    args = _ln_bwd_inputs(rows, n, seed=rows)
    want = jln._bwd_jnp(*(jnp.asarray(a) for a in args))
    got = tln.layer_norm_bwd(*(_t(a) for a in args))
    assert got[0].dtype == torch.float32 and got[1].shape == (n,)
    _assert_ln_bwd(got, want)


@pytest.mark.parametrize("rows,n", [(5, 128), (300, 256), (3, 8320)])
def test_layer_norm_bwd_plain_matches_pallas_body(ln_interpret, rows, n):
    """The TPU kernel carries dgamma/dbeta across its sequential grid (two
    256-row blocks at 300 rows); the sums agree with the plain version's
    one reduction.  8320 is wider than the CUDA register kernels hold: the
    row width the wide-row kernels serve."""
    args = _ln_bwd_inputs(rows, n, seed=3)
    want = jln._bwd_pallas(*(jnp.asarray(a) for a in args))
    got = tln.layer_norm_bwd(*(_t(a) for a in args))
    _assert_ln_bwd(got, want)


def test_layer_norm_grads_match_jax_vjp():
    """The autograd `Function` against `jax.vjp` of the public function,
    leading axes included."""
    x, g, b = _ln_inputs(2 * 7, 48, seed=4)
    x = x.reshape(2, 7, 48)
    dy = np.random.RandomState(5).randn(2, 7, 48).astype(np.float32)
    y_j, vjp = jax.vjp(lambda *a: jln.layer_norm(*a, 1e-5),
                       *(jnp.asarray(a) for a in (x, g, b)))
    want = vjp(jnp.asarray(dy))
    xt, gt, bt = (_t(a).requires_grad_() for a in (x, g, b))
    y = tln.layer_norm(xt, gt, bt, 1e-5)
    y.backward(_t(dy))
    np.testing.assert_allclose(_np(y.detach()), np.asarray(y_j), atol=ATOL,
                               rtol=0)
    _assert_ln_bwd((xt.grad, gt.grad, bt.grad), want)


def test_layer_norm_bf16_grads_take_the_parameters_dtype():
    """As `_ln_bwd_vjp`: dx in x's dtype, dgamma and dbeta cast to gamma's;
    under `no_grad` the forward records nothing."""
    x, g, b = (_t(a).to(torch.bfloat16) for a in _ln_inputs(6, 64, seed=6))
    xt, gt, bt = (a.clone().requires_grad_() for a in (x, g, b))
    tln.layer_norm(xt, gt, bt).float().sum().backward()
    assert {t.grad.dtype for t in (xt, gt, bt)} == {torch.bfloat16}
    with torch.no_grad():
        assert tln.layer_norm(xt, gt, bt).grad_fn is None


def test_layer_norm_bwd_cpu_takes_plain_version_and_counts_nothing():
    args = _ln_bwd_inputs(4, 32, seed=7)
    before = tln.layer_norm_bwd.launches
    tln.layer_norm_bwd(*(_t(a) for a in args))
    assert tln.layer_norm_bwd.launches == before


def test_layer_norm_bwd_chunks_cover_every_row_once():
    """The backward's row split (`_plan_bwd`, `_bwd_split`): persistent
    blocks of teams, team k over rows k, k + teams, ..., none empty, at
    most one row more a team than a full card's teams would take, covering
    every row once, at several SM counts."""
    for sms in (1, 78, 114, 132):
        for rows in (1, 7, 511, 512, 513, 32768, 100003):
            plan = tln._plan_bwd(rows, 768, torch.bfloat16, 16, sms,
                                 lambda *a: 2)
            teams = plan.blocks * plan.rows_per_block
            assert 1 <= teams <= rows
            split = tln._bwd_split(rows, teams)
            assert sorted(r for team in split for r in team) == list(
                range(rows))
            assert min(len(team) for team in split) >= 1
            assert max(len(team) for team in split) == -(
                -rows // teams) <= 1 + -(
                -rows // min(rows, sms * 2 * plan.rows_per_block))


# -- flash attention ----------------------------------------------------------


def _qkv(b, h, sq, skv, d, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, sq, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, h, skv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, h, skv, d) * 0.5).astype(np.float32)
    return q, k, v


def _visible(sq, skv, causal, q_off, k_off):
    """(sq,) bool: the query rows that see at least one key."""
    if not causal:
        return np.full(sq, skv > 0)
    return q_off + np.arange(sq) >= k_off


# (sq, skv, causal, q_offset, k_offset): square causal, ragged tails,
# Sq != Skv both ways, offsets (a chunk of a longer prompt), and rows that
# see no key at all (q_offset < k_offset)
FLASH_CASES = [
    (32, 32, True, 0, 0),
    (45, 45, True, 0, 0),
    (24, 70, True, 46, 0),
    (40, 72, False, 0, 0),
    (50, 30, False, 7, 3),
    (48, 40, True, 0, 20),
]


@pytest.mark.parametrize("sq,skv,causal,q_off,k_off", FLASH_CASES)
def test_flash_plain_matches_jax(sq, skv, causal, q_off, k_off):
    q, k, v = _qkv(2, 2, sq, skv, 16, seed=sq + skv)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, with_lse=True)
    jo, jl = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    o, lse = tfa.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    assert lse.dtype == torch.float32
    seen = _visible(sq, skv, causal, q_off, k_off)
    np.testing.assert_allclose(_np(o)[:, :, seen], np.asarray(jo)[:, :, seen],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(lse)[:, :, seen],
                               np.asarray(jl)[:, :, seen], atol=ATOL, rtol=0)
    # a row that sees no key: out 0 and lse = m + log 1 = -1e30, never NaN
    # (the JAX jnp body gives such a row the mean of a visited block's V,
    # which depends on its block size; the TPU kernel skips the block and
    # gives 0, as here)
    assert np.isfinite(_np(o)).all() and np.isfinite(_np(lse)).all()
    assert (_np(o)[:, :, ~seen] == 0).all()
    assert (_np(lse)[:, :, ~seen] == np.float32(-1e30)).all()


def test_flash_default_scale_and_out_dtype():
    q, k, v = _qkv(1, 3, 20, 20, 64, seed=5)
    o = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    o2 = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                             scale=1.0 / math.sqrt(64))
    assert torch.equal(o, o2)
    ob = tfa.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                             _t(v).bfloat16(), causal=True)
    assert ob.dtype == torch.bfloat16


@pytest.fixture()
def flash_interpret(monkeypatch):
    if not jfa._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfa, "_INTERPRET", True)


@pytest.mark.parametrize("sq,skv,causal,q_off,k_off", [
    (45, 45, True, 0, 0),
    (24, 70, True, 46, 0),
    (40, 72, False, 0, 0),
    (48, 40, True, 0, 16),
])
def test_flash_plain_matches_pallas_body(flash_interpret, sq, skv, causal,
                                         q_off, k_off):
    """The TPU kernel body itself (interpret mode), blocks of 16: query
    blocks whose every row sees no key skip the K loop and give out 0,
    lse -1e30, as the port does for every such row."""
    q, k, v = _qkv(1, 2, sq, skv, 64, seed=sq)
    scale = 1.0 / math.sqrt(64)
    jo, jl = jfa._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_off, k_off, scale,
                                   causal, 16, 16)
    o, lse = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 q_offset=q_off, k_offset=k_off,
                                 with_lse=True)
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(lse), np.asarray(jl), atol=ATOL, rtol=0)


def test_flash_strided_views_match_contiguous():
    """The serving prefill hands the kernel (b, s, h, d) -> (b, h, s, d)
    transposed views; the result is that of contiguous copies."""
    rng = np.random.RandomState(3)
    x = _t(rng.randn(3, 2, 20, 4, 16).astype(np.float32))  # (qkv, b, s, h, d)
    q, k, v = (t.transpose(1, 2) for t in x)
    o = tfa.flash_attention(q, k, v, causal=True)
    oc = tfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    torch.testing.assert_close(o, oc, atol=1e-6, rtol=0)


def test_flash_cpu_takes_plain_version_and_counts_nothing():
    q, k, v = _qkv(1, 1, 8, 8, 64)
    before = tfa.flash_attention.launches
    tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert tfa.flash_attention.launches == before


def test_flash_kernel_arguments_checked_before_launch():
    q, k, v = (_t(a) for a in _qkv(1, 2, 8, 8, 64))
    with pytest.raises(MXNetError, match="head_dim"):
        tfa._check_cuda_args(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(MXNetError, match="all"):
        tfa._check_cuda_args(q, k.bfloat16(), v)
    with pytest.raises(MXNetError, match="must be"):
        tfa._check_cuda_args(q, k[:, :1], v[:, :1])
    # a last axis that is not contiguous is no longer refused: the kernel
    # wrappers copy such an operand (`_readable`) before the launch
    qt = q.transpose(2, 3).contiguous().transpose(2, 3)
    assert qt.stride(3) != 1
    assert tfa._readable(qt).stride(3) == 1 and torch.equal(
        tfa._readable(qt), qt)
    with pytest.raises(MXNetError, match="whole number"):
        tfa.flash_attention(q, k, v, causal=True, q_offset=1.5)
    with pytest.raises(MXNetError, match="B, H, S, D"):
        tfa.flash_attention(q[0], k, v)


def _cotangents(shape, seed):
    """Random cotangents of (out, lse) for an out of ``shape``."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(*shape) * 0.5).astype(np.float32)
    glse = (rng.randn(*shape[:-1]) * 0.5).astype(np.float32)
    return g, glse


def _torch_grads(fn, q, k, v, g, glse, *args, **kw):
    """out, lse and (dq, dk, dv) of ``fn`` through autograd, with both
    cotangents."""
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o, lse = fn(qt, kt, vt, *args, with_lse=True, **kw)
    torch.autograd.backward((o, lse), (_t(g), _t(glse)))
    return o.detach(), lse.detach(), (qt.grad, kt.grad, vt.grad)


def _assert_grads(got, want, what=""):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=0, err_msg=what + name)


@pytest.mark.parametrize("sq,skv,causal,q_off,k_off", FLASH_CASES)
def test_flash_bwd_plain_matches_jax_vjp(sq, skv, causal, q_off, k_off):
    """Gradients through (out, lse), the lse cotangent included, against
    `jax.vjp` of the JAX function (its `_flash_bwd` on the CPU).  JAX's
    recurrence weights a row that sees no key as the forward test says, so
    such rows get zero cotangents here; the Pallas-body test below covers
    them."""
    q, k, v = _qkv(2, 2, sq, skv, 16, seed=sq + skv + 1)
    g, glse = _cotangents(q.shape, seed=sq)
    seen = _visible(sq, skv, causal, q_off, k_off)
    g[:, :, ~seen] = 0
    glse[:, :, ~seen] = 0
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    _, vjp = jax.vjp(
        lambda *a: jfa.flash_attention(*a, with_lse=True, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(g), jnp.asarray(glse)))
    _, _, got = _torch_grads(tfa.flash_attention, q, k, v, g, glse, **kw)
    _assert_grads(got, want)


@pytest.mark.parametrize("sq,skv,causal,q_off,k_off", [
    (45, 45, True, 0, 0),
    (24, 70, True, 46, 0),
    (48, 40, True, 0, 16),
])
def test_flash_bwd_plain_matches_pallas_body(flash_interpret, sq, skv,
                                             causal, q_off, k_off):
    """`_flash_bwd_pallas` itself (interpret mode, blocks of 16), every row
    with a cotangent: rows that see no key get zero gradients in both."""
    q, k, v = _qkv(1, 2, sq, skv, 64, seed=sq + 1)
    g, glse = _cotangents(q.shape, seed=skv)
    scale = 1.0 / math.sqrt(64)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    qo, ko = jnp.asarray(q_off, jnp.int32), jnp.asarray(k_off, jnp.int32)
    jo, jl = jfa._flash_fwd_pallas(jq, jk, jv, qo, ko, scale, causal, 16, 16)
    want = jfa._flash_bwd_pallas(scale, causal, 16, 16,
                                 (jq, jk, jv, jo, jl, qo, ko),
                                 (jnp.asarray(g), jnp.asarray(glse)))[:3]
    _, _, got = _torch_grads(tfa.flash_attention, q, k, v, g, glse,
                             causal=causal, q_offset=q_off, k_offset=k_off)
    _assert_grads(got, want)


def _bsd_qkv(b, sq, skv, e, seed):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(b, s, e) * 0.5).astype(np.float32)
                 for s in (sq, skv, skv))


@pytest.mark.parametrize("e,heads,sq,skv,causal,q_off,k_off", [
    (32, 2, 24, 24, True, 0, 0),
    (128, 2, 20, 36, False, 5, 2),
    (128, 2, 30, 30, True, 0, 0),
])
def test_flash_bsd_matches_jax(e, heads, sq, skv, causal, q_off, k_off):
    """`flash_attention_bsd` (a (B, H, S, D) view of (B, S, E) operands into
    the same Function) against the JAX function's head-split jnp path:
    out (B, S, E), lse (B, H, S) and the gradients of both."""
    q, k, v = _bsd_qkv(2, sq, skv, e, seed=e + sq)
    g, _ = _cotangents(q.shape, seed=sq)
    glse = _cotangents((2, heads, sq, 1), seed=skv)[1]
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    (jo, jl), vjp = jax.vjp(
        lambda *a: jfa.flash_attention_bsd(*a, heads, with_lse=True, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(g), jnp.asarray(glse)))
    o, lse, got = _torch_grads(tfa.flash_attention_bsd, q, k, v, g, glse,
                               heads, **kw)
    assert o.shape == q.shape and lse.shape == (2, heads, sq)
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(lse), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_grads(got, want)


def test_flash_bsd_matches_pallas_body(flash_interpret):
    """Rows 7 and 8 of the kernel table, `_flash_fwd_pallas_bsd` and
    `_flash_bwd_pallas_bsd` (interpret mode, head width 128, blocks of
    128), against `flash_attention_bsd`."""
    heads, d, s = 2, 128, 128
    q, k, v = _bsd_qkv(1, s, s, heads * d, seed=11)
    g, _ = _cotangents(q.shape, seed=12)
    glse = _cotangents((1, heads, s, 1), seed=13)[1]
    scale = 1.0 / math.sqrt(d)
    zero = jnp.asarray(0, jnp.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo, jl = jfa._flash_fwd_pallas_bsd(jq, jk, jv, zero, zero, scale, True,
                                       128, 128, heads)
    want = jfa._flash_bwd_pallas_bsd(
        scale, True, 128, 128, heads, (jq, jk, jv, jo, jl, zero, zero),
        (jnp.asarray(g), jnp.asarray(glse)))[:3]
    o, lse, got = _torch_grads(tfa.flash_attention_bsd, q, k, v, g, glse,
                               heads, causal=True)
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(lse), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_grads(got, want)


def test_flash_bwd_strided_views_match_contiguous():
    """Gradients through transposed (b, s, h, d) -> (b, h, s, d) views, as
    the bhsd training graph hands them over, equal those of contiguous
    copies."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 2, 20, 4, 16).astype(np.float32)  # (qkv, b, s, h, d)
    g = _t(rng.randn(2, 4, 20, 16).astype(np.float32))
    grads = []
    for contiguous in (False, True):
        leaf = _t(x).requires_grad_()
        q, k, v = (t.transpose(1, 2) for t in leaf)
        if contiguous:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        tfa.flash_attention(q, k, v, causal=True).backward(g)
        grads.append(leaf.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-6, rtol=0)


def test_flash_bwd_cpu_takes_plain_version_and_counts_nothing():
    q, k, v = (_t(a).requires_grad_() for a in _qkv(1, 1, 8, 8, 64))
    counts = lambda: [getattr(f, c) for f in (tfa.flash_attention,  # noqa
                                              tfa.flash_attention_bsd)
                      for c in ("launches", "dq_launches", "dkv_launches")]
    before = counts()
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    tfa.flash_attention_bsd(q[0], k[0], v[0], 1).sum().backward()
    assert counts() == before


# -- the kernel build ---------------------------------------------------------

_FAKE_NVCC = """#!%s
import sys
args = sys.argv[1:]
src = open(args[-1]).read()
if "broken" in src:
    print("error: broken source")
    sys.exit(1)
with open(args[args.index("-o") + 1], "w") as f:
    f.write(" ".join(args))
"""


@pytest.fixture()
def fake_toolchain(tmp_path, monkeypatch):
    """`_build` pointed at sources and a build directory under tmp_path,
    with an `nvcc` on PATH that records its arguments as the library."""
    from mxnet_tpu_torch.ops.pallas_kernels import _build
    csrc, bindir = tmp_path / "csrc", tmp_path / "bin"
    csrc.mkdir()
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(_FAKE_NVCC % sys.executable)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "%s%s%s" % (bindir, os.pathsep,
                                           os.environ.get("PATH", "")))
    return _build, csrc


def test_build_compiles_for_sm90a_once_per_source_hash(fake_toolchain):
    _build, csrc = fake_toolchain
    (csrc / "layer_norm.cu").write_text("// v1\n")
    took = _build.build(("layer_norm",))
    lib = _build._target("layer_norm")[1]
    assert took["layer_norm"] > 0 and lib.exists()
    cmd = lib.read_text()
    for flag in ("-gencode arch=compute_90a,code=sm_90a", "-O3", "-shared",
                 "-Xcompiler -fPIC"):
        assert flag in cmd
    assert _build.build(("layer_norm",)) == {"layer_norm": 0.0}
    (csrc / "layer_norm.cu").write_text("// v2\n")
    assert _build._target("layer_norm")[1] != lib
    assert _build.build(("layer_norm",))["layer_norm"] > 0


def test_build_failure_raises_with_the_compiler_log(fake_toolchain):
    _build, csrc = fake_toolchain
    (csrc / "layer_norm.cu").write_text("// ok\n")
    (csrc / "flash_attention_fwd_f32.cu").write_text("// broken\n")
    with pytest.raises(MXNetError,
                       match="(?s)flash_attention_fwd_f32.*broken"):
        _build.build()
    assert _build._target("layer_norm")[1].exists()
    assert not _build._target("flash_attention_fwd_f32")[1].exists()


def test_build_without_nvcc_raises(fake_toolchain, monkeypatch):
    _build, csrc = fake_toolchain
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed")
    (csrc / "layer_norm.cu").write_text("// ok\n")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.build(("layer_norm",))
