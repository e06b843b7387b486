"""The port's fused CE head against the JAX package's, on the CPU.

`mxnet_tpu_torch.ops.pallas_kernels.fused_ce` holds four CUDA kernels
for the five Pallas functions of `mxnet_tpu/ops/pallas_kernels/
fused_ce.py`, with a plain PyTorch version beside each; a CPU tensor
takes the plain version.  These tests feed the same numpy inputs (made
from a seed) to the plain versions and to the JAX package: its jnp twins,
the Pallas kernel bodies in interpret mode, and its public
`fused_softmax_ce` under `jax.vjp` in both backward structures.  The
CUDA kernels are held against the same plain versions on the card by
`chip_smoke.py`.

Tolerances: in float32 both sides do the same float32 arithmetic and
differ only in the order of the sums (torch's vs XLA's, the Pallas
grids' blocks), so values of magnitude ~1-10 agree to 1e-5 (``ATOL``,
~100 float32 ulp) and gradients summed over up to 100 vocabulary
columns or 40 tokens to 1e-5 as well.  In bfloat16 the cast points are
the same on both sides (logits in float32, p and dl rounded to the
operands' dtype before each product), so an output rounded to bfloat16
differs by at most one bfloat16 ulp where the two float32 sums straddle
a rounding boundary: ``BF16_RTOL`` = 2**-7 of the value.
"""
import ctypes
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import fused_ce_mod as jfc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import loss as tloss
from mxnet_tpu_torch.ops.pallas_kernels import fused_ce as tfc
from test_torch_kernels import _one_thread  # noqa: F401


ATOL = 1e-5
BF16_RTOL = 2 ** -7
N, D, V = 40, 32, 100
BLOCK_N, BLOCK_V = 16, 32   # ragged: 40 = 2.5 token blocks, 100 = 3.1 tiles
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0, n=N, d=D, v=V, out_of_range=True, ignored=True):
    """x, W, b, int32 labels and a per-row coefficient r, as numpy.
    Labels: some -1 and some past the JAX tiles' padding (out of range,
    matching no column), some equal to the ignore label 5."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 0.8).astype(np.float32)
    w = (rng.randn(v, d) * 0.3).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    label = rng.randint(0, v, n).astype(np.int32)
    if out_of_range:
        label[3] = -1
        label[11] = v + 2 * BLOCK_V  # past V rounded up to the tiles
    if ignored:
        label[5] = label[17] = 5
    r = (rng.rand(n) * 2).astype(np.float32)
    return x, w, b, label, r


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype_name, what=""):
    if dtype_name == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATOL, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                   atol=ATOL, err_msg=what)


def _both(dtype_name, seed=0, **kw):
    """(jax operands, torch operands) in ``dtype_name``; labels int32 and
    r float32 on both sides."""
    jd, td = DTYPES[dtype_name]
    x, w, b, label, r = _inputs(seed, **kw)
    j = (jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd),
         jnp.asarray(label), jnp.asarray(r))
    t = (_t(x, td), _t(w, td), _t(b, td), torch.from_numpy(label),
         torch.from_numpy(r))
    return j, t


# -- each plain version against its jnp twin ---------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["fwd", "bwd", "fwd_sp", "bwd_dw_rs",
                                "bwd_dx_rs"])
def test_plain_version_matches_jnp_twin(fn, dtype_name):
    (jx, jw, jb, jl, jr), (x, w, b, lbl, r) = _both(dtype_name)
    lse = _np(tfc._fwd_plain(x, w, b, lbl, 5.0, True, BLOCK_V)[1])
    jlse, tlse = jnp.asarray(lse), torch.from_numpy(lse)
    if fn == "fwd":
        want = jfc._fwd_jnp(jx, jw, jb, jl, 1.0, 5.0, True, BLOCK_V)
        got = tfc._fwd_plain(x, w, b, lbl, 5.0, True, BLOCK_V)
    elif fn == "bwd":
        want = jfc._bwd_jnp(jx, jw, jb, jl, jlse, 1.7, 5.0, True, BLOCK_V)
        got = tfc._bwd_plain(x, w, b, lbl, tlse, 1.7, 5.0, True, BLOCK_V)
    elif fn == "fwd_sp":
        want = jfc._fwd_sp_jnp(jx, jw, jb, jl, BLOCK_V)
        got = tfc._fwd_sp_plain(x, w, b, lbl, BLOCK_V)
    elif fn == "bwd_dw_rs":
        want = jfc._bwd_dw_rs_jnp(jx, jw, jb, jl, jlse, jr, BLOCK_V)
        got = tfc._bwd_dw_rs_plain(x, w, b, lbl, tlse, r, BLOCK_V)
    else:
        want = (jfc._bwd_dx_rs_jnp(jx, jw, jb, jl, jlse, jr, BLOCK_V),)
        got = (tfc._bwd_dx_rs_plain(x, w, b, lbl, tlse, r, BLOCK_V),)
    assert len(got) == len(want)
    for i, (g, wnt) in enumerate(zip(got, want)):
        assert g.dtype == DTYPES[str(wnt.dtype)][1], (i, g.dtype, wnt.dtype)
        _close(g, wnt, dtype_name, "%s output %d" % (fn, i))


def test_valid_coef_and_tiles_match_jax():
    _, _, _, label, _ = _inputs()
    jr, jv = jfc._valid_coef(jnp.asarray(label), 1.7, 5.0, True)
    tr, tv = tfc._valid_coef(torch.from_numpy(label), 1.7, 5.0, True)
    np.testing.assert_array_equal(_np(tr), _np(jr))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    x, w, b, _, _ = _inputs()
    jw, jb, jn, jbv = jfc._tiles(jnp.asarray(w), jnp.asarray(b), BLOCK_V)
    tw, tb, tn, tbv = tfc._tiles(_t(w), _t(b), BLOCK_V)
    assert (tn, tbv) == (jn, jbv) == (4, BLOCK_V)
    np.testing.assert_array_equal(_np(tw), _np(jw))
    np.testing.assert_array_equal(_np(tb), _np(jb))


def test_a_label_in_the_tiles_padding_picks_nothing():
    """The one deliberate difference: a label in [V, V rounded up to the
    JAX tile) picks the padding's -1e30 mask in the jnp twin (nll ~1e30);
    the port's label rule does not depend on a tile size, so it picks
    nothing there, as for any label >= V."""
    (jx, jw, jb, _, _), (x, w, b, _, _) = _both("float32")
    label = np.arange(N, dtype=np.int32) % V
    label[0] = V + 1  # inside the last tile's padding at BLOCK_V = 32
    jnll, jlse = jfc._fwd_jnp(jx, jw, jb, jnp.asarray(label), 1.0, -1.0,
                              False, BLOCK_V)
    nll, lse = tfc._fwd_plain(x, w, b, torch.from_numpy(label), -1.0, False,
                              BLOCK_V)
    assert float(jnll[0]) > 1e29
    np.testing.assert_allclose(_np(nll)[0], _np(lse)[0], rtol=0, atol=0)
    _close(nll[1:], jnll[1:], "float32")
    _close(lse, jlse, "float32")


# -- against the Pallas bodies in interpret mode -------------------------------


@pytest.fixture()
def ce_interpret(monkeypatch):
    if not jfc._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfc, "_INTERPRET", True)


def test_plain_versions_match_pallas_bodies(ce_interpret):
    """The TPU kernel bodies themselves, with ragged token blocks and
    vocabulary tiles (n 40 in blocks of 16, V 100 in tiles of 32), no
    bias, grad_scale 1.7, use_ignore and out-of-range labels."""
    x, w, _, label, r = _inputs(seed=2)
    b = np.zeros(V, np.float32)
    jx, jw, jb, jl, jr = (jnp.asarray(a) for a in (x, w, b, label, r))
    tx, tw, tb, tl, tr = _t(x), _t(w), _t(b), torch.from_numpy(label), \
        torch.from_numpy(r)
    args = (1.7, 5.0, True)
    jnll, jlse = jfc._fwd_pallas(jx, jw, jb, jl, *args, BLOCK_N, BLOCK_V)
    nll, lse = tfc.fused_ce_fwd(tx, tw, tb, tl, 5.0, True, BLOCK_N, BLOCK_V)
    _close(nll, jnll, "float32", "nll")
    _close(lse, jlse, "float32", "lse")
    want = jfc._bwd_pallas(jx, jw, jb, jl, jlse, *args, BLOCK_N, BLOCK_V)
    got = tfc.fused_ce_bwd(tx, tw, tb, tl, lse, *args, BLOCK_N, BLOCK_V)
    for name, g, wnt in zip(("dx", "dw", "db"), got, want):
        _close(g, wnt, "float32", "5-pass " + name)
    want = jfc._fwd_sp_pallas(jx, jw, jb, jl, BLOCK_N, BLOCK_V)
    got = tfc.fused_ce_fwd_sp(tx, tw, tb, tl, BLOCK_N, BLOCK_V)
    for name, g, wnt in zip(("lse", "a", "dxp"), got, want):
        _close(g, wnt, "float32", "single pass " + name)
    want = jfc._bwd_dw_rs_pallas(jx, jw, jb, jl, jlse, jr, BLOCK_N, BLOCK_V)
    got = tfc.fused_ce_bwd_dw(tx, tw, tb, tl, lse, tr, BLOCK_N, BLOCK_V)
    for name, g, wnt in zip(("dw", "db"), got, want):
        _close(g, wnt, "float32", "row-scaled " + name)
    want = jfc._bwd_dx_rs_pallas(jx, jw, jb, jl, jlse, jr, BLOCK_N, BLOCK_V)
    got = tfc.fused_ce_bwd_dx(tx, tw, tb, tl, lse, tr, BLOCK_N, BLOCK_V)
    _close(got, want, "float32", "row-scaled dx")


# -- the public entry and its gradients ---------------------------------------


def _jax_vjp(xj, wj, bj, lj, kw):
    out, vjp = jax.vjp(
        lambda x_, w_, b_: jfc.fused_softmax_ce(x_, w_, b_, lj, **kw),
        xj, wj, bj)
    return (out,) + vjp(jnp.ones_like(out))


def _port_grad(x, w, b, label, kw, fn=None):
    fn = fn or tfc.fused_softmax_ce
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    out = fn(*leaves, label, **kw)
    # the loss head ignores the cotangent: any value gives its gradient
    grads = torch.autograd.grad(out, leaves, torch.full_like(out, 3.0))
    return (out,) + grads


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("single_pass", ["1", "0"])
def test_fused_softmax_ce_matches_jax_vjp(monkeypatch, single_pass, bias):
    """Loss and gradients through `_FusedCESinglePass` ('1') and
    `_FusedCEFivePass` ('0') against `jax.vjp` of the JAX entry, with
    float labels, grad_scale 1.7, use_ignore and out-of-range labels;
    ``bias=None`` becomes zeros and its gradient is still returned."""
    monkeypatch.setenv("MXNET_CE_SINGLE_PASS", single_pass)
    x, w, b, label, _ = _inputs(seed=4)
    flabel = label.astype(np.float32)
    kw = dict(grad_scale=1.7, ignore_label=5.0, use_ignore=True,
              block_v=BLOCK_V)
    jb = jnp.asarray(b) if bias else None
    want = _jax_vjp(jnp.asarray(x), jnp.asarray(w), jb, jnp.asarray(flabel),
                    kw) if bias else None
    if not bias:
        out, vjp = jax.vjp(lambda x_, w_: jfc.fused_softmax_ce(
            x_, w_, None, jnp.asarray(flabel), **kw), jnp.asarray(x),
            jnp.asarray(w))
        want = (out,) + vjp(jnp.ones_like(out))
    tb = _t(b) if bias else None
    leaves = [_t(x).requires_grad_(), _t(w).requires_grad_()]
    if bias:
        leaves.append(tb.requires_grad_())
    out = tfc.fused_softmax_ce(leaves[0], leaves[1], leaves[-1] if bias
                               else None, torch.from_numpy(flabel), **kw)
    got = (out,) + torch.autograd.grad(out, leaves, torch.ones_like(out))
    assert out.dtype == torch.float32 and out.shape == (N,)
    assert _np(out)[5] == 0.0 and _np(out)[17] == 0.0  # ignored rows
    for name, g, wnt in zip(("nll", "dx", "dw", "db"), got, want):
        _close(g, wnt, "float32", "%s (single pass %s)" % (name,
                                                           single_pass))


def test_both_structures_and_the_primal_forward_agree(monkeypatch):
    """The two structures give the same loss and gradients (and the
    cotangent does not matter); without a gradient the entry runs the
    statistics forward alone and gives the same loss."""
    x, w, b, label, _ = _inputs(seed=5)
    kw = dict(grad_scale=1.3, ignore_label=5.0, use_ignore=True,
              block_v=BLOCK_V)
    res = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_CE_SINGLE_PASS", flag)
        res[flag] = _port_grad(_t(x), _t(w), _t(b), torch.from_numpy(label),
                               kw)
    for name, a, c in zip(("nll", "dx", "dw", "db"), res["1"], res["0"]):
        _close(a, c, "float32", name)
    with torch.no_grad():
        nll = tfc.fused_softmax_ce(_t(x), _t(w), _t(b),
                                   torch.from_numpy(label), **kw)
    _close(nll, res["1"][0], "float32", "primal")


def test_plain_entry_equals_the_kernel_entry_on_the_cpu(monkeypatch):
    """`fused_softmax_ce_plain` (the reference `chip_smoke.py` holds the
    kernels against) is the same function on the CPU, in both
    structures."""
    x, w, b, label, _ = _inputs(seed=6)
    kw = dict(grad_scale=0.5, block_v=BLOCK_V)
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_CE_SINGLE_PASS", flag)
        a = _port_grad(_t(x), _t(w), _t(b), torch.from_numpy(label), kw)
        c = _port_grad(_t(x), _t(w), _t(b), torch.from_numpy(label), kw,
                       tfc.fused_softmax_ce_plain)
        for name, g, wnt in zip(("nll", "dx", "dw", "db"), a, c):
            _close(g, wnt, "float32", name)


def test_block_pins_are_read_at_each_call(monkeypatch):
    """MXNET_CE_BLOCK_V retiles the plain versions (the same values up to
    the order of the sums); MXNET_CE_BLOCK_N is read too."""
    x, w, b, label, _ = _inputs(seed=7)
    args = (_t(x), _t(w), _t(b), torch.from_numpy(label))
    with torch.no_grad():
        base = tfc.fused_softmax_ce(*args, block_v=BLOCK_V)
        monkeypatch.setenv("MXNET_CE_BLOCK_V", "7")
        monkeypatch.setenv("MXNET_CE_BLOCK_N", "64")
        pinned = tfc.fused_softmax_ce(*args, block_v=BLOCK_V)
    _close(pinned, base, "float32")


def test_fused_and_dense_heads_give_the_same_gradients():
    """The port's FusedSoftmaxCE op and its dense FullyConnected +
    SoftmaxOutput pair give the same loss-head gradients on the same
    weights (the dense head's loss read from its softmax rows)."""
    x, w, b, label, _ = _inputs(seed=8, out_of_range=False, ignored=False)
    params = dict(num_hidden=V, grad_scale=1.0, ignore_label=-1.0,
                  use_ignore=False, no_bias=False, block_n=512,
                  block_v=BLOCK_V)
    op = tloss.FusedSoftmaxCE()
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    lbl = torch.from_numpy(label.astype(np.float32))
    (nll,), _ = op.apply(None, params, leaves + [lbl], [])
    fused = torch.autograd.grad(nll, leaves, torch.ones_like(nll))
    dense_leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    logits = torch.nn.functional.linear(*dense_leaves)
    probs = tloss._SoftmaxOutputFn.apply(logits, lbl, 1.0, -1.0, False)
    dense = torch.autograd.grad(probs, dense_leaves, torch.ones_like(probs))
    want_nll = -torch.log(probs.gather(1, lbl.long()[:, None]))[:, 0]
    _close(nll, want_nll, "float32", "nll")
    for name, g, wnt in zip(("dx", "dw", "db"), fused, dense):
        _close(g, wnt, "float32", name)


def test_op_shapes_and_arguments_match_jax():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    for no_bias in (False, True):
        shapes = []
        for mx in (jmx, tmx):
            with mx.name.NameManager():
                net = mx.sym.FusedSoftmaxCE(
                    data=mx.sym.Variable("x"), label=mx.sym.Variable("y"),
                    num_hidden=V, no_bias=no_bias, name="head")
                shapes.append((net.list_arguments(),
                               net.infer_shape(x=(N, 2, D // 2)),
                               net.tojson()))
        assert shapes[0] == shapes[1]
    with pytest.raises(MXNetError, match="at least 2"):
        tmx.sym.FusedSoftmaxCE(data=tmx.sym.Variable("x"), num_hidden=V,
                               label=tmx.sym.Variable("y")).infer_shape(
                                   x=(N,))


# -- the wrappers: routing, counting, refusing ---------------------------------

_COUNTED = (tfc.fused_ce_fwd, tfc.fused_ce_fwd_sp, tfc.fused_ce_bwd_dw,
            tfc.fused_ce_bwd_dx)


def test_cpu_takes_the_plain_versions_and_counts_nothing(monkeypatch):
    x, w, b, label, _ = _inputs(seed=9)
    before = [f.launches for f in _COUNTED]
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_CE_SINGLE_PASS", flag)
        _port_grad(_t(x), _t(w), _t(b), torch.from_numpy(label),
                   dict(block_v=BLOCK_V))
    assert [f.launches for f in _COUNTED] == before


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(w_dtype=torch.bfloat16), "x's dtype"),
    (dict(d=0), "positive multiple of 4"),
    (dict(b_rows=39), "b must be"),
    (dict(x_3d=True), "x must be"),
    (dict(float_labels=True), "integer class ids"),
    (dict(lse_dtype=torch.float64), "float32"),
])
def test_cuda_wrappers_refuse_before_any_launch(bad, match):
    """A CUDA wrapper checks its arguments before anything reaches the
    card and raises `MXNetError`; it never falls back to the plain
    version (the CPU tensors here would let the plain version run)."""
    d = bad.get("d", 32)
    dtype = bad.get("dtype", torch.float32)
    x = torch.randn(8, d).to(dtype)
    if bad.get("x_3d"):
        x = x.reshape(2, 4, d)
    w = torch.randn(40, d).to(bad.get("w_dtype", dtype))
    b = torch.zeros(bad.get("b_rows", 40), dtype=dtype)
    label = torch.arange(8, dtype=torch.int32)
    if bad.get("float_labels"):
        label = label.float()
    lse = torch.zeros(8, dtype=bad.get("lse_dtype", torch.float32))
    r = torch.ones(8)
    before = [f.launches for f in _COUNTED]
    calls = [lambda: tfc._fwd_cuda(x, w, b, label, -1.0, False),
             lambda: tfc._fwd_sp_cuda(x, w, b, label),
             lambda: tfc._bwd_dw_cuda(x, w, b, label, lse, r),
             lambda: tfc._bwd_dx_cuda(x, w, b, label, lse, r)]
    if "lse_dtype" in bad:
        calls = calls[2:]
    for call in calls:
        with pytest.raises(MXNetError, match=match):
            call()
    assert [f.launches for f in _COUNTED] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [6, 30])
def test_a_d_off_the_granule_is_padded_not_refused(monkeypatch, dtype, d):
    """A d that is no multiple of the kernels' 16-byte granule reaches the
    C entries zero-padded to the next one (6 to 8, 30 to 32, in both
    dtypes), counted once on each wrapper's ``padded_calls``, and its dxp,
    dx and dW come back sliced to d.  The C library is faked."""
    seen = []

    def entry(name):
        def launch(dt, x, w, *rest):
            # n, d and v follow the entry's pointers
            k = tfc._SIGNATURES[name].count(ctypes.c_void_p) - 2
            seen.append((name, rest[k:k + 3]))
            return 0
        return launch

    monkeypatch.setattr(tfc, "_entry", lambda dt, name: entry(name))
    monkeypatch.setattr(tfc._build, "check_current_device",
                        lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    n, v = 8, 40
    x = torch.randn(n, d).to(dtype)
    w = torch.randn(v, d).to(dtype)
    b = torch.zeros(v, dtype=dtype)
    label = torch.arange(n, dtype=torch.int32)
    lse, r = torch.zeros(n), torch.ones(n)
    before = [(f.launches, f.padded_calls) for f in _COUNTED]
    _, _, dxp = tfc._fwd_sp_cuda(x, w, b, label)
    tfc._fwd_cuda(x, w, b, label, -1.0, False)
    dw, _ = tfc._bwd_dw_cuda(x, w, b, label, lse, r)
    dx = tfc._bwd_dx_cuda(x, w, b, label, lse, r)
    wide = 8 if d == 6 else 32
    assert sorted(seen) == sorted(
        (name, (n, wide, v)) for name in tfc._SIGNATURES)
    assert [(f.launches, f.padded_calls) for f in _COUNTED] == [
        (a + 1, p + 1) for a, p in before]
    assert dxp.shape == (n, d) and dx.shape == (n, d) and dw.shape == (v, d)
    assert dx.dtype == dw.dtype == dtype


def test_zero_padding_d_is_exact_against_jax():
    """Why the padding is exact: the plain versions on x and W zero-padded
    from d = 30 to 32, with dx and dW sliced back to 30, match the JAX
    package's `fused_softmax_ce` at d = 30 in value and gradient."""
    x, w, b, label, _ = _inputs(seed=12, d=30)
    kw = dict(grad_scale=1.0, ignore_label=5.0, use_ignore=True)
    want = _jax_vjp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    jnp.asarray(label), kw)
    pad = torch.nn.functional.pad
    got = _port_grad(pad(_t(x), (0, 2)), pad(_t(w), (0, 2)), _t(b),
                     torch.from_numpy(label), dict(kw, block_v=BLOCK_V))
    nll, dx, dw, db = got
    assert not dx[:, 30:].any() and not dw[:, 30:].any()
    for name, g, wnt in zip(("nll", "dx", "dw", "db"),
                            (nll, dx[:, :30], dw[:, :30], db), want):
        _close(g, wnt, "float32", name)


def test_entry_rejects_non_matrix_operands():
    with pytest.raises(ValueError, match="2-D"):
        tfc.fused_softmax_ce(torch.zeros(2, 3, 4), torch.zeros(5, 4), None,
                             torch.zeros(2))
