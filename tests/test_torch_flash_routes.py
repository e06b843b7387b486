"""The port's flash-attention routes against the JAX package, on the CPU.

* The 'ds' route (rows 5 and 6 of the kernel table) and the
  'bsd_stream' route (rows 9 and 10) through their plain versions,
  against the JAX dS-layout and grid-streamed bsd Pallas bodies run in
  interpret mode: out, lse, dq, dk and dv, with an lse cotangent, causal
  and not, with offsets and ragged lengths, at head 128 and 64.
* The router: each pin resolves to its route, as the JAX package's
  `_pick_impl` and `_bsd_structure` resolve it; an unrecognized
  ``MXNET_FLASH_BSD_KERNEL`` raises in both packages; a CPU call counts
  no launch; the 'ds' route hands the kernels (B, H, D, S) operands and
  keeps its residuals so; ``MXNET_FLASH_BWD=jnp`` and
  ``MXNET_FLASH_IMPL=jnp`` take the plain versions; the op's
  ``block_k`` and ``MXNET_FLASH_BLOCK_K`` reach the plain versions.
* A tiny LM of the long-context shape (V 61, 2 layers, 2 heads of 128,
  S 512, B 2; Adam lr 1e-3 wd 0, v in bfloat16) trained for 5 steps
  under ``MXNET_FLASH_LAYOUT=ds`` ('bhsd') and under
  ``MXNET_FLASH_BSD_KERNEL=stream`` ('bsd') walks the JAX trainer's
  trajectory, the JAX trainer running the interpret-mode dS and
  grid-streamed kernels.

Tolerances.  Kernel bodies against plain versions, float32: atol 2e-5 on
out and lse (values of magnitude ~1 to ~10, summed over up to 512 keys
in another block order: ~1e-6) and 2e-5 + rtol 1e-4 on the gradients.
A row that sees no key differs by design (see the port module's note),
so every case here gives every query at least one key.  Trajectories:
rtol 1e-4 / atol 1e-5, as `tests/test_torch_train.py` holds them, with
its rule for the key-projection biases and two of the same kind.  The
two packages' float32 gradients differ by their summation order, ~1e-6
of a tensor's largest gradient; Adam's step lr * m / sqrt(v) carries the
gradient's relative error, so an element whose gradient is below 1e-4 of
its tensor's largest in some step (a relative error of 1% or more, its
sign possibly rounding's) can move apart by up to lr a step.  Such
elements are found from the JAX trainer's gradient alone (read from its
Adam m before and after each step), so a gradient the port got wrong
never joins them.  They are held to 2 * STEPS * lr and left out of the v
check, and may be at most 3.6% of a tensor: twice the largest share
measured (layer1_ffn1_weight, 1.78%; 0.98% of all elements in both
layouts; their largest gap 3.3e-4).  The bfloat16 v: each step's
stochastic rounding puts the two tables one ulp further apart where the
two float32 v fall on either side of its step (a chance of ~1e-3 an
element at this size), so an element may be more than the one ulp that
`tests/test_torch_train.py` allows apart: 4 elements of 1.7 million are
two ulps apart under the stream pin.  The check allows two ulps, at most
1% of the elements apart at all (measured: 0.3% 'ds', 0.4% 'stream')
and at most 1e-5 of them (17) more than one ulp.  Every other element,
those whose v were apart included, keeps the common tolerance.  The
test prints what the two exemptions cover (``pytest -s``).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.ops.pallas_kernels import flash_attention_mod as jfa
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer, make_mesh
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa

ATOL = 2e-5
GRAD_RTOL = 1e-4
PINS = ("MXNET_FLASH_IMPL", "MXNET_FLASH_LAYOUT", "MXNET_FLASH_BSD_KERNEL",
        "MXNET_FLASH_BWD", "MXNET_FLASH_BLOCK_K")


@pytest.fixture(autouse=True)
def clean_pins(monkeypatch):
    for name in PINS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture()
def interpret(monkeypatch):
    if not jfa._HAS_PALLAS:
        pytest.skip("pallas unavailable")
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _operands(b, h, sq, skv, d, seed):
    """q, k, v, the out cotangent g (B, H, S, D) and the lse cotangent
    (B, H, Sq), float32, from `RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, skv, d).astype(np.float32)
    v = rng.randn(b, h, skv, d).astype(np.float32)
    g = rng.randn(b, h, sq, d).astype(np.float32)
    glse = rng.randn(b, h, sq).astype(np.float32)
    return q, k, v, g, glse


def _through_port(fn, q, k, v, g, glse, *extra, **kw):
    """out, lse and the gradients of q, k, v through a port function, the
    cotangents g and glse given."""
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out, lse = fn(*leaves, *extra, with_lse=True, **kw)
    torch.autograd.backward((out, lse), (torch.from_numpy(g),
                                         torch.from_numpy(glse)))
    return [out.detach().numpy(), lse.detach().numpy()] + [
        t.grad.numpy() for t in leaves]


def _assert_close(got, want, names):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        rtol = 0.0 if name in ("out", "lse") else GRAD_RTOL
        np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL, err_msg=name)


NAMES = ("out", "lse", "dq", "dk", "dv")

# (sq, skv, d, causal, q_off, k_off): every query sees a key
CASES = [
    (256, 256, 128, True, 0, 0),
    (200, 328, 128, True, 130, 0),     # ragged, offsets move the diagonal
    (136, 136, 64, True, 24, 0),       # head 64, ragged, q_off
    (160, 96, 128, False, 40, 7),      # not causal: offsets are inert
]


@pytest.mark.parametrize("sq,skv,d,causal,q_off,k_off", CASES)
def test_ds_route_matches_pallas_ds_bodies(interpret, monkeypatch, sq, skv,
                                           d, causal, q_off, k_off):
    """`_flash_fwd_pallas_ds`/`_flash_bwd_pallas_ds` (interpret mode,
    blocks of 128) against the port's 'ds' route."""
    monkeypatch.setenv("MXNET_FLASH_LAYOUT", "ds")
    q, k, v, g, glse = _operands(1, 2, sq, skv, d, seed=sq + d)
    scale = 1.0 / math.sqrt(d)
    q_ds, k_ds, v_ds = (jnp.asarray(t).swapaxes(2, 3) for t in (q, k, v))
    o_ds, lse = jfa._flash_fwd_pallas_ds(q_ds, k_ds, v_ds, q_off, k_off,
                                         scale, causal, 128, 128)
    dq, dk, dv, _, _ = jfa._flash_bwd_pallas_ds(
        scale, causal, 128, 128,
        (q_ds, k_ds, v_ds, o_ds, lse, q_off, k_off),
        (jnp.asarray(g), jnp.asarray(glse)))
    want = (o_ds.swapaxes(2, 3), lse, dq, dk, dv)
    got = _through_port(tfa.flash_attention, q, k, v, g, glse,
                        causal=causal, q_offset=q_off, k_offset=k_off)
    _assert_close(got, want, NAMES)


def _to_bsd(t):
    b, h, s, d = t.shape
    return np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(b, s, h * d))


@pytest.mark.parametrize("sq,skv,d,causal,q_off,k_off", CASES)
def test_bsd_stream_route_matches_pallas_bsd_gs_bodies(
        interpret, monkeypatch, sq, skv, d, causal, q_off, k_off):
    """`_flash_fwd_pallas_bsd_gs`/`_flash_bwd_pallas_bsd_gs` (interpret
    mode, blocks of 128) against the port's 'bsd_stream' route."""
    monkeypatch.setenv("MXNET_FLASH_BSD_KERNEL", "stream")
    h = 2
    q, k, v, g, glse = (_to_bsd(t) if t.ndim == 4 else t for t in
                        _operands(2, h, sq, skv, d, seed=sq + d + 1))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    out, lse = jfa._flash_fwd_pallas_bsd_gs(jq, jk, jv, q_off, k_off, scale,
                                            causal, 128, 128, h)
    dq, dk, dv, _, _ = jfa._flash_bwd_pallas_bsd_gs(
        scale, causal, 128, 128, h, (jq, jk, jv, out, lse, q_off, k_off),
        (jnp.asarray(g), jnp.asarray(glse)))
    got = _through_port(tfa.flash_attention_bsd, q, k, v, g, glse, h,
                        causal=causal, q_offset=q_off, k_offset=k_off)
    _assert_close(got, (out, lse, dq, dk, dv), NAMES)


# -- the router ----------------------------------------------------------------


@pytest.mark.parametrize("pins,hsd,bsd", [
    ({}, "hsd", "bsd_loop"),
    ({"MXNET_FLASH_LAYOUT": "ds"}, "ds", "bsd_loop"),
    ({"MXNET_FLASH_LAYOUT": "hsd"}, "hsd", "bsd_loop"),
    ({"MXNET_FLASH_IMPL": "pallas_ds"}, "ds", "bsd_loop"),
    ({"MXNET_FLASH_IMPL": "pallas_hsd", "MXNET_FLASH_LAYOUT": "ds"}, "hsd",
     "bsd_loop"),
    ({"MXNET_FLASH_IMPL": "pallas_bsd"}, "hsd", "bsd_loop"),
    ({"MXNET_FLASH_IMPL": "jnp", "MXNET_FLASH_LAYOUT": "ds"}, "jnp", "jnp"),
    ({"MXNET_FLASH_BSD_KERNEL": "stream"}, "hsd", "bsd_stream"),
    ({"MXNET_FLASH_BSD_KERNEL": "loop"}, "hsd", "bsd_loop"),
    ({"MXNET_FLASH_BSD_KERNEL": "auto"}, "hsd", "bsd_loop"),
    ({"MXNET_FLASH_IMPL": "pallas_bsd",
      "MXNET_FLASH_BSD_KERNEL": "stream"}, "hsd", "bsd_stream"),
])
def test_pins_resolve_to_their_routes(monkeypatch, pins, hsd, bsd):
    for name, value in pins.items():
        monkeypatch.setenv(name, value)
    assert tfa._hsd_route() == hsd
    assert tfa._bsd_route() == bsd


def test_pins_resolve_as_the_jax_router(interpret, monkeypatch):
    """The JAX package's `_pick_impl` (past its TPU gates: interpret mode,
    512 x 512) and `_bsd_structure` under the same pins."""
    q = jnp.zeros((1, 2, 512, 128), jnp.float32)
    impl = {"hsd": "pallas_hsd", "ds": "pallas_ds", "jnp": "jnp"}
    for pins in ({}, {"MXNET_FLASH_LAYOUT": "ds"},
                 {"MXNET_FLASH_IMPL": "pallas_ds"},
                 {"MXNET_FLASH_IMPL": "jnp"}):
        for name in PINS:
            monkeypatch.delenv(name, raising=False)
        for name, value in pins.items():
            monkeypatch.setenv(name, value)
        assert jfa._pick_impl(q, 512) == impl[tfa._hsd_route()], pins
    monkeypatch.delenv("MXNET_FLASH_IMPL")
    for structure in ("loop", "stream"):
        monkeypatch.setenv("MXNET_FLASH_BSD_KERNEL", structure)
        assert jfa._bsd_structure(q, 2, 512) == structure
        assert tfa._bsd_route() == "bsd_" + structure


def test_unrecognized_bsd_kernel_pin_raises_in_both_packages(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_BSD_KERNEL", "streamed")
    x = torch.zeros(1, 8, 256)
    with pytest.raises(MXNetError, match="MXNET_FLASH_BSD_KERNEL must be"):
        tfa.flash_attention_bsd(x, x, x, 2, causal=True)
    with pytest.raises(JaxMXNetError, match="MXNET_FLASH_BSD_KERNEL must be"):
        jfa._bsd_structure(jnp.zeros((1, 8, 256)), 2, 8)


def _counts():
    return {(fn.__name__, prefix + kind): getattr(fn, prefix + kind)
            for fn, prefix in tfa._COUNTERS.values()
            for kind in ("launches", "dq_launches", "dkv_launches")}


@pytest.mark.parametrize("pins", [{}, {"MXNET_FLASH_LAYOUT": "ds"},
                                  {"MXNET_FLASH_BSD_KERNEL": "stream"},
                                  {"MXNET_FLASH_IMPL": "jnp"}])
def test_cpu_call_counts_no_launch(monkeypatch, pins):
    for name, value in pins.items():
        monkeypatch.setenv(name, value)
    assert len(_counts()) == 12
    before = _counts()
    q, k, v, g, glse = _operands(1, 2, 40, 40, 64, seed=3)
    _through_port(tfa.flash_attention, q, k, v, g, glse, causal=True)
    q, k, v, g = (_to_bsd(t) for t in (q, k, v, g))
    _through_port(tfa.flash_attention_bsd, q, k, v, g, glse, 2, causal=True)
    assert _counts() == before


@pytest.fixture()
def fake_kernels(monkeypatch):
    """The kernel wrappers replaced by fakes that check what the card's
    kernels would be handed and answer with the plain versions, with the
    plain switch off as on a CUDA tensor; returns the calls made."""
    calls = []

    def fwd(q, k, v, q_off, k_off, scale, causal, with_lse, route):
        calls.append(("fwd", route, tuple(q.shape), q.is_contiguous()))
        ds = route == "ds"
        if ds:
            q, k, v = (t.transpose(2, 3) for t in (q, k, v))
        out, lse = tfa._flash_fwd_plain(q, k, v, q_off, k_off, scale, causal)
        tfa._count(route, "launches")
        return (out.transpose(2, 3).contiguous() if ds else out), lse

    def bwd(q, k, v, o, lse, g, glse, q_off, k_off, scale, causal, route):
        calls.append(("bwd", route, tuple(g.shape), g.is_contiguous()))
        ds = route == "ds"
        if ds:
            q, k, v, o, g = (t.transpose(2, 3) for t in (q, k, v, o, g))
        grads = tfa._flash_bwd_plain(q, k, v, o, lse, g, glse, q_off, k_off,
                                     scale, causal)
        tfa._count(route, "dq_launches")
        tfa._count(route, "dkv_launches")
        return tuple(t.transpose(2, 3).contiguous() for t in grads) if ds \
            else grads

    monkeypatch.setattr(tfa, "_flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "_flash_bwd_cuda", bwd)
    monkeypatch.setattr(tfa, "_plain", lambda q, route: route == "jnp")
    return calls


def test_ds_route_hands_the_kernels_ds_operands(monkeypatch, fake_kernels):
    """Under ``MXNET_FLASH_LAYOUT=ds`` the kernels get contiguous (B, H, D,
    S) operands and cotangent, the residuals stay in that layout, the
    launches land on the 'ds' counters alone, and the result is the
    plain one."""
    monkeypatch.setenv("MXNET_FLASH_LAYOUT", "ds")
    q, k, v, g, glse = _operands(2, 3, 72, 72, 64, seed=4)
    base = _counts()
    leaves = [torch.from_numpy(t).transpose(1, 2).contiguous().transpose(
        1, 2).requires_grad_() for t in (q, k, v)]
    out, lse = tfa.flash_attention(*leaves, causal=True, with_lse=True)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved[:4]] == [(2, 3, 64, 72)] * 4
    assert all(t.is_contiguous() for t in saved[:4])
    torch.autograd.backward((out, lse), (torch.from_numpy(g),
                                         torch.from_numpy(glse)))
    assert fake_kernels == [("fwd", "ds", (2, 3, 64, 72), True),
                            ("bwd", "ds", (2, 3, 64, 72), True)]
    moved = {k: n - base[k] for k, n in _counts().items() if n != base[k]}
    assert moved == {("flash_attention", "ds_launches"): 1,
                     ("flash_attention", "ds_dq_launches"): 1,
                     ("flash_attention", "ds_dkv_launches"): 1}
    monkeypatch.delenv("MXNET_FLASH_LAYOUT")
    want = _through_port(tfa.flash_attention_plain, q, k, v, g, glse,
                         causal=True)
    got = [out.detach().numpy(), lse.detach().numpy()] + [
        t.grad.numpy() for t in leaves]
    _assert_close(got, want, NAMES)


@pytest.mark.parametrize("pins,counted", [
    ({"MXNET_FLASH_BSD_KERNEL": "stream"}, "stream_"),
    ({}, ""),
])
def test_bsd_routes_count_on_their_own_counters(monkeypatch, fake_kernels,
                                                pins, counted):
    for name, value in pins.items():
        monkeypatch.setenv(name, value)
    q, k, v, g, glse = (_to_bsd(t) if t.ndim == 4 else t
                        for t in _operands(1, 2, 48, 48, 128, seed=5))
    base = _counts()
    _through_port(tfa.flash_attention_bsd, q, k, v, g, glse, 2, causal=True)
    moved = {k: n - base[k] for k, n in _counts().items() if n != base[k]}
    assert moved == {("flash_attention_bsd", counted + kind): 1
                     for kind in ("launches", "dq_launches", "dkv_launches")}
    route = "bsd_" + (pins.get("MXNET_FLASH_BSD_KERNEL") or "loop")
    assert [c[:2] for c in fake_kernels] == [("fwd", route), ("bwd", route)]


@pytest.mark.parametrize("pins,kernels", [
    ({"MXNET_FLASH_IMPL": "jnp", "MXNET_FLASH_LAYOUT": "ds"}, []),
    ({"MXNET_FLASH_BWD": "jnp", "MXNET_FLASH_LAYOUT": "ds"}, ["fwd"]),
    ({"MXNET_FLASH_BWD": "jnp"}, ["fwd"]),
])
def test_jnp_pins_take_the_plain_versions(monkeypatch, fake_kernels, pins,
                                          kernels):
    """``MXNET_FLASH_IMPL=jnp`` runs no kernel; ``MXNET_FLASH_BWD=jnp``
    runs the forward kernel and the plain backward, with the 'ds'
    residuals turned back to (B, H, S, D)."""
    for name, value in pins.items():
        monkeypatch.setenv(name, value)
    q, k, v, g, glse = _operands(1, 2, 40, 56, 64, seed=6)
    got = _through_port(tfa.flash_attention, q, k, v, g, glse, causal=True,
                        q_offset=16)
    assert [c[0] for c in fake_kernels] == kernels
    for name in PINS:
        monkeypatch.delenv(name, raising=False)
    want = _through_port(tfa.flash_attention_plain, q, k, v, g, glse,
                         causal=True, q_offset=16)
    _assert_close(got, want, NAMES)


def test_block_k_reaches_the_plain_versions(monkeypatch):
    """The op's ``block_k`` and ``MXNET_FLASH_BLOCK_K`` (which wins) set the
    plain versions' K block; a block <= 0 is the default; a garbled pin
    raises."""
    seen = []
    plain = tfa._flash_fwd_plain

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(tfa, "_flash_fwd_plain", spy)
    x = torch.randn(1, 2, 40, 64)
    op = tattn.DotProductAttention()
    for params, pin, want in (({"block_k": 16}, None, 16),
                              ({"block_k": 0}, None, tfa._BLOCK_K),
                              ({"block_k": 16}, "24", 24)):
        if pin is not None:
            monkeypatch.setenv("MXNET_FLASH_BLOCK_K", pin)
        full = dict(causal=True, scale=None, block_q=0, layout="bhsd",
                    num_heads=0, **params)
        op.apply(None, full, [x, x, x], [])
        op.apply(None, dict(full, layout="bsd", num_heads=2),
                 [x.reshape(1, 40, 128)] * 3, [])
        assert seen[-2:] == [want, want]
    monkeypatch.setenv("MXNET_FLASH_BLOCK_K", "big")
    with pytest.raises(MXNetError, match="MXNET_FLASH_BLOCK_K"):
        tfa.flash_attention(x, x, x)


def test_offsets_must_fit_the_kernels_int():
    x = torch.zeros(1, 1, 8, 64)
    with pytest.raises(MXNetError, match="32 bits"):
        tfa.flash_attention(x, x, x, causal=True, q_offset=2 ** 31)


# -- the long-context LM, 5 Adam steps ----------------------------------------

V, S, L, H, E, B = 61, 512, 2, 2, 256, 2
SHAPES = {"data": (B, S), "softmax_label": (B, S)}
STEPS = 5
ADAM = dict(optimizer="adam", lr=1e-3, wd=0.0, adam_v_dtype="bfloat16")
NOISE = 1e-4  # a gradient below this share of its tensor's largest: rounding
NOISY_SHARE = 0.036  # twice the largest share measured (1.78%, ffn1_weight)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("layout,pin,jax_kernels", [
    ("bhsd", ("MXNET_FLASH_LAYOUT", "ds"),
     ("_flash_fwd_pallas_ds", "_flash_bwd_pallas_ds")),
    ("bsd", ("MXNET_FLASH_BSD_KERNEL", "stream"),
     ("_flash_fwd_pallas_bsd_gs", "_flash_bwd_pallas_bsd_gs")),
])
def test_long_context_lm_walks_the_jax_trajectory(interpret, monkeypatch,
                                                  layout, pin, jax_kernels):
    monkeypatch.setenv(*pin)
    jax_calls, routes = [], []
    for name in jax_kernels:
        _spy(monkeypatch, jfa, name, jax_calls)
    forward = tfa._forward

    def spy_forward(q, k, v, args, with_lse, route, block):
        routes.append(route)
        return forward(q, k, v, args, with_lse, route, block)

    monkeypatch.setattr(tfa, "_forward", spy_forward)
    net_kw = dict(vocab_size=V, seq_len=S, num_layers=L, num_heads=H,
                  num_embed=E, attn_layout=layout)
    jmx.random.seed(0)
    jt = JaxTrainer(jmodels.get_transformer_lm(**net_kw),
                    make_mesh(shape=(1,), axis_names=("data",)),
                    data_shapes=SHAPES, **ADAM)
    tmx.random.seed(0)
    tt = tmx.SPMDTrainer(tmx.models.get_transformer_lm(**net_kw),
                         data_shapes=SHAPES, ctx="cpu", **ADAM)
    rng = np.random.RandomState(0)
    batch = {"data": rng.randint(0, V, (B, S)).astype(np.int32),
             "softmax_label": rng.randint(0, V, (B, S)).astype(np.float32)}
    b1 = jt._adam_hp[0]
    noisy = {}
    for i in range(STEPS):
        m_old = {n: np.array(jt.momenta[n][0]) for n in tt.param_names}
        jout = jt.step(batch)
        tout = tt.step(batch)
        if i == 0:
            np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                       rtol=1e-4, atol=1e-6)
        for n in tt.param_names:
            # the JAX trainer's gradient, up to a constant, from its Adam m
            g = np.abs(np.asarray(jt.momenta[n][0]) - b1 * m_old[n])
            noisy[n] = noisy.get(n, False) | (g < NOISE * g.max())
    # the JAX trainer traced its step through the kernels named, once a
    # layer; the port ran every layer's attention on the pinned route
    assert sorted(set(jax_calls)) == sorted(jax_kernels)
    assert set(routes) == {"ds" if layout == "bhsd" else "bsd_stream"}
    want, got = jt.get_params()[0], tt.get_params()[0]
    assert sorted(got) == sorted(want)
    shares, gap = {}, 0.0
    for n in want:
        a, b = got[n], np.asarray(want[n].asnumpy())
        if n.endswith("_k_bias"):
            bound = STEPS * ADAM["lr"]
            assert np.abs(a).max() <= bound and np.abs(b).max() <= bound, n
            continue
        rounding = noisy[n]
        shares[n] = rounding.mean()
        assert rounding.mean() <= NOISY_SHARE, (n, rounding.mean())
        assert (np.abs(a - b)[rounding] <= 2 * STEPS * ADAM["lr"]).all(), n
        gap = max([gap] + list(np.abs(a - b)[rounding]))
        np.testing.assert_allclose(a[~rounding], b[~rounding], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    apart = further = total = 0
    for pos, n in enumerate(tt.param_names):
        if n.endswith("_k_bias"):
            continue
        keep = ~noisy[n]
        gv = tt._adam_v[pos].float().numpy()[keep]
        wv = np.asarray(jt.momenta[n][1]).astype(np.float32)[keep]
        rel = np.abs(gv - wv) / np.maximum(np.maximum(np.abs(gv),
                                                      np.abs(wv)), 1e-30)
        assert (rel <= 2 * 2.0 ** -7).all(), n
        apart += int((rel > 0).sum())
        further += int((rel > 2.0 ** -7).sum())
        total += gv.size
    # what the exemptions cover, for `pytest -s`
    worst = max(shares, key=shares.get)
    print("%s: rounding elements %.4f of all, at most %.4f (%s), largest "
          "gap %.2e; v apart %d, more than one ulp %d, of %d"
          % (pin[1], sum(noisy[n].sum() for n in shares)
             / sum(noisy[n].size for n in shares), shares[worst], worst,
             gap, apart, further, total))
    assert apart <= 0.01 * total, (apart, total)
    assert further <= 1e-5 * total, (further, total)
