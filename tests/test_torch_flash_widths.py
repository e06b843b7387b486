"""Flash attention at head widths other than 64 and 128, on the CPU.

The CUDA kernels take head_dim 64, 128 and 256.  On a kernel route the
router zero-pads a head_dim of 32 to 127 along D to 64 or 128 (scale from
the true head_dim; 129 to 255 go to 256, `test_torch_flash_256.py`) and
slices the result back, counting the call on the route's
``padded_calls``; below 32 it takes the plain versions, as the JAX
package's `_use_pallas` sends head_dim < 32 to its jnp path, counting the
call on ``narrow_calls``; above 256 it pads to the next multiple of
128.  Here the kernel routes run with the kernels faked by the plain
versions on the operands the kernels would be handed (`fake_kernels` of
`test_torch_flash_routes.py`), so the padding, the slicing and their
gradients are held against the JAX package: `flash_attention` and
`flash_attention_bsd` (head-split) out, lse, dq, dk and dv against the
Pallas forward and backward bodies in interpret mode for head_dim >= 32
and the public jnp function for 16, at the same seeded numpy inputs.

Tolerances, float32: 1e-5 absolute on out and lse (values of magnitude
~1, summed over up to 56 keys in another block order: ~1e-7) and on the
gradients, whose inputs are scaled by 0.5 so they stay of magnitude ~1.
Every query sees at least one key (see the port module's note on rows
that see none).
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_kernels import flash_attention_mod as jfa
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa
from test_torch_flash_routes import clean_pins, fake_kernels  # noqa: F401
from test_torch_kernels import _one_thread  # noqa: F401


ATOL = 1e-5
# causal, Sq != Skv, an offset: every query sees a key
B, H, SQ, SKV, Q_OFF = 1, 2, 40, 56, 16
WIDTHS = (16, 32, 48, 80, 96)
NAMES = ("out", "lse", "dq", "dk", "dv")


@functools.lru_cache(maxsize=None)
def _reference(d):
    """The seeded inputs (q, k, v, g, glse) at head_dim ``d`` and the JAX
    package's (out, lse, dq, dk, dv): the Pallas bodies in interpret mode
    (blocks of 16) for d >= 32, the public jnp function below."""
    rng = np.random.RandomState(d)
    q, k, v, g = ((0.5 * rng.randn(B, H, s, d)).astype(np.float32)
                  for s in (SQ, SKV, SKV, SQ))
    glse = (0.5 * rng.randn(B, H, SQ)).astype(np.float32)
    jq, jk, jv, jg, jglse = (jnp.asarray(a) for a in (q, k, v, g, glse))
    if d < 32:
        (out, lse), vjp = jax.vjp(
            lambda *a: jfa.flash_attention(*a, causal=True, q_offset=Q_OFF,
                                           with_lse=True), jq, jk, jv)
        grads = vjp((jg, jglse))
    else:
        scale = 1.0 / math.sqrt(d)
        qo, ko = jnp.asarray(Q_OFF, jnp.int32), jnp.asarray(0, jnp.int32)
        saved = jfa._INTERPRET
        jfa._INTERPRET = True
        try:
            out, lse = jfa._flash_fwd_pallas(jq, jk, jv, qo, ko, scale, True,
                                             16, 16)
            grads = jfa._flash_bwd_pallas(scale, True, 16, 16,
                                          (jq, jk, jv, out, lse, qo, ko),
                                          (jg, jglse))[:3]
        finally:
            jfa._INTERPRET = saved
    want = [np.asarray(a) for a in (out, lse, *grads)]
    return (q, k, v, g, glse), want


def _to_bsd(t):
    """(B, H, S, D) -> (B, S, H * D)."""
    b, h, s, d = t.shape
    return np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(b, s, h * d))


def _heads(t):
    """(B, S, H * D) -> (B, H, S, D)."""
    b, s, e = t.shape
    return t.reshape(b, s, H, e // H).transpose(0, 2, 1, 3)


def _port(fn, inputs, *extra):
    q, k, v, g, glse = inputs
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out, lse = fn(*leaves, *extra, causal=True, q_offset=Q_OFF,
                  with_lse=True)
    torch.autograd.backward((out, lse), (torch.tensor(g), torch.tensor(glse)))
    return [out.detach().numpy(), lse.detach().numpy()] + [
        t.grad.numpy() for t in leaves]


def _calls():
    return {(fn.__name__, prefix + kind): getattr(fn, prefix + kind)
            for fn, prefix in tfa._COUNTERS.values()
            for kind in ("launches", "padded_calls", "narrow_calls")}


@pytest.mark.parametrize("pins,route", [
    ({}, "hsd"),
    ({"MXNET_FLASH_LAYOUT": "ds"}, "ds"),
    ({}, "bsd_loop"),
    ({"MXNET_FLASH_BSD_KERNEL": "stream"}, "bsd_stream"),
])
@pytest.mark.parametrize("d", WIDTHS)
def test_width_matches_jax_through_the_kernel_route(monkeypatch, fake_kernels,
                                                    d, pins, route):
    """Out, lse and the gradients of both public functions at head_dim d on
    each kernel route, against the JAX package; the kernels see 64 or 128
    columns (d >= 32) or nothing (d < 32), and the call is counted on the
    route's padded or narrow counter."""
    for name, value in pins.items():
        monkeypatch.setenv(name, value)
    inputs, want = _reference(d)
    before = _calls()
    if route.startswith("bsd"):
        got = _port(tfa.flash_attention_bsd,
                    [_to_bsd(t) for t in inputs[:4]] + [inputs[4]], H)
        got = [_heads(got[0]), got[1]] + [_heads(t) for t in got[2:]]
    else:
        got = _port(tfa.flash_attention, inputs)
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a, w, rtol=0, atol=ATOL, err_msg=name)
    fn, prefix = tfa._COUNTERS[route]
    kind = "narrow_calls" if d < 32 else "padded_calls"
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    want_moved = {(fn.__name__, prefix + kind): 1}
    if d >= 32:
        want_moved[(fn.__name__, prefix + "launches")] = 1
        width = 64 if d < 64 else 128
        shape = (B, H, width, SQ) if route == "ds" else (B, H, SQ, width)
        assert [c[:3] for c in fake_kernels] == [
            ("fwd", route, shape), ("bwd", route, shape)]
    else:
        assert fake_kernels == []
    assert moved == want_moved


@pytest.mark.parametrize("d", [64, 128])
def test_kernel_widths_are_not_padded(fake_kernels, d):
    """At 64 and 128 the kernels get the operands as they are, and neither
    counter moves."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 2, 24, d).astype(np.float32))
    before = _calls()
    tfa.flash_attention(q, q, q, causal=True)
    assert fake_kernels == [("fwd", "hsd", (1, 2, 24, d), True)]
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    assert moved == {("flash_attention", "launches"): 1}


@pytest.mark.parametrize("fn,shape,extra", [
    (tfa.flash_attention, (1, 2, 24, 320), ()),
    (tfa.flash_attention_bsd, (1, 24, 640), (2,)),
])
def test_heads_wider_than_128_raise_on_the_kernel_routes(fake_kernels, fn,
                                                         shape, extra):
    """Heads wider than 256 no longer raise: the kernel routes take head_dim
    320, zero-padded to the wide kernels' 384 and counted on the route's
    ``padded_calls``, and the result is the plain versions' (the name is
    the test's from when 320 was refused; widths 129 to 255 are padded to
    the head-256 kernels, `test_torch_flash_256.py`; the wide widths
    against the JAX package, `test_torch_flash_wide.py`)."""
    rng = np.random.RandomState(320)
    x = torch.from_numpy((0.5 * rng.randn(*shape)).astype(np.float32))
    before = _calls()
    got = fn(x, x, x, *extra, causal=True)
    heads = (1, 2, 24, 384)
    assert [c[:3] for c in fake_kernels] == [
        ("fwd", "hsd" if fn is tfa.flash_attention else "bsd_loop", heads)]
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    assert moved == {(fn.__name__, "launches"): 1,
                     (fn.__name__, "padded_calls"): 1}
    plain = (tfa.flash_attention_plain if fn is tfa.flash_attention
             else tfa.flash_attention_bsd_plain)
    want = plain(x, x, x, *extra, causal=True)
    assert got.shape == want.shape == shape
    assert float((got - want).abs().max()) <= ATOL
