"""Flash attention at head widths above 128, on the CPU.

The CUDA kernels take head_dim 256 beside 64 and 128 (each launch's grid
twice as wide at 256, a block computing one half of the output columns);
on a kernel route the router zero-pads 129 to 255 to 256 and counts the
call on the route's ``padded_calls``; above 256 it pads to the next
multiple of 128, the wide kernels' widths.  Here:

* the plain versions of `flash_attention` and `flash_attention_bsd`
  (the CPU path, the reference `chip_smoke.py` holds the kernels
  against) at head_dim 192 and 256 against the JAX package's Pallas
  forward and backward bodies in interpret mode, out, lse, dq, dk and dv;
* the routing at 160, 192 and 256 on every kernel route, with the kernels
  faked by the plain versions on the operands they would be handed
  (`fake_kernels` of `test_torch_flash_routes.py`): the width the kernels
  are asked for (256), the padded and launch counters, and the result
  against the JAX package;
* a head of 257 goes to the wide kernels, padded to 384.

The seeded inputs are `test_torch_flash_widths.py`'s (causal, Sq 40, Skv
56, q_offset 16, blocks of 16 in the Pallas bodies).  Bar: float32,
1e-4 of each array's largest magnitude (sums in another block order).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as tfa
from test_torch_flash_routes import clean_pins, fake_kernels  # noqa: F401
from test_torch_flash_widths import (B, H, NAMES, Q_OFF, SQ, _calls,
                                     _heads, _port, _reference, _to_bsd)
from test_torch_kernels import _one_thread  # noqa: F401


REL = 1e-4


def _check(got, want):
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        err = float(np.abs(a - w).max()) / float(np.abs(w).max())
        assert err <= REL, "%s: %.2e of max|ref|" % (name, err)


def _through(fn_name, inputs):
    """Out, lse, dq, dk, dv of the public function ``fn_name`` on the
    seeded inputs, (B, H, S, D) whatever the layout."""
    if fn_name == "flash_attention_bsd":
        got = _port(tfa.flash_attention_bsd,
                    [_to_bsd(t) for t in inputs[:4]] + [inputs[4]], H)
        return [_heads(got[0]), got[1]] + [_heads(t) for t in got[2:]]
    return _port(tfa.flash_attention, inputs)


@pytest.mark.parametrize("fn_name", ["flash_attention",
                                     "flash_attention_bsd"])
@pytest.mark.parametrize("d", [192, 256])
def test_plain_versions_match_jax(fn_name, d):
    """The CPU path at head_dim d: the plain versions, no kernel and no
    counter, against the Pallas bodies."""
    inputs, want = _reference(d)
    before = _calls()
    got = _through(fn_name, inputs)
    _check(got, want)
    assert _calls() == before
    # the plain function itself (`chip_smoke.py` swaps it in for the op,
    # which names its output) gives the same bits
    plain = getattr(tfa, fn_name + "_plain")
    q = torch.tensor(inputs[0])
    if fn_name == "flash_attention_bsd":
        out = plain(*(torch.tensor(_to_bsd(t)) for t in inputs[:3]), H,
                    causal=True, q_offset=Q_OFF, name="attn_out")
        out = _heads(out.numpy())
    else:
        out = plain(q, *(torch.tensor(t) for t in inputs[1:3]), causal=True,
                    q_offset=Q_OFF, name="attn_out").numpy()
    assert np.array_equal(out, got[0])


@pytest.mark.parametrize("pins,route", [
    ({}, "hsd"),
    ({"MXNET_FLASH_LAYOUT": "ds"}, "ds"),
    ({}, "bsd_loop"),
    ({"MXNET_FLASH_BSD_KERNEL": "stream"}, "bsd_stream"),
])
@pytest.mark.parametrize("d", [160, 192, 256])
def test_wide_heads_route_to_the_256_kernels(monkeypatch, fake_kernels, d,
                                             pins, route):
    """On each kernel route the kernels are handed 256 columns; 160 and
    192 count one padded call, 256 none; out, lse and the gradients match
    the JAX package."""
    for name, value in pins.items():
        monkeypatch.setenv(name, value)
    inputs, want = _reference(d)
    before = _calls()
    fn_name = "flash_attention_bsd" if route.startswith("bsd") \
        else "flash_attention"
    _check(_through(fn_name, inputs), want)
    shape = (B, H, 256, SQ) if route == "ds" else (B, H, SQ, 256)
    assert [c[:3] for c in fake_kernels] == [("fwd", route, shape),
                                             ("bwd", route, shape)]
    fn, prefix = tfa._COUNTERS[route]
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    want_moved = {(fn.__name__, prefix + "launches"): 1}
    if d != 256:
        want_moved[(fn.__name__, prefix + "padded_calls")] = 1
    assert moved == want_moved


@pytest.mark.parametrize("fn,shape,extra", [
    (tfa.flash_attention, (1, 2, 24, 257), ()),
    (tfa.flash_attention_bsd, (1, 24, 514), (2,)),
])
def test_heads_wider_than_256_raise(fake_kernels, fn, shape, extra):
    """head_dim 257 no longer raises: the kernel route zero-pads it to the
    wide kernels' 384, counts one padded call, and gives the plain
    versions' result (the name is the test's from when 257 was
    refused)."""
    rng = np.random.RandomState(257)
    x = torch.from_numpy((0.5 * rng.randn(*shape)).astype(np.float32))
    before = _calls()
    got = fn(x, x, x, *extra, causal=True)
    route = "hsd" if fn is tfa.flash_attention else "bsd_loop"
    assert [c[:3] for c in fake_kernels] == [("fwd", route, (1, 2, 24, 384))]
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    assert moved == {(fn.__name__, "launches"): 1,
                     (fn.__name__, "padded_calls"): 1}
    plain = (tfa.flash_attention_plain if fn is tfa.flash_attention
             else tfa.flash_attention_bsd_plain)
    want = plain(x, x, x, *extra, causal=True)
    assert got.shape == want.shape == shape
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= REL
