"""Flash attention at head widths above 256, on the CPU.

Above 256 a kernel route runs the wide kernels (`csrc/flash_attention_wide.cu`
in bf16, `csrc/flash_attention_wide_f32.cu` in float32), which take every
multiple of 128; the router zero-pads any other width to the next multiple
of 128 and counts the call on the route's ``padded_calls`` (scale from the
true head_dim).  Here, at head_dim 320, 384 and 512 with the seeded numpy
inputs of one seed (causal, Sq 40, Skv 56, q_offset 24, k_offset 8: every
query sees a key):

* the plain versions of `flash_attention` and `flash_attention_bsd` (the
  CPU path, the reference `chip_smoke.py` holds the wide kernels against)
  against the JAX package's public function, which takes its jnp path on
  the CPU: out, lse, dq, dk and dv, the lse cotangent included;
* every kernel route with the kernels faked by the plain versions on the
  operands they would be handed (`fake_kernels` of
  `test_torch_flash_routes.py`): the width the kernels are asked for (384
  for 320), the launch and padded counters, and the result against the
  JAX package;
* the dispatch to the wide C entries with the library faked, in both
  dtypes on every route: the entry, the head width it is handed, the
  launch counted on the route's counters and on its ``wide_`` ones;
* the wide sources among the ones `_build` compiles.

Bar: float32, 1e-5 of each array's largest magnitude (the same function
summed in another block order, over up to 56 keys).
"""
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
from test_torch_flash_routes import clean_pins, fake_kernels  # noqa: F401
from test_torch_flash_widths import B, H, NAMES, _heads, _to_bsd
from test_torch_kernels import _one_thread  # noqa: F401


REL = 1e-5
SQ, SKV, Q_OFF, K_OFF = 40, 56, 24, 8
WIDTHS = (320, 384, 512)
_REFS = {}


def _reference(d):
    """The seeded (q, k, v, g, glse) at head_dim ``d`` and the JAX
    package's (out, lse, dq, dk, dv) through `jax.vjp` of its public
    function."""
    if d not in _REFS:
        rng = np.random.RandomState(d)
        q, k, v, g = ((0.5 * rng.randn(B, H, s, d)).astype(np.float32)
                      for s in (SQ, SKV, SKV, SQ))
        glse = (0.5 * rng.randn(B, H, SQ)).astype(np.float32)
        (out, lse), vjp = jax.vjp(
            lambda *a: jfa.flash_attention(*a, causal=True, q_offset=Q_OFF,
                                           k_offset=K_OFF, with_lse=True),
            *(jnp.asarray(a) for a in (q, k, v)))
        grads = vjp((jnp.asarray(g), jnp.asarray(glse)))
        _REFS[d] = ((q, k, v, g, glse),
                    [np.asarray(a) for a in (out, lse, *grads)])
    return _REFS[d]


def _through(fn_name, inputs):
    """Out, lse, dq, dk, dv of the public function ``fn_name`` (B, H, S,
    D) whatever the layout."""
    bsd = fn_name.startswith("flash_attention_bsd")
    fn = getattr(tfa, fn_name)
    q, k, v, g, glse = inputs
    if bsd:
        q, k, v, g = (_to_bsd(t) for t in (q, k, v, g))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out, lse = fn(*leaves, *((H,) if bsd else ()), causal=True,
                  q_offset=Q_OFF, k_offset=K_OFF, with_lse=True)
    torch.autograd.backward((out, lse), (torch.tensor(g), torch.tensor(glse)))
    got = [out.detach().numpy(), lse.detach().numpy()] + [
        t.grad.numpy() for t in leaves]
    if bsd:
        got = [_heads(got[0]), got[1]] + [_heads(t) for t in got[2:]]
    return got


def _check(got, want):
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        err = float(np.abs(a - w).max()) / float(np.abs(w).max())
        assert err <= REL, "%s: %.2e of max|ref|" % (name, err)


def _calls():
    return {(fn.__name__, prefix + kind): getattr(fn, prefix + kind)
            for fn, prefix in tfa._COUNTERS.values()
            for kind in ("launches", "padded_calls", "narrow_calls",
                         "wide_launches", "wide_dq_launches",
                         "wide_dkv_launches")}


@pytest.mark.parametrize("fn_name", ["flash_attention",
                                     "flash_attention_bsd",
                                     "flash_attention_plain",
                                     "flash_attention_bsd_plain"])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_versions_match_jax(fn_name, d):
    """The CPU path at head_dim d (the public functions take the plain
    versions on CPU tensors, and the ``_plain`` functions on any device):
    no kernel and no counter."""
    inputs, want = _reference(d)
    before = _calls()
    _check(_through(fn_name, inputs), want)
    assert _calls() == before


@pytest.mark.parametrize("pins,route", [
    ({}, "hsd"),
    ({"MXNET_FLASH_LAYOUT": "ds"}, "ds"),
    ({}, "bsd_loop"),
    ({"MXNET_FLASH_BSD_KERNEL": "stream"}, "bsd_stream"),
])
@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_routes_take_wide_heads(monkeypatch, fake_kernels, d, pins,
                                       route):
    """On each kernel route the kernels are handed the next multiple of
    128 (384 for 320, which counts one padded call; 384 and 512 as they
    are); out, lse and the gradients match the JAX package."""
    for name, value in pins.items():
        monkeypatch.setenv(name, value)
    inputs, want = _reference(d)
    before = _calls()
    fn_name = "flash_attention_bsd" if route.startswith("bsd") \
        else "flash_attention"
    _check(_through(fn_name, inputs), want)
    width = -(-d // 128) * 128
    shape = (B, H, width, SQ) if route == "ds" else (B, H, SQ, width)
    assert [c[:3] for c in fake_kernels] == [("fwd", route, shape),
                                             ("bwd", route, shape)]
    fn, prefix = tfa._COUNTERS[route]
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    want_moved = {(fn.__name__, prefix + "launches"): 1}
    if width != d:
        want_moved[(fn.__name__, prefix + "padded_calls")] = 1
    assert moved == want_moved


@pytest.fixture()
def fake_lib(monkeypatch):
    """`_lib` replaced by fake libraries whose entries record (entry, head
    width handed over, which pass) and launch nothing; the device and
    stream lookups answered for CPU tensors.  Returns the calls."""
    calls = []

    def lib(source):
        def fwd(name):
            return lambda dtype, d, layout, *rest: calls.append(
                (name, d, "fwd")) or 0

        def bwd(name):
            return lambda which, dtype, d, layout, *rest: calls.append(
                (name, d, which)) or 0
        entries = {}
        for table, make in ((tfa._FWD_ENTRIES, fwd),
                            (tfa._WIDE_FWD_ENTRIES, fwd),
                            (tfa._BWD_ENTRIES, bwd),
                            (tfa._WIDE_BWD_ENTRIES, bwd)):
            for s, name in table.values():
                if s == source:
                    entries[name] = make(name)
        return types.SimpleNamespace(**entries)

    monkeypatch.setattr(tfa, "_lib", lib)
    monkeypatch.setattr(tfa._build, "check_current_device",
                        lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype,fwd,bwd", [
    (torch.bfloat16, "mxt_flash_attention_fwd_wide_bf16",
     "mxt_flash_attention_bwd_wide_bf16"),
    (torch.float32, "mxt_flash_attention_fwd_wide_f32",
     "mxt_flash_attention_bwd_wide_f32"),
])
@pytest.mark.parametrize("route", ["hsd", "ds", "bsd_loop", "bsd_stream"])
def test_wide_dispatch_by_dtype(fake_lib, dtype, fwd, bwd, route):
    """At head_dim 512 the forward and both backward passes launch the
    wide entries of their dtype, handed 512, each counted once on the
    route's counters and once on its ``wide_`` ones; at 256 the head-256
    entries run and no wide counter moves."""
    ds = route == "ds"
    fn, prefix = tfa._COUNTERS[route]

    def operands(d):
        ts = [torch.randn(1, 2, 72, d).to(dtype) for _ in range(4)]
        return [tfa._to_ds(t) for t in ts] if ds else ts

    q, k, v, g = operands(512)
    before = _calls()
    out, lse = tfa._flash_fwd_cuda(q, k, v, 0, 0, 0.125, True, True, route)
    tfa._flash_bwd_cuda(q, k, v, out, lse, g, None, 0, 0, 0.125, True,
                        route)
    assert fake_lib == [(fwd, 512, "fwd"), (bwd, 512, 0), (bwd, 512, 1)]
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    assert moved == {(fn.__name__, prefix + kind): 1 for kind in (
        "launches", "wide_launches", "wide_dq_launches",
        "wide_dkv_launches")}
    del fake_lib[:]
    q, k, v, g = operands(256)
    before = _calls()
    out, lse = tfa._flash_fwd_cuda(q, k, v, 0, 0, 0.125, True, True, route)
    tfa._flash_bwd_cuda(q, k, v, out, lse, g, None, 0, 0, 0.125, True,
                        route)
    assert [c[:2] for c in fake_lib] == [
        (tfa._FWD_ENTRIES[dtype][1], 256), (tfa._BWD_ENTRIES[dtype][1], 256),
        (tfa._BWD_ENTRIES[dtype][1], 256)]
    moved = {k: n - before[k] for k, n in _calls().items() if n != before[k]}
    assert moved == {(fn.__name__, prefix + "launches"): 1}


def test_widths_the_kernels_take():
    """`_wide` takes every multiple of 128 above 256 and nothing else; a
    width the kernels refuse raises in `_check_cuda_args` before any
    launch; no head_dim of 32 or more is refused by the router."""
    assert [d for d in range(1, 2049) if tfa._wide(d)] == \
        list(range(384, 2049, 128))
    x = torch.zeros(1, 2, 8, 320)
    with pytest.raises(tfa.MXNetError, match="multiple of 128 above 256"):
        tfa._check_cuda_args(x, x, x)
    for d in (32, 100, 255, 257, 320, 383, 384, 1000, 4096):
        width = tfa._kernel_width(d, "hsd")
        assert width >= d and (width in tfa._HEAD_DIMS or tfa._wide(width))
        assert d <= 256 or width - d < 128


def test_wide_sources_build_with_the_others():
    """The two wide sources are among the ones `_build` compiles at first
    use (each its own nvcc, all started together), each includes its
    dtype's header and exports the entries the router calls."""
    csrc = Path(tfa.__file__).parents[2] / "csrc"
    for source, header in (("flash_attention_wide", "wgmma.cuh"),
                           ("flash_attention_wide_f32", "tf32.cuh")):
        assert source in _build.KERNELS
        text = (csrc / ("%s.cu" % source)).read_text()
        assert '#include "%s"' % header in text
        for table in (tfa._WIDE_FWD_ENTRIES, tfa._WIDE_BWD_ENTRIES):
            names = [n for s, n in table.values() if s == source]
            assert len(names) == 1 and ("int %s(" % names[0]) in text
