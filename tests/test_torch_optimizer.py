"""The port's optimizer classes and lr schedulers against the JAX
package's, on the CPU.

Every optimizer takes 3 steps on three parameters, through `update` (one
parameter at a time) and through `update_multi` (the fused form), with an
lr scheduler, ``rescale_grad``, ``clip_gradient`` (some elements clipped,
some not) and lr/wd multipliers, from the same weights and gradients in
both packages.  Bar: 1e-6 of max|w|, on gradients drawn away from zero
(|g| in [0.5, 1.5]): each step is a few float32 operations an element,
so the packages differ by a few ulp.  Adam is also run on gradients with
elements near zero, where it divides rounding noise by a square root of
the same size: there it is held to `tests/test_torch_train.py`'s
trajectory bars (rtol 1e-4, atol 1e-5).

In the port, the fused form gives exactly the numbers of the per-key
form, and so does the fused updater under ``MXNET_FUSED_UPDATE=0``.
SGLD draws its noise from the same keys as the JAX package (agreeing to
float32 rounding: torch's `erfinv` is not XLA's); Adam's bfloat16 second
moment is stored bit for bit as the JAX package stores it.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

SHAPES = [(4, 3), (5,), (2, 3, 2)]
NAMES = {0: "fc_weight", 1: "fc_bias", 2: "conv_weight"}
STEPS = 3

CONFIGS = {
    "sgd_momentum": ("sgd", dict(momentum=0.9, wd=1e-2)),
    "sgd": ("sgd", dict(wd=1e-2)),
    "ccsgd": ("ccsgd", dict(momentum=0.5)),
    "adam": ("adam", dict(wd=1e-3)),
    "adagrad": ("adagrad", dict(wd=1e-2)),
    "rmsprop": ("rmsprop", dict(wd=1e-3)),
    "adadelta": ("adadelta", dict(wd=1e-2)),
    "test": ("test", {}),
}


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _grads(step, near_zero=False):
    rng = np.random.RandomState(100 + step)
    out = []
    for s in SHAPES:
        g = np.sign(rng.randn(*s)) * rng.uniform(0.5, 1.5, s)
        if near_zero:
            g = g * (rng.uniform(size=s) < 0.5) * 1e-7 + \
                g * (rng.uniform(size=s) >= 0.5)
        out.append(g.astype(np.float32))
    return out


def _make(mx, name, kw, **extra):
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = mx.optimizer.create(
        name, rescale_grad=0.5, clip_gradient=0.6, learning_rate=0.05,
        lr_scheduler=sched, param_idx2name=NAMES, **dict(kw, **extra))
    opt.set_lr_mult({"conv_weight": 0.5})
    opt.set_wd_mult({"fc_weight": 2.0})
    return opt


def _run(mx, name, kw, fused, near_zero=False, ctx=None, **extra):
    ctx = ctx or mx.cpu()
    opt = _make(mx, name, kw, **extra)
    ws = [mx.nd.array(w, ctx=ctx) for w in _weights()]
    states = [opt.create_state(i, w) for i, w in enumerate(ws)]
    for step in range(STEPS):
        gs = [mx.nd.array(g, ctx=ctx) for g in _grads(step, near_zero)]
        if fused:
            opt.update_multi(list(range(len(ws))), ws, gs, states)
        else:
            for i, (w, g, s) in enumerate(zip(ws, gs, states)):
                opt.update(i, w, g, s)
    return [w.asnumpy() for w in ws], states, opt


@pytest.mark.parametrize("fused", [False, True], ids=["update", "multi"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_optimizer_matches_the_jax_package(cfg, fused):
    name, kw = CONFIGS[cfg]
    want, _, jopt = _run(jmx, name, kw, fused)
    got, _, topt = _run(tmx, name, kw, fused)
    assert topt.num_update == jopt.num_update
    assert topt._index_update_count == jopt._index_update_count
    for g, w, w0 in zip(got, want, _weights()):
        assert np.abs(g - w0).max() > 1e-3  # the step moved the weights
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_fused_form_gives_the_per_key_numbers(cfg):
    name, kw = CONFIGS[cfg]
    per_key, s1, _ = _run(tmx, name, kw, fused=False)
    fused, s2, _ = _run(tmx, name, kw, fused=True)
    for a, b in zip(per_key, fused):
        np.testing.assert_array_equal(a, b)


def test_fused_updater_honours_the_kill_switch(monkeypatch):
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_FUSED_UPDATE", flag)
        opt = _make(tmx, "adam", {})
        upd = tmx.optimizer.get_fused_updater(opt)
        ws = [tmx.nd.array(w, ctx=tmx.cpu()) for w in _weights()]
        for step in range(STEPS):
            gs = [tmx.nd.array(g, ctx=tmx.cpu()) for g in _grads(step)]
            upd(list(range(3)), gs, ws)
        out[flag] = [w.asnumpy() for w in ws]
        assert sorted(upd.states) == [0, 1, 2]
    for a, b in zip(out["1"], out["0"]):
        np.testing.assert_array_equal(a, b)


def test_adam_near_zero_gradients_within_trajectory_bars():
    want, _, _ = _run(jmx, "adam", {}, True, near_zero=True)
    got, _, _ = _run(tmx, "adam", {}, True, near_zero=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["update", "multi"])
def test_sgld_draws_the_jax_noise(fused):
    runs = []
    for mx in (jmx, tmx):
        mx.random.seed(7)
        runs.append(_run(mx, "sgld", {"wd": 1e-2}, fused)[0])
    for g, w, w0 in zip(runs[1], runs[0], _weights()):
        assert np.abs(g - w0).max() > 1e-2
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("fused", [False, True], ids=["update", "multi"])
def test_adam_bf16_second_moment_bit_identical(fused):
    runs = []
    for mx in (jmx, tmx):
        mx.random.seed(3)
        runs.append(_run(mx, "adam", {}, fused, v_dtype="bfloat16"))
    (jw, js, _), (tw, ts, _) = runs
    for (jm, jv), (tm, tv) in zip(js, ts):
        assert tv.data.dtype == torch.bfloat16
        want = np.asarray(jv.asnumpy()).astype(ml_dtypes.bfloat16)
        got = tv.data.view(torch.int16).numpy()
        np.testing.assert_array_equal(got, want.view(np.int16))
    for g, w in zip(tw, jw):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_nonfinite_guard_raises(monkeypatch):
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    opt = tmx.optimizer.SGD(learning_rate=0.1)
    w = tmx.nd.array(_weights()[0], ctx=tmx.cpu())
    g = tmx.nd.array(_grads(0)[0], ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="MXNET_NONFINITE_GUARD"):
        opt.update_multi([0], [w], [g], [None])
    np.testing.assert_array_equal(w.asnumpy(), _weights()[0])


def test_registry_and_updater_closure():
    assert isinstance(tmx.optimizer.create("ccsgd"), tmx.optimizer.SGD)
    assert sorted(tmx.optimizer.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry)
    with pytest.raises(MXNetError):
        tmx.optimizer.create("nosuch")
    with pytest.raises(MXNetError):
        tmx.optimizer.Adam(v_dtype="float16")
    opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(_weights()[1], ctx=tmx.cpu())
    upd(0, tmx.nd.array(_grads(0)[1], ctx=tmx.cpu()), w)
    assert upd.optimizer is opt and 0 in upd.states
    import pickle

    back = pickle.loads(pickle.dumps(opt))
    assert back.momentum == 0.9 and back.sym is None


def test_multipliers_from_symbol_attributes():
    for mx in (jmx, tmx):
        w = mx.sym.Variable("fc_weight", lr_mult=0.25, wd_mult=0.0)
        net = mx.sym.FullyConnected(data=mx.sym.Variable("data"), weight=w,
                                    num_hidden=3, name="fc")
        opt = mx.optimizer.SGD(sym=net, param_idx2name={0: "fc_weight",
                                                        1: "fc_bias"})
        assert opt.lr_mult == {"fc_weight": 0.25}
        assert opt.wd_mult == {"fc_bias": 0.0, "fc_weight": 0.0}


SCHEDULERS = {
    "factor": lambda mx: mx.lr_scheduler.FactorScheduler(3, 0.5, 1e-3),
    "multifactor": lambda mx: mx.lr_scheduler.MultiFactorScheduler(
        [2, 5, 9], 0.3),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_lr_schedulers_match(kind):
    j, t = SCHEDULERS[kind](jmx), SCHEDULERS[kind](tmx)
    j.base_lr = t.base_lr = 0.1
    for n in list(range(1, 15)) + [40, 41]:
        assert t(n) == j(n)
    with pytest.raises(MXNetError):
        tmx.lr_scheduler.FactorScheduler(0)
