"""The nonfinite-gradient guard, chaos's ``nan_grad`` and the lr backoff
of the port against the JAX package's, on the CPU.

The counterparts of `tests/test_fault_tolerance.py` (guard, chaos,
backoff) and `tests/test_prefetch_metrics.py` (guarded Adam's device step
counter), each run in both packages from the same numpy inputs:

* ``MXNET_NONFINITE_GUARD=1`` skips a whole bucket (weights and states)
  when one gradient element is NaN or Inf, SGD and Adam; without it a NaN
  passes through; ``MXNET_CHAOS=nan_grad:N`` poisons exactly call N;
* guarded Adam's skipped step does not advance its bias correction: a
  run with the skip equals, bit for bit, a run without that step, while
  the host counts still advance; the device counters (``guard_counts``)
  survive an auto-checkpoint written by either package and resumed by
  the other;
* through `Module.fit` and `FeedForward.fit` on an MLP: guarded Adam
  with NaN injected into the 3rd of 5 updates within 1e-4 of max|w| of
  the JAX package's run (float32 on both sides, the guarded lr_t folded
  in float32 on the device in both); the port's run bit for bit a run
  over the same batches without the 3rd; ``MXNET_NONFINITE_BACKOFF=0.5``
  halves the lr once, with one ``lr_backoff`` event, and the telemetry
  counters of the fit (blocking fetches included) equal the JAX
  package's name for name.

Bars: bit for bit within a package; 1e-6 of max|w| between packages on
a few optimizer steps (a few float32 operations an element), 1e-4 on
the fits (`tests/test_torch_model.py`'s trajectory bar).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_kernels import _one_thread  # noqa: F401


PK = {"jax": jmx, "torch": tmx}
G1 = np.full((8,), 0.5, np.float32)
G2 = np.full((8,), -0.25, np.float32)
NAN = np.full((8,), np.nan, np.float32)
W0 = np.linspace(-1, 1, 8).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for v in ("MXNET_CHAOS", "MXNET_NONFINITE_GUARD",
              "MXNET_NONFINITE_BACKOFF", "MXNET_TELEMETRY_HEALTH"):
        monkeypatch.delenv(v, raising=False)
    for mx in PK.values():
        mx.chaos.reset()
        mx.telemetry.reset()
    yield
    for mx in PK.values():
        mx.chaos.reset()
        mx.telemetry.reset()


def _close(got, want, bar=1e-6):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * max(np.abs(want).max(), 1e-30))


def _arr(mx, a):
    return mx.nd.array(np.asarray(a, np.float32), ctx=mx.cpu())


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_guard_skips_the_whole_bucket(monkeypatch, kind):
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    finals = []
    for mx in PK.values():
        opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9) \
            if kind == "sgd" else mx.optimizer.Adam(learning_rate=0.01)
        upd = mx.optimizer.get_fused_updater(opt)
        ws = [_arr(mx, np.ones(3)), _arr(mx, np.full(2, 2.0))]
        good = [np.ones(3), np.ones(2)]
        bad = [np.ones(3), np.array([np.nan if kind == "sgd" else np.inf,
                                     1.0])]

        def snap():
            out = [w.asnumpy().copy() for w in ws]
            for i in (0, 1):
                st = upd.states[i]
                out += [s.asnumpy().copy() for s in
                        (st if isinstance(st, tuple) else (st,))]
            return out

        upd([0, 1], [_arr(mx, g) for g in good], ws)
        before = snap()
        upd([0, 1], [_arr(mx, g) for g in bad], ws)
        for a, b in zip(snap(), before):
            np.testing.assert_array_equal(a, b)
        assert mx.telemetry.consume_nonfinite() == 1
        assert mx.telemetry.consume_nonfinite() == 0
        upd([0, 1], [_arr(mx, g) for g in good], ws)
        assert not np.array_equal(ws[0].asnumpy(), before[0])
        finals.append(snap())
    for t, j in zip(finals[1], finals[0]):
        _close(t, j)


def test_guard_off_lets_nan_through():
    for mx in PK.values():
        upd = mx.optimizer.get_fused_updater(
            mx.optimizer.SGD(learning_rate=0.1))
        ws = [_arr(mx, np.ones(3))]
        upd([0], [_arr(mx, [np.nan, 1, 1])], ws)
        assert np.isnan(ws[0].asnumpy()).any()


@pytest.mark.parametrize("spec", ["nan_grad:2", "nan_grad:2:inf"])
def test_chaos_nan_grad_with_the_guard(monkeypatch, spec):
    monkeypatch.setenv("MXNET_CHAOS", spec)
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    finals = []
    for mx in PK.values():
        upd = mx.optimizer.get_fused_updater(
            mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        w = _arr(mx, np.ones(3))
        g = _arr(mx, np.ones(3))
        upd([0], [g], [w])
        after1 = w.asnumpy().copy()
        upd([0], [g], [w])  # call 2: poisoned, skipped
        np.testing.assert_array_equal(w.asnumpy(), after1)
        upd([0], [g], [w])
        assert np.isfinite(w.asnumpy()).all()
        assert not np.array_equal(w.asnumpy(), after1)
        assert mx.chaos.spec().fused_update_calls == 3
        finals.append(w.asnumpy())
    _close(finals[1], finals[0])


def _adam_run(mx, grads):
    opt = mx.optimizer.Adam(learning_rate=0.01)
    upd = mx.optimizer.get_fused_updater(opt)
    w = _arr(mx, W0)
    for g in grads:
        upd([0], [_arr(mx, g)], [w])
    m, v = upd.states[0]
    return [w.asnumpy(), m.asnumpy(), v.asnumpy()], opt, upd, w


def test_adam_skipped_step_does_not_advance_bias_correction(monkeypatch):
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    got = {}
    for which, mx in PK.items():
        skip, opt, _, _ = _adam_run(mx, [G1, NAN, G2])
        ref, _, _, _ = _adam_run(mx, [G1, G2])
        for a, b in zip(skip, ref):
            np.testing.assert_array_equal(a, b)
        assert opt._index_update_count[0] == 3
        got[which] = skip
    for t, j in zip(got["torch"], got["jax"]):
        _close(t, j)
    # the guarded fold is float32, the host fold float64: a few ulp apart
    guarded, _, _, _ = _adam_run(tmx, [G1, G2, G1])
    monkeypatch.delenv("MXNET_NONFINITE_GUARD")
    plain, _, _, _ = _adam_run(tmx, [G1, G2, G1])
    np.testing.assert_allclose(guarded[0], plain[0], rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_guard_counts_survive_an_auto_checkpoint(monkeypatch, tmp_path,
                                                 writer):
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    reader = "torch" if writer == "jax" else "jax"
    wx, rx = PK[writer], PK[reader]
    _, _, upd, w = _adam_run(wx, [G1, NAN])
    prefix = str(tmp_path / "g")
    wx.checkpoint.save_auto(prefix, {"w": w}, {}, updater=upd)
    state = rx.checkpoint.load_auto(prefix)
    np.testing.assert_array_equal(
        list(state["guard_counts"].values())[0], [1.0])
    opt2 = rx.optimizer.Adam(learning_rate=0.01)
    upd2 = rx.optimizer.get_fused_updater(opt2)
    rx.checkpoint.restore_auto(state, upd2)
    assert opt2._index_update_count[0] == 2
    w2 = _arr(rx, state["arg"]["w"].asnumpy())
    upd2([0], [_arr(rx, G2)], [w2])
    want, _, _, _ = _adam_run(rx, [G1, NAN, G2])
    _close(w2.asnumpy(), want[0])
    if reader == "torch":  # the port's own round trip is exact
        _, _, upd, w = _adam_run(tmx, [G1, NAN])
        tmx.checkpoint.save_auto(prefix, {"w": w}, {}, updater=upd)
        state = tmx.checkpoint.load_auto(prefix)
        upd3 = tmx.optimizer.get_fused_updater(
            tmx.optimizer.Adam(learning_rate=0.01))
        tmx.checkpoint.restore_auto(state, upd3)
        w3 = _arr(tmx, state["arg"]["w"].asnumpy())
        upd3([0], [_arr(tmx, G2)], [w3])
        np.testing.assert_array_equal(w3.asnumpy(), want[0])


# -- through the training loops ------------------------------------------------

N_BATCH, BATCH, DIM, K = 5, 16, 20, 4


def _data(drop=None):
    rng = np.random.RandomState(0)
    X = rng.randn(N_BATCH * BATCH, DIM).astype(np.float32)
    y = rng.randint(0, K, N_BATCH * BATCH).astype(np.float32)
    X[np.arange(len(y)), y.astype(int) * 3] += 2.0
    if drop is not None:
        keep = np.ones(len(y), bool)
        keep[drop * BATCH:(drop + 1) * BATCH] = False
        X, y = X[keep], y[keep]
    return X, y


def _mlp(mx):
    h = mx.sym.FullyConnected(data=mx.sym.Variable("data"), name="fc1",
                              num_hidden=16)
    h = mx.sym.Activation(data=h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=K)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def _fit(mx, how, drop=None):
    """Parameters (numpy) after one epoch of guarded Adam on the MLP."""
    mx.random.seed(0)
    X, y = _data(drop)
    it = mx.io.NDArrayIter(X, y, batch_size=BATCH)
    if how == "module":
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                initializer=mx.init.Xavier())
        arg = mod.get_params()[0]
    else:
        model = mx.model.FeedForward(_mlp(mx), ctx=mx.cpu(), num_epoch=1,
                                     optimizer="adam", learning_rate=0.01,
                                     initializer=mx.init.Xavier())
        model.fit(it)
        arg = model.arg_params
    return {k: v.asnumpy() for k, v in arg.items()}


@pytest.mark.parametrize("how", ["module", "feedforward"])
def test_guarded_adam_fit_matches_jax(monkeypatch, how):
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    monkeypatch.setenv("MXNET_CHAOS", "nan_grad:3")
    got = {}
    for which, mx in PK.items():
        mx.chaos.reset()
        got[which] = _fit(mx, how)
    monkeypatch.delenv("MXNET_CHAOS")
    without = _fit(tmx, how, drop=2)
    for k, j in got["jax"].items():
        _close(got["torch"][k], j, bar=1e-4)
        np.testing.assert_array_equal(got["torch"][k], without[k], err_msg=k)


# the training-path counters both packages count (the JAX package's
# dispatch.* counters come from its profiler, which is not ported)
def _train_counters(mx):
    return {k: v for k, v in mx.telemetry.registry()._counters.items()
            if not k.startswith("dispatch.")}


def test_backoff_halves_the_lr_once(monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS", "nan_grad:3")
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
    monkeypatch.setenv("MXNET_NONFINITE_BACKOFF", "0.5")
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "2")
    monkeypatch.setenv("MXNET_METRIC_INTERVAL", "3")
    counters, params = {}, {}
    for which, mx in PK.items():
        mx.random.seed(0)
        X, y = _data()
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mod.fit(mx.io.NDArrayIter(np.concatenate([X, X[:BATCH]]),
                                  np.concatenate([y, y[:BATCH]]),
                                  batch_size=BATCH),
                num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        assert mod._optimizer.lr == pytest.approx(0.05)
        assert len(mx.telemetry.events("lr_backoff")) == 1
        assert len(mx.telemetry.events("nonfinite_grads")) == 1
        params[which] = {k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()}
        counters[which] = _train_counters(mx)
    assert counters["torch"] == counters["jax"]
    # 6 batches: a health drain after each update, and 2 metric fetches
    assert counters["torch"]["train.host_blocking_fetches"] == 8
    assert counters["torch"]["train.nonfinite_steps"] == 1
    for k, j in params["jax"].items():
        assert np.isfinite(params["torch"][k]).all()
        _close(params["torch"][k], j, bar=1e-4)
