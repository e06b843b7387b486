"""The port's FeedForward, its training loop and checkpoints against the
JAX package's, on the CPU.

The MLP at 32-16-16-4 trains for 2 epochs on 512 samples of the
separable data of `examples/train_mnist.py:39-50` (a class's feature
raised by 3), batch 64, SGD with momentum 0.9 at lr 0.1, `Xavier`, from
the same seed in both packages: one context, then two CPU contexts with
``kvstore='local'`` (gradients summed through the store, each device's
updater applied).  Parameters are held to rtol 1e-4 / atol 1e-5, the
trajectory bars of `tests/test_torch_train.py`: float32 on both sides,
differing in the order of the sums of the matrix products.  `predict`
and `score` follow at the same bars; the validation metric each epoch
must agree to 1e-6 (counts over 128 samples).

Checkpoints carry across: what either package's `FeedForward.save` (or
`checkpoint.save`, with the optimizer state) writes, the other loads and
predicts the same from.  The auto-checkpoint and resume pins and
arguments act as in the JAX package, and so does
``MXNET_NONFINITE_BACKOFF``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_kernels import _one_thread  # noqa: F401


PK = {"jax": jmx, "torch": tmx}
RTOL, ATOL = 1e-4, 1e-5
N, DIM, K, BATCH = 512, 32, 4, 64


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, K, n)
    X = rng.randn(n, DIM).astype(np.float32) * 0.1
    X[np.arange(n), y * 7] += 3.0
    return X, y.astype(np.float32)


def mlp(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, name="fc1", num_hidden=16)
    h = mx.sym.Activation(data=h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=16)
    h = mx.sym.Activation(data=h, name="relu2", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc3", num_hidden=K)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def _fit(which, ctx=None, kvstore="local", epochs=2, **kw):
    """A FeedForward of package ``which`` after ``epochs`` epochs, and the
    validation metric it logged each epoch."""
    mx = PK[which]
    mx.random.seed(0)
    X, y = _data()
    Xv, yv = _data(128, seed=1)
    train = mx.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=True)
    val = mx.io.NDArrayIter(Xv, yv, batch_size=BATCH)
    ctx = ctx or [mx.cpu(0)]
    model = mx.model.FeedForward(mlp(mx), ctx=ctx, num_epoch=epochs,
                                 optimizer="sgd", learning_rate=0.1,
                                 momentum=0.9, initializer=mx.init.Xavier(),
                                 **kw)
    seen = []

    def on_eval(param):
        seen.append(param.eval_metric.get()[1])

    model.fit(train, eval_data=val, kvstore=kvstore,
              eval_batch_end_callback=on_eval)
    return model, seen


def _params(model):
    return {k: v.asnumpy() for k, v in model.arg_params.items()}


def _same_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("devices", [1, 2])
def test_fit_predict_score_match_the_jax_package(devices):
    res = {}
    for which, mx in PK.items():
        ctx = [mx.cpu(i) for i in range(devices)]
        model, seen = _fit(which, ctx=ctx)
        Xv, yv = _data(128, seed=1)
        res[which] = (_params(model), seen, model.predict(Xv),
                      model.score(mx.io.NDArrayIter(Xv, yv, batch_size=50)),
                      model.score(mx.io.NDArrayIter(Xv, yv, batch_size=50),
                                  eval_metric="ce"))
    (jp, jseen, jpred, jacc, jce), (tp, tseen, tpred, tacc, tce) = \
        res["jax"], res["torch"]
    _same_params(tp, jp)
    assert len(tseen) == len(jseen) == 2 * 2
    np.testing.assert_allclose(tseen, jseen, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpred, jpred, rtol=RTOL, atol=ATOL)
    assert tpred.shape == (128, K)
    assert tacc == jacc and tacc > 0.9
    np.testing.assert_allclose(tce, jce, rtol=RTOL)


def test_fused_update_switch_and_one_device_kvstore(monkeypatch):
    base, _ = _fit("torch", epochs=1)
    monkeypatch.setenv("MXNET_FUSED_UPDATE", "0")
    per_key, _ = _fit("torch", epochs=1)
    two, _ = _fit("torch", ctx=[tmx.cpu(0), tmx.cpu(1)], epochs=1)
    monkeypatch.delenv("MXNET_FUSED_UPDATE")
    two_fused, _ = _fit("torch", ctx=[tmx.cpu(0), tmx.cpu(1)], epochs=1)
    for a, b in ((base, per_key), (two, two_fused)):
        for k, v in _params(a).items():
            np.testing.assert_array_equal(v, _params(b)[k])
    store, _ = _fit("torch", epochs=1, kvstore=tmx.kv.create("local"))
    _same_params(_params(store), _params(base))


def test_numpy_arguments_and_jax_params_carry_in():
    X, y = _data()
    jmodel, _ = _fit("jax", epochs=1)
    arg = {k: v.asnumpy() for k, v in jmodel.arg_params.items()}
    tmodel = tmx.model.FeedForward(mlp(tmx), ctx=tmx.cpu(), arg_params=arg,
                                   numpy_batch_size=100)
    np.testing.assert_allclose(tmodel.predict(X), jmodel.predict(X),
                               rtol=RTOL, atol=ATOL)
    tmx.random.seed(0)
    made = tmx.model.FeedForward.create(
        mlp(tmx), X, y, ctx=tmx.cpu(), num_epoch=1, learning_rate=0.1,
        momentum=0.9, initializer=tmx.init.Xavier(), numpy_batch_size=BATCH)
    assert made.score(tmx.io.NDArrayIter(X, y, batch_size=BATCH)) > 0.9


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    reader = "jax" if writer == "torch" else "torch"
    model, _ = _fit(writer, epochs=1)
    prefix = str(tmp_path / "mlp")
    model.save(prefix)
    Xv, _ = _data(128, seed=1)
    want = model.predict(Xv)
    rx = PK[reader]
    back = rx.model.FeedForward.load(prefix, 1, ctx=rx.cpu())
    np.testing.assert_allclose(back.predict(Xv), want, rtol=RTOL, atol=ATOL)
    sym, arg, aux = rx.model.load_checkpoint(prefix, 1)
    assert sym.tojson() == model.symbol.tojson() and aux == {}
    rx.model.save_checkpoint(str(tmp_path / "again"), 1, sym, arg, aux)
    assert (tmp_path / "again-0001.params").read_bytes() == \
        (tmp_path / "mlp-0001.params").read_bytes()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_module_with_optimizer_state(tmp_path, writer):
    reader = "jax" if writer == "torch" else "torch"
    wx, rx = PK[writer], PK[reader]
    opt = wx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    upd = wx.optimizer.get_updater(opt)
    w = wx.nd.array(np.ones((3, 2), np.float32), ctx=wx.cpu())
    upd(0, wx.nd.array(np.full((3, 2), 0.5, np.float32), ctx=wx.cpu()), w)
    prefix = str(tmp_path / "ck")
    net = mlp(wx)
    wx.checkpoint.save(prefix, 3, net, {"fc1_weight": w}, {}, updater=upd)
    assert rx.checkpoint.latest_epoch(prefix) == 3
    sym, arg, aux, states, epoch = rx.checkpoint.load(prefix)
    assert epoch == 3 and sym.list_arguments() == net.list_arguments()
    np.testing.assert_array_equal(arg["fc1_weight"].asnumpy(), w.asnumpy())
    np.testing.assert_allclose(states[0].asnumpy(),
                               np.full((3, 2), -0.05, np.float32))
    rupd = rx.optimizer.get_updater(rx.optimizer.SGD(learning_rate=0.1,
                                                     momentum=0.9))
    rx.checkpoint.restore_updater(rupd, states)
    assert list(rupd.states) == [0]
    assert tmx.checkpoint.latest_epoch(str(tmp_path / "none")) is None


@pytest.mark.parametrize("pin", [
    ("MXNET_AUTO_CHECKPOINT", "ck"), ("MXNET_AUTO_CHECKPOINT_EVERY", "5"),
    ("MXNET_AUTO_RESUME", "1"), ("MXNET_NONFINITE_BACKOFF", "0.5"),
    ("MXNET_METRIC_INTERVAL", "4")])
def test_fault_tolerance_and_metric_pins_raise(monkeypatch, tmp_path, pin):
    """Each pin does what it does in the JAX package: the auto-checkpoint
    prefix (with an interval of 4 batches), the interval (with a prefix),
    the resume (from a file the first run left), the metric on the
    device, and the nonfinite backoff (with the guard, and NaN injected
    into the 3rd update: the step skipped, the lr halved once, the
    parameters those of the JAX package's same run)."""
    name, value = pin
    if name == "MXNET_NONFINITE_BACKOFF":
        monkeypatch.setenv(name, value)
        monkeypatch.setenv("MXNET_NONFINITE_GUARD", "1")
        monkeypatch.setenv("MXNET_CHAOS", "nan_grad:3")
        got = {}
        for which, mx in PK.items():
            mx.chaos.reset()
            mx.telemetry.reset()
            model, _ = _fit(which, epochs=1)
            ev = mx.telemetry.events("lr_backoff")
            assert [e["lr"] for e in ev] == [pytest.approx(0.05)]
            assert mx.telemetry.registry().counter(
                "train.nonfinite_steps").value == 1
            got[which] = _params(model)
        _same_params(got["torch"], got["jax"])
        return
    prefix = str(tmp_path / "ck")
    base, _ = _fit("torch", epochs=1)
    if name == "MXNET_AUTO_RESUME":
        ref, _ = _fit("torch", epochs=2)
        monkeypatch.setenv("MXNET_AUTO_CHECKPOINT", prefix)
        monkeypatch.setenv("MXNET_AUTO_CHECKPOINT_EVERY", "4")
        _fit("torch", epochs=1)
        monkeypatch.setenv(name, value)
        model, _ = _fit("torch", epochs=2)
        assert model.stats["train.resumes"] == 1
        _same_params(_params(model), _params(ref))
        return
    if name == "MXNET_AUTO_CHECKPOINT":
        monkeypatch.setenv("MXNET_AUTO_CHECKPOINT_EVERY", "4")
        monkeypatch.setenv(name, prefix)
    elif name == "MXNET_AUTO_CHECKPOINT_EVERY":
        monkeypatch.setenv("MXNET_AUTO_CHECKPOINT", prefix)
        monkeypatch.setenv(name, value)
    else:
        monkeypatch.setenv(name, value)
    model, _ = _fit("torch", epochs=1)
    _same_params(_params(model), _params(base))
    if name == "MXNET_METRIC_INTERVAL":
        # 8 batches: fetched at 4 and 8
        assert model.stats["train.host_blocking_fetches"] == 2
        return
    every = 4 if name == "MXNET_AUTO_CHECKPOINT" else 5
    state = tmx.checkpoint.load_auto(prefix)
    assert (state["epoch"], state["nbatch"]) == (1, 0)
    assert model.stats["train.auto_checkpoints"] == N // BATCH // every + 1


@pytest.mark.parametrize("arg", [{"auto_checkpoint": "ck"},
                                 {"checkpoint_every": 3},
                                 {"resume": "auto"}])
def test_fault_tolerance_arguments_raise(tmp_path, arg):
    """Each argument alone as in the JAX package: a prefix without an
    interval writes nothing, an interval without a prefix writes nothing,
    a resume with no prefix (or no file) starts afresh; with all three a
    run resumes."""
    prefix = str(tmp_path / "ck")
    arg = {k: (prefix if k == "auto_checkpoint" else v)
           for k, v in arg.items()}
    model = tmx.model.FeedForward(mlp(tmx), ctx=tmx.cpu(), num_epoch=1)
    X, y = _data()
    model.fit(X, y, **arg)
    assert model.stats["train.auto_checkpoints"] == 0
    assert model.stats["train.resumes"] == 0
    assert tmx.checkpoint.load_auto(prefix) is None
    model = tmx.model.FeedForward(mlp(tmx), ctx=tmx.cpu(), num_epoch=1)
    model.fit(X, y, auto_checkpoint=prefix, checkpoint_every=3)
    model = tmx.model.FeedForward(mlp(tmx), ctx=tmx.cpu(), num_epoch=2)
    model.fit(X, y, auto_checkpoint=prefix, checkpoint_every=3,
              resume="auto")
    assert model.stats["train.resumes"] == 1


def test_default_context_is_the_card():
    model = tmx.model.FeedForward(mlp(tmx))
    assert model.ctx == [tmx.gpu(0)]
