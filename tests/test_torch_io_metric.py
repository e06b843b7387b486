"""The port's data iterators, metrics, callbacks and local KVStore
against the JAX package's, on the CPU.

* `NDArrayIter` gives the same batches, shuffles (numpy's global
  generator after the same seed), pads and discards; `CSVIter` and
  `MNISTIter` read the same files into the same batches, the MNIST idx
  files written by `tools/make_mnist.py` run as a subprocess.
* Every metric class gives the JAX package's values on the same labels
  and predictions (both compute in numpy; float64 sums, compared to
  1e-12 relative).
* `KVStore('local')` push and pull over two CPU contexts give the JAX
  package's arrays: the sums exactly, an SGD step on the store to 1e-6
  of max|w| (the optimizers' bar).
* ``MXNET_DEVICE_PREFETCH`` at 0 (each batch copied in the step) and 2
  (batches staged ahead by `io.DevicePrefetchIter` and bound in place)
  give the same numbers; ``MXNET_METRIC_INTERVAL`` takes any step count
  and refuses a malformed one.
"""
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PK = {"jax": jmx, "torch": tmx}
REPO = Path(__file__).resolve().parents[1]


def _batches(it):
    return [([d.asnumpy() for d in b.data], [lab.asnumpy() for lab in b.label],
             b.pad) for b in it]


def _same_batches(j, t):
    assert len(t) == len(j)
    for (jd, jl, jp), (td, tl, tp) in zip(j, t):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(a, b)


ITERS = {
    "pad": dict(batch_size=32, last_batch_handle="pad"),
    "discard": dict(batch_size=32, last_batch_handle="discard"),
    "shuffle": dict(batch_size=25, shuffle=True),
    "roll_over": dict(batch_size=40, last_batch_handle="roll_over",
                      shuffle=True),
}


@pytest.mark.parametrize("kind", sorted(ITERS))
def test_ndarray_iter_matches(kind):
    rng = np.random.RandomState(0)
    X = rng.randn(100, 3, 2).astype(np.float32)
    y = rng.randint(0, 5, 100).astype(np.float32)
    res = {}
    for which, mx in PK.items():
        mx.random.seed(4)
        it = mx.io.NDArrayIter(X, y, **ITERS[kind])
        epochs = []
        for _ in range(3):
            epochs.append(_batches(it))
            it.reset()
        res[which] = (epochs, it.provide_data, it.provide_label)
    assert res["torch"][1:] == res["jax"][1:]
    for t, j in zip(res["torch"][0], res["jax"][0]):
        _same_batches(j, t)
    batch = next(iter(tmx.io.NDArrayIter(X, y, batch_size=10)))
    assert batch.data[0].context == tmx.cpu()


def test_ndarray_iter_named_inputs_and_errors():
    X = np.arange(24, dtype=np.float32).reshape(12, 2)
    for mx in PK.values():
        it = mx.io.NDArrayIter({"a": X, "b": X * 2}, None, batch_size=4)
        assert [n for n, _ in it.provide_data] == ["a", "b"]
        assert it.provide_label == []
    with pytest.raises(MXNetError):
        tmx.io.NDArrayIter(X, batch_size=20)
    it = tmx.io.NDArrayIter(X, X[:, 0], batch_size=5)
    assert it.iter_next() and it.getpad() == 0
    assert it.getdata().shape == (5, 2) and it.getlabel().shape == (5,)


def test_csv_iter_matches(tmp_path):
    rng = np.random.RandomState(1)
    data = rng.randn(30, 6).astype(np.float32)
    label = rng.randint(0, 3, (30, 1)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for kw in (dict(), dict(round_batch=False, part_index=1, num_parts=2)):
        res = {which: _batches(mx.io.CSVIter(
            str(tmp_path / "d.csv"), (2, 3), str(tmp_path / "l.csv"),
            batch_size=7, **kw)) for which, mx in PK.items()}
        _same_batches(res["jax"], res["torch"])


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    out = tmp_path_factory.mktemp("mnist")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_mnist.py"),
                    "--out", str(out), "--train", "256", "--test", "64"],
                   check=True, capture_output=True, timeout=120)
    return out


@pytest.mark.parametrize("kw", [dict(flat=True), dict(shuffle=False),
                                dict(part_index=1, num_parts=3, seed=5),
                                dict(input_shape=(28, 28), flat=False)],
                         ids=["flat", "ordered", "parts", "shape"])
def test_mnist_iter_matches(mnist, kw):
    res = {}
    for which, mx in PK.items():
        it = mx.io.MNISTIter(str(mnist / "train-images-idx3-ubyte"),
                             str(mnist / "train-labels-idx1-ubyte"),
                             batch_size=50, **kw)
        res[which] = (_batches(it), it.provide_data, it.provide_label)
    _same_batches(res["jax"][0], res["torch"][0])
    assert res["torch"][1:] == res["jax"][1:]
    with pytest.raises(MXNetError):
        tmx.io.MNISTIter(str(mnist / "train-labels-idx1-ubyte"),
                         str(mnist / "train-labels-idx1-ubyte"))


def _preds(seed=0, n=12, k=4):
    rng = np.random.RandomState(seed)
    p = rng.uniform(size=(n, k)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    return rng.randint(0, k, n).astype(np.float32), p


def _custom(label, pred):
    return float(np.abs(label - pred.argmax(1)).sum()), len(label)


METRICS = {
    "acc": lambda mx: mx.metric.create("acc"),
    "top_k": lambda mx: mx.metric.TopKAccuracy(top_k=2),
    "f1": lambda mx: mx.metric.F1(),
    "mae": lambda mx: mx.metric.MAE(),
    "mse": lambda mx: mx.metric.MSE(),
    "rmse": lambda mx: mx.metric.create("rmse"),
    "ce": lambda mx: mx.metric.create("ce"),
    "torch": lambda mx: mx.metric.Torch(),
    "custom": lambda mx: mx.metric.create(_custom),
    "np": lambda mx: mx.metric.np(_custom, name="c"),
    "composite": lambda mx: mx.metric.CompositeEvalMetric(["acc", "ce"]),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match(name):
    res = {}
    for which, mx in PK.items():
        m = METRICS[name](mx)
        for seed in range(3):
            label, pred = _preds(seed, k=2 if name == "f1" else 4)
            if name in ("mae", "mse", "rmse"):
                pred = pred[:, :1]
            m.update([mx.nd.array(label, ctx=mx.cpu())],
                     [mx.nd.array(pred, ctx=mx.cpu())])
        res[which] = (m.get(), m.get_name_value())
        m.reset()
        assert m.get_name_value()
    (jn, jv), (tn, tv) = res["jax"][0], res["torch"][0]
    assert tn == jn
    np.testing.assert_allclose(np.asarray(tv, np.float64),
                               np.asarray(jv, np.float64), rtol=1e-12)
    assert [n for n, _ in res["torch"][1]] == [n for n, _ in res["jax"][1]]


def test_metric_errors_and_interval(monkeypatch):
    with pytest.raises(MXNetError):
        tmx.metric.create("nosuch")
    with pytest.raises(MXNetError):
        tmx.metric.TopKAccuracy(top_k=1)
    assert tmx.metric.metric_interval() == 1
    monkeypatch.setenv("MXNET_METRIC_INTERVAL", "8")
    assert tmx.metric.metric_interval() == \
        jmx.metric.metric_interval() == 8
    monkeypatch.setenv("MXNET_METRIC_INTERVAL", "eight")
    with pytest.raises(MXNetError, match="MXNET_METRIC_INTERVAL"):
        tmx.metric.metric_interval()


def _kv_run(mx, optimizer):
    """Push two devices' values for keys 3 and 'w' and pull them back."""
    rng = np.random.RandomState(2)
    init = rng.randn(4, 3).astype(np.float32)
    g = [rng.randn(4, 3).astype(np.float32) for _ in range(2)]
    kv = mx.kv.create("local")
    ctxs = [mx.cpu(0), mx.cpu(1)]
    kv.init([3, "w"], [mx.nd.array(init, ctx=mx.cpu()),
                       mx.nd.array(init * 2, ctx=mx.cpu())])
    if optimizer:
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    vals = [[mx.nd.array(x, ctx=c) for x, c in zip(g, ctxs)]] * 2
    kv.push([3, "w"], vals)
    kv.push(3, [mx.nd.array(x, ctx=c) for x, c in zip(g, ctxs)])
    outs = [[mx.nd.zeros((4, 3), c) for c in ctxs] for _ in range(2)]
    kv.pull([3, "w"], out=outs)
    return [[o.asnumpy() for o in row] for row in outs], kv


@pytest.mark.parametrize("optimizer", [False, True], ids=["sum", "sgd"])
def test_local_kvstore_matches(optimizer):
    (jout, jkv), (tout, tkv) = (_kv_run(jmx, optimizer),
                                _kv_run(tmx, optimizer))
    for jrow, trow in zip(jout, tout):
        for j, t in zip(jrow, trow):
            np.testing.assert_allclose(
                t, j, rtol=0, atol=1e-6 * np.abs(j).max() if optimizer else 0)
    assert (tkv.rank, tkv.num_workers) == (jkv.rank, jkv.num_workers) == \
        (0, 1)
    tkv.barrier()


def test_kvstore_errors():
    kv = tmx.kv.create("device")
    kv.init(0, tmx.nd.zeros((2,), tmx.cpu()))
    with pytest.raises(MXNetError):
        kv.init(0, tmx.nd.zeros((2,), tmx.cpu()))
    with pytest.raises(MXNetError):
        kv.pull(1, out=tmx.nd.zeros((2,), tmx.cpu()))
    with pytest.raises(MXNetError):
        kv.pull(0)
    for bad in ("dist_sync", "dist_async", "dist"):
        with pytest.raises(MXNetError, match="queue 1, item 3"):
            tmx.kv.create(bad)
    with pytest.raises(MXNetError):
        tmx.kv.create("nosuch")
    with pytest.raises(TypeError):
        tmx.kv.create(3)


def _fit_params(monkeypatch, depth):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", depth)
    tmx.random.seed(0)
    rng = np.random.RandomState(0)
    X = rng.randn(96, 8).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    d = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(
        data=tmx.sym.FullyConnected(data=d, num_hidden=2, name="fc"),
        name="softmax")
    model = tmx.model.FeedForward(net, ctx=[tmx.cpu(0), tmx.cpu(1)],
                                  num_epoch=2, learning_rate=0.1,
                                  initializer=tmx.init.Xavier())
    model.fit(tmx.io.NDArrayIter(X, y, batch_size=16, shuffle=True))
    return ({k: v.asnumpy() for k, v in model.arg_params.items()},
            model.stats["io.device_batches"])


def test_batches_copied_in_step_whatever_device_prefetch_says(monkeypatch):
    """Pin 0 copies each batch in the step; pin 2 stages them ahead
    through `io.DevicePrefetchIter` (2 epochs of 6 staged batches bound in
    place): the same numbers either way."""
    a, staged_a = _fit_params(monkeypatch, "0")
    b, staged_b = _fit_params(monkeypatch, "2")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert (staged_a, staged_b) == (0, 12)


def test_callbacks(tmp_path, caplog):
    metric = tmx.metric.Accuracy()
    label, pred = _preds()
    metric.update([tmx.nd.array(label, ctx=tmx.cpu())],
                  [tmx.nd.array(pred, ctx=tmx.cpu())])
    speed = tmx.callback.Speedometer(batch_size=4, frequent=2)
    with caplog.at_level(logging.INFO):
        for n in range(5):
            speed(tmx.callback.BatchEndParam(0, n, metric))
        tmx.callback.log_train_metric(2)(
            tmx.callback.BatchEndParam(1, 4, metric))
        tmx.callback.ProgressBar(10)(tmx.callback.BatchEndParam(0, 5, None))
    assert speed.last_speed is not None and speed.last_speed > 0
    assert any("Train-accuracy" in r.getMessage() for r in caplog.records)
    net = tmx.sym.SoftmaxOutput(data=tmx.sym.Variable("data"), name="sm")
    cb = tmx.callback.do_checkpoint(str(tmp_path / "m"), period=2)
    arg = {"w": tmx.nd.ones((2,), tmx.cpu())}
    cb(0, net, arg, {})
    assert not (tmp_path / "m-0001.params").exists()
    cb(1, net, arg, {})
    assert (tmp_path / "m-0002.params").exists()
    back = jmx.nd.load(str(tmp_path / "m-0002.params"))
    np.testing.assert_array_equal(back["arg:w"].asnumpy(), np.ones(2))
