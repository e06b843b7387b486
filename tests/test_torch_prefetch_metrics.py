"""The port's device-staged input, metric accumulated on the device and
in-graph monitor, on the CPU.

* ``MXNET_DEVICE_PREFETCH`` 0/2 x ``MXNET_METRIC_INTERVAL`` 1/4 give the
  same parameters bit for bit and the same final metric to 1e-6, for
  `Module.fit` on one CPU context and two and for `FeedForward.fit`; the
  staged batches are bound in place (``io.device_batches``).
* One blocking fetch per interval (``train.host_blocking_fetches``).
* Each metric's device statistics (`device_batch_stats`, folded in by
  `apply_device_stats`) give its host `update`'s value, the JAX
  package's host value too (float32 sums in another order: 1e-6).
* `monitor.Monitor` in ``ingraph`` mode reports the ``eager`` mode's
  statistics to 1e-6, on the monitored batches only, under the JAX
  package's entry names.
* `PrefetchingIter`/`DevicePrefetchIter` close idempotently and revive,
  pass a worker's exception to `next()`, and no worker thread outlives a
  `fit` that raises; `ResizeIter` cuts and stretches an epoch.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as io_mod
from mxnet_tpu_torch.base import MXNetError
import torch
from test_torch_kernels import _one_thread  # noqa: F401


PK = {"jax": jmx, "torch": tmx}


def _data(n=128, dim=8, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, dim).astype(np.float32)
    return X, (np.arange(n) % 4).astype(np.float32)


def _mlp(mx, layers=2):
    net = mx.sym.Variable("data")
    for i in range(layers):
        net = mx.sym.FullyConnected(data=net, name="fc%d" % i, num_hidden=16)
        net = mx.sym.Activation(data=net, name="act%d" % i, act_type="relu")
    net = mx.sym.FullyConnected(data=net, name="out", num_hidden=4)
    return mx.sym.SoftmaxOutput(data=net, name="softmax")


def _fit(monkeypatch, prefetch, interval, devices=1, metric="acc",
         feedforward=False):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", str(prefetch))
    monkeypatch.setenv("MXNET_METRIC_INTERVAL", str(interval))
    tmx.random.seed(5)
    X, y = _data()
    it = tmx.io.NDArrayIter(X, y, batch_size=16, shuffle=True)
    ctx = [tmx.cpu(i) for i in range(devices)]
    seen = {}

    def grab(p):
        seen["metric"] = p.eval_metric

    if feedforward:
        model = tmx.model.FeedForward(_mlp(tmx), ctx=ctx, num_epoch=2,
                                      learning_rate=0.1, momentum=0.9)
        model.fit(it, eval_metric=metric, batch_end_callback=grab)
        params = {k: v.asnumpy() for k, v in model.arg_params.items()}
        return params, seen["metric"].get(), model.stats
    mod = tmx.mod.Module(_mlp(tmx), context=ctx)
    mod.fit(it, num_epoch=2, eval_metric=metric, batch_end_callback=grab,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return params, seen["metric"].get(), mod.stats


@pytest.mark.parametrize("prefetch,interval", [(2, 1), (0, 4), (2, 4)])
@pytest.mark.parametrize("how", ["module", "module2", "feedforward"])
def test_prefetch_and_interval_give_the_same_run(monkeypatch, how, prefetch,
                                                 interval):
    kw = {"devices": 2 if how == "module2" else 1,
          "feedforward": how == "feedforward", "metric": "ce"}
    base, base_metric, _ = _fit(monkeypatch, 0, 1, **kw)
    params, metric, stats = _fit(monkeypatch, prefetch, interval, **kw)
    for k in base:
        np.testing.assert_array_equal(params[k], base[k], err_msg=k)
    assert metric[0] == base_metric[0]
    np.testing.assert_allclose(metric[1], base_metric[1], rtol=1e-6)
    # staged batches bound in place: 8 a epoch
    assert stats["io.device_batches"] == (16 if prefetch else 0)


def test_one_blocking_fetch_per_interval(monkeypatch):
    """2 epochs of 8 batches: interval 4 fetches at 4 and 8 (the epoch's
    end finds nothing left); interval 3 at 3, 6 and the epoch's end;
    interval 1 after every batch."""
    for interval, fetches in ((4, 4), (3, 6), (1, 16)):
        _, _, stats = _fit(monkeypatch, 2, interval)
        assert stats["train.host_blocking_fetches"] == fetches, interval


def _metric_cases(mx):
    return [mx.metric.Accuracy(), mx.metric.TopKAccuracy(top_k=2),
            mx.metric.CrossEntropy(), mx.metric.MSE(), mx.metric.MAE(),
            mx.metric.RMSE(), mx.metric.CompositeEvalMetric(["acc", "ce"])]


@pytest.mark.parametrize("i", range(7))
def test_device_stats_match_the_host_update(i):
    import torch

    rng = np.random.RandomState(0)
    pred = rng.rand(32, 5).astype(np.float32)
    pred /= pred.sum(axis=1, keepdims=True)
    label = rng.randint(0, 5, 32).astype(np.float32)
    dev = _metric_cases(tmx)[i]
    if isinstance(dev, (tmx.metric.MSE, tmx.metric.MAE, tmx.metric.RMSE)):
        label, pred = label[:, None] / 5.0, pred[:, :1]
    assert dev.device_stats_size() == (4 if i == 6 else 2)
    stats = dev.device_batch_stats([torch.from_numpy(label)],
                                   [torch.from_numpy(pred)])
    assert stats.dtype == torch.float32
    dev.apply_device_stats(stats.numpy())
    for which in ("torch", "jax"):
        mx = PK[which]
        host = _metric_cases(mx)[i]
        host.update([mx.nd.array(label, ctx=mx.cpu())],
                    [mx.nd.array(pred, ctx=mx.cpu())])
        np.testing.assert_allclose(np.asarray(dev.get()[1], np.float64),
                                   np.asarray(host.get()[1], np.float64),
                                   rtol=1e-6, err_msg=which)
    assert tmx.metric.F1().device_stats_size() == 0
    assert tmx.metric.CompositeEvalMetric(
        ["acc", "f1"]).device_stats_size() == 0


def _monitor_params():
    """The one-layer MLP's parameters, drawn once in numpy for both
    packages."""
    rng = np.random.RandomState(3)
    shapes = {"fc0_weight": (16, 8), "fc0_bias": (16,),
              "out_weight": (4, 16), "out_bias": (4,)}
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in shapes.items()}


def _monitored(mx, mode):
    X, y = _data(64)
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(_mlp(mx, layers=1), context=mx.cpu())
    mon = mx.monitor.Monitor(2, pattern=".*", mode=mode)
    seen = []
    mon.toc_print = lambda: seen.append(mon.toc())
    params = {n: mx.nd.array(v, ctx=mx.cpu())
              for n, v in _monitor_params().items()}
    mod.fit(it, num_epoch=1, monitor=mon, arg_params=params,
            optimizer_params={"learning_rate": 0.1})
    return seen


def test_ingraph_monitor_matches_eager():
    """Both of the port's modes report the JAX `Monitor`'s statistics,
    batch by batch, from the same parameters (float32 in another order:
    1e-6)."""
    jax_eager = _monitored(jmx, "eager")
    eager, ingraph = _monitored(tmx, "eager"), _monitored(tmx, "ingraph")
    # batches 0 and 2 of 4 are monitored
    assert [bool(r) for r in jax_eager] == [bool(r) for r in eager] == \
        [bool(r) for r in ingraph] == [True, False, True, False]
    for want, e, g in zip(jax_eager, eager, ingraph):
        assert [(s, n) for s, n, _ in e] == [(s, n) for s, n, _ in g] == \
            [(s, n) for s, n, _ in want]
        ref = [float(v) for _, _, v in want]
        np.testing.assert_allclose([v for _, _, v in e], ref, rtol=1e-6)
        np.testing.assert_allclose([v for _, _, v in g], ref, rtol=1e-6)
        assert all(isinstance(v, float) for _, _, v in g)


def test_monitor_mode_is_checked():
    with pytest.raises(MXNetError, match="ingraph"):
        tmx.monitor.Monitor(1, mode="lazy")


def test_prefetching_iter_close_idempotent_and_revives():
    X = np.arange(60).reshape(60, 1).astype(np.float32)
    base = tmx.io.NDArrayIter(X, np.zeros(60), batch_size=10)
    it = io_mod.PrefetchingIter(base)
    assert next(it) is not None
    thread = it._thread
    assert thread is not None and thread.is_alive()
    it.close()
    it.close()
    assert not thread.is_alive()
    it.reset()
    assert len(list(it)) == 6
    it.close()


class _Boom(Exception):
    pass


class _FailingIter(tmx.io.DataIter):
    """Two batches of ``base``, then an exception."""

    def __init__(self, base):
        super().__init__()
        self.base = base
        self.batch_size = base.batch_size
        self.n = 0

    def next(self):
        self.n += 1
        if self.n > 2:
            raise _Boom("decode failed")
        return self.base.next()

    def reset(self):
        self.n = 0
        self.base.reset()


def test_device_prefetch_iter_close_and_errors():
    X = np.arange(40).reshape(40, 1).astype(np.float32)
    base = tmx.io.NDArrayIter(X, np.zeros(40), batch_size=10)
    plan = io_mod.PrefetchPlan([slice(0, 5), slice(5, 10)],
                               [tmx.cpu(0), tmx.cpu(1)])
    it = io_mod.DevicePrefetchIter(base, plan=plan, depth=2)
    got = list(it)
    assert len(got) == 4
    np.testing.assert_allclose(got[0].data[0].asnumpy(), X[:10])
    parts = got[1].device_parts
    assert parts["key"] == plan.key and parts["events"] == [None, None]
    np.testing.assert_array_equal(parts["data"][0][1].asnumpy(), X[15:20])
    assert parts["data"][0][1].context == tmx.cpu(1)
    it.reset()
    assert len(list(it)) == 4
    it.close()
    it.close()
    assert not any(t.is_alive() for t in it._threads)
    with pytest.raises(MXNetError, match="depth"):
        io_mod.DevicePrefetchIter(base, depth=0)
    for wrapper in (io_mod.DevicePrefetchIter, io_mod.PrefetchingIter):
        base.reset()
        it2 = wrapper(_FailingIter(base))
        with pytest.raises(_Boom):
            list(it2)
        io_mod.close_iter(it2)


def test_no_prefetch_worker_outlives_a_fit_that_raises(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "2")

    def boom(p):
        if p.nbatch == 2:
            raise _Boom()

    X, y = _data()
    mod = tmx.mod.Module(_mlp(tmx, 1), context=tmx.cpu())
    with pytest.raises(_Boom):
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=16), num_epoch=1,
                batch_end_callback=boom,
                optimizer_params={"learning_rate": 0.1})
    time.sleep(0.1)
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("mx-device-prefetch")]
    assert not leaked, leaked


def test_a_staged_batch_of_another_shape_raises():
    X, y = _data(40)
    mod = tmx.mod.Module(_mlp(tmx, 1), context=tmx.cpu())
    mod.bind([("data", (16, 8))], [("softmax_label", (16,))])
    plan = mod._prefetch_plan()
    it = io_mod.DevicePrefetchIter(
        tmx.io.NDArrayIter(X, y, batch_size=8), plan=plan, depth=1)
    with pytest.raises(MXNetError, match="ragged"):
        mod.forward(next(it), is_train=False)
    it.close()


def test_resize_iter():
    X = np.arange(30).reshape(30, 1).astype(np.float32)
    for which in ("jax", "torch"):
        mx = PK[which]
        it = mx.io.ResizeIter(mx.io.NDArrayIter(X, np.zeros(30),
                                                batch_size=10), 5)
        first = [b.data[0].asnumpy()[0, 0] for b in it]
        it.reset()
        assert [b.data[0].asnumpy()[0, 0] for b in it] == first == \
            [0, 10, 20, 0, 10]
