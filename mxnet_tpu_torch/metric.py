"""Evaluation metrics.

The port's copy of `mxnet_tpu/metric.py` (the reference's
`python/mxnet/metric.py:127-347`), in numpy on the host: every metric
reads its labels and predictions through ``asnumpy``, once a batch.  The
JAX package's in-graph accumulation (``MXNET_METRIC_INTERVAL`` > 1, the
``device_stat`` methods) is not ported: `metric_interval` raises for it.
"""
from __future__ import annotations

import os

import numpy

from .base import MXNetError
from .ndarray import NDArray


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def metric_interval():
    """MXNET_METRIC_INTERVAL: 1 (the default) updates the metric on the
    host after every batch.  The JAX package's in-graph accumulation of
    N > 1 batches is not ported, so N > 1 raises."""
    raw = os.environ.get("MXNET_METRIC_INTERVAL", "1")
    try:
        n = int(raw or 1)
    except ValueError:
        raise MXNetError(
            "MXNET_METRIC_INTERVAL must be an integer step count, got %r"
            % raw)
    if n > 1:
        raise MXNetError(
            "MXNET_METRIC_INTERVAL=%d (metric statistics accumulated on "
            "the device) is not ported yet (ROADMAP queue 3); unset it or "
            "set 1" % n)
    return n


class EvalMetric:
    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def update(self, labels, preds):
        raise NotImplementedError()

    def get(self):
        if self.num is None:
            value = self.sum_metric / self.num_inst if self.num_inst else float("nan")
            return (self.name, value)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [
            s / n if n else float("nan")
            for s, n in zip(self.sum_metric, self.num_inst)
        ]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            return [(name, value)]
        return list(zip(name, value))


class Accuracy(EvalMetric):
    """Classification accuracy (`metric.py:127`)."""

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _np(label).astype(numpy.int32)
            pred = _np(pred)
            pred_label = numpy.argmax(pred, axis=1) if pred.ndim > 1 else pred.astype(numpy.int32)
            self.sum_metric += float((pred_label.flat == label.flat).sum())
            self.num_inst += len(pred_label.flat)


class TopKAccuracy(EvalMetric):
    """Top-k accuracy (`metric.py` TopKAccuracy)."""

    def __init__(self, top_k=1):
        super().__init__("top_k_accuracy_%d" % top_k)
        self.top_k = top_k
        if top_k <= 1:
            raise MXNetError("use Accuracy for top_k=1")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _np(label).astype(numpy.int32)
            pred = _np(pred)
            # a stable sort, as the JAX package's: tied predictions
            # break ties the same way in both
            top = numpy.argsort(pred, axis=1, kind="stable")[:, -self.top_k:]
            for i in range(len(label)):
                self.sum_metric += float(label[i] in top[i])
            self.num_inst += len(label)


class F1(EvalMetric):
    """Binary F1 (`metric.py` F1)."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _np(label).astype(numpy.int32).flatten()
            pred = numpy.argmax(_np(pred), axis=1)
            tp = float(((pred == 1) & (label == 1)).sum())
            fp = float(((pred == 1) & (label == 0)).sum())
            fn = float(((pred == 0) & (label == 1)).sum())
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = (
                2 * precision * recall / (precision + recall)
                if precision + recall > 0
                else 0.0
            )
            self.sum_metric += f1
            self.num_inst += 1


class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(numpy.abs(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1


class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2).mean())
            self.num_inst += 1


class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(
                numpy.sqrt(((label.reshape(pred.shape) - pred) ** 2).mean())
            )
            self.num_inst += 1


class CrossEntropy(EvalMetric):
    """Per-sample NLL of the labelled class (`metric.py` CrossEntropy)."""

    def __init__(self):
        super().__init__("cross-entropy")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _np(label).astype(numpy.int32).flatten()
            pred = _np(pred)
            prob = pred[numpy.arange(label.shape[0]), label]
            self.sum_metric += float((-numpy.log(numpy.maximum(prob, 1e-12))).sum())
            self.num_inst += label.shape[0]


class Torch(EvalMetric):
    """Average of criterion outputs (`metric.py:337` Torch): torch-bridge
    criterions (TorchCriterion) emit per-batch loss values; this metric
    tracks their running mean, ignoring labels."""

    def __init__(self):
        super().__init__("torch")

    def update(self, labels, preds):
        del labels  # criterion outputs already consumed the labels
        for pred in preds:
            self.sum_metric += float(_np(pred).mean())
        self.num_inst += 1


class CustomMetric(EvalMetric):
    """Wrap a feval(label, pred) function (`metric.py` CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = getattr(feval, "__name__", "custom")
            if name.startswith("<"):
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs and len(labels) != len(preds):
            raise MXNetError("labels/preds length mismatch")
        for label, pred in zip(labels, preds):
            v = self._feval(_np(label), _np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    """Several metrics at once (`metric.py` CompositeEvalMetric)."""

    def __init__(self, metrics=None):
        super().__init__("composite")
        self.metrics = [create(m) if isinstance(m, str) else m for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str) else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, results = [], []
        for m in self.metrics:
            n, r = m.get()
            names.append(n)
            results.append(r)
        return names, results


def np_metric(f_or_name=None, name=None, allow_extra_outputs=False):
    """CustomMetric factory (`metric.py` np): reference usage is direct —
    ``mx.metric.np(CRPS)`` (`example/kaggle-ndsb2/Train.py`) — and the
    decorator form ``@mx.metric.np(name=...)`` also works."""
    if callable(f_or_name):
        return CustomMetric(f_or_name, name, allow_extra_outputs)

    def wrapper(f):
        return CustomMetric(f, f_or_name or name, allow_extra_outputs)

    return wrapper


np = np_metric  # reference exposes the decorator as `mx.metric.np`


def create(metric):
    """Create by name or callable (`metric.py` create)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    metrics = {
        "acc": Accuracy,
        "accuracy": Accuracy,
        "f1": F1,
        "mae": MAE,
        "mse": MSE,
        "rmse": RMSE,
        "ce": CrossEntropy,
        "torch": Torch,
    }
    m = metric.lower()
    if m not in metrics:
        raise MXNetError("unknown metric %r" % metric)
    return metrics[m]()
