"""Evaluation metrics.

The port's copy of `mxnet_tpu/metric.py` (the reference's
`python/mxnet/metric.py:127-347`).  ``update`` computes in numpy on the
host, reading labels and predictions through ``asnumpy`` once a batch.

Accumulation on the device (``MXNET_METRIC_INTERVAL`` = N > 1): a metric
whose batch contribution is a pair of additive numbers (``device_stat``:
Accuracy, TopKAccuracy, MAE, MSE, RMSE, CrossEntropy, and a
CompositeEvalMetric of them) computes it from the step's own output
tensors on their device (`Executor.set_step_stat_fn`), into a carry that
the training loops fetch once every N steps and at an epoch's end
(``apply_device_stats``), in place of one ``update`` a batch.  The
arithmetic is ``update``'s, in float32 on the device.
"""
from __future__ import annotations

import os

import numpy
import torch

from .base import MXNetError
from .ndarray import NDArray


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def metric_interval():
    """MXNET_METRIC_INTERVAL: 1 (the default) updates the metric on the
    host after every batch; N > 1 accumulates the metric's statistics on
    the device and fetches them once every N steps."""
    raw = os.environ.get("MXNET_METRIC_INTERVAL", "1")
    try:
        return int(raw or 1)
    except ValueError:
        raise MXNetError(
            "MXNET_METRIC_INTERVAL must be an integer step count, got %r"
            % raw)


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

    # -- accumulation on the device ----------------------------------------
    supports_device = False

    def device_stats_size(self):
        """The length of the metric's device statistics (0: none; the
        loops then update it on the host every batch)."""
        return 2 if self.supports_device and self.num is None else 0

    def device_stat(self, label, pred):
        """One (label, pred) pair of tensors' contribution: (sum_metric
        delta, num_inst delta), ``update``'s arithmetic on the device."""
        raise NotImplementedError()

    def device_batch_stats(self, labels, preds):
        """A batch's statistics as one float32 tensor on the predictions'
        device."""
        s_total, n_total = 0.0, 0.0
        for label, pred in zip(labels, preds):
            s, n = self.device_stat(label, pred)
            s_total = s_total + s
            n_total = n_total + n
        dev = preds[0].device
        return torch.stack([torch.as_tensor(s_total, dtype=torch.float32,
                                            device=dev).reshape(()),
                            torch.full((), float(n_total),
                                       dtype=torch.float32, device=dev)])

    def apply_device_stats(self, stats):
        """Fold fetched statistics (numpy) into the host accumulators."""
        self.sum_metric += float(stats[0])
        self.num_inst += int(round(float(stats[1])))

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

    supports_device = True

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _np(label).astype(numpy.int32)
            pred = _np(pred)
            pred_label = numpy.argmax(pred, axis=1) if pred.ndim > 1 else pred.astype(numpy.int32)
            self.sum_metric += float((pred_label.flat == label.flat).sum())
            self.num_inst += len(pred_label.flat)

    def device_stat(self, label, pred):
        lab = label.reshape(-1).to(torch.int32)
        pl = pred.argmax(dim=1) if pred.dim() > 1 else pred.to(torch.int32)
        pl = pl.reshape(-1)
        return (pl == lab).sum().float(), float(pl.numel())


class TopKAccuracy(EvalMetric):
    """Top-k accuracy (`metric.py` TopKAccuracy)."""

    supports_device = True

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

    def device_stat(self, label, pred):
        lab = label.reshape(-1).to(torch.int64)
        top = torch.argsort(pred, dim=1, stable=True)[:, -self.top_k:]
        hits = (top == lab[:, None]).any(dim=1).sum()
        return hits.float(), float(lab.numel())


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
    supports_device = True

    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(numpy.abs(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1

    def device_stat(self, label, pred):
        return (label.reshape(pred.shape) - pred).abs().mean(), 1.0


class MSE(EvalMetric):
    supports_device = True

    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2).mean())
            self.num_inst += 1

    def device_stat(self, label, pred):
        return ((label.reshape(pred.shape) - pred) ** 2).mean(), 1.0


class RMSE(EvalMetric):
    supports_device = True

    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(
                numpy.sqrt(((label.reshape(pred.shape) - pred) ** 2).mean())
            )
            self.num_inst += 1

    def device_stat(self, label, pred):
        # each batch adds its own RMSE, as update does
        return ((label.reshape(pred.shape) - pred) ** 2).mean().sqrt(), 1.0


class CrossEntropy(EvalMetric):
    """Per-sample NLL of the labelled class (`metric.py` CrossEntropy)."""

    supports_device = True

    def __init__(self):
        super().__init__("cross-entropy")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _np(label).astype(numpy.int32).flatten()
            pred = _np(pred)
            prob = pred[numpy.arange(label.shape[0]), label]
            self.sum_metric += float((-numpy.log(numpy.maximum(prob, 1e-12))).sum())
            self.num_inst += label.shape[0]

    def device_stat(self, label, pred):
        lab = label.reshape(-1).to(torch.int64)
        prob = pred[torch.arange(lab.shape[0], device=pred.device), lab]
        return (-torch.log(torch.clamp(prob, min=1e-12))).sum(), \
            float(lab.shape[0])


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

    def device_stats_size(self):
        sizes = [m.device_stats_size() for m in self.metrics]
        if not sizes or not all(sizes):
            return 0  # one host-only child keeps the whole on the host
        return sum(sizes)

    def device_batch_stats(self, labels, preds):
        return torch.cat([m.device_batch_stats(labels, preds)
                          for m in self.metrics])

    def apply_device_stats(self, stats):
        off = 0
        for m in self.metrics:
            k = m.device_stats_size()
            m.apply_device_stats(stats[off:off + k])
            off += k

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
