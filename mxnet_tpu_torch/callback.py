"""Training callbacks.

The port's copy of `mxnet_tpu/callback.py` (the reference's
`python/mxnet/callback.py`): `BatchEndParam`, `do_checkpoint`,
`log_train_metric`, `Speedometer` (samples/s, the throughput line of the
reference's examples, in its log format) and `ProgressBar`.  The JAX
package's telemetry gauges are left out.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["BatchEndParam", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar"]


class BatchEndParam:
    """Named bundle passed to batch callbacks (reference uses a namedtuple)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def do_checkpoint(prefix, period=1):
    """Epoch callback: checkpoint every `period` epochs (`callback.py`
    do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint

            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch callback: log training metric every `period` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log samples/sec every `frequent` batches.

    The throughput metric of every reference example and nightly.  The LOG
    LINE FORMAT is a compatibility contract — `tools/parse_log.py` and the
    reference's nightly `check_val` grep it — but the bookkeeping is our
    own: one window anchor (the wall-clock time and batch number where the
    current measurement window opened), re-anchored whenever the batch
    counter runs backwards (new epoch).
    """

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._window = None  # (anchor_time, anchor_batch) of current window
        self.last_speed = None

    def __call__(self, param):
        nbatch = param.nbatch
        if self._window is None or nbatch < self._window[1]:
            self._window = (time.time(), nbatch)  # epoch rollover: re-anchor
            return
        if nbatch % self.frequent != 0:
            return
        now = time.time()
        elapsed = now - self._window[0]
        done = nbatch - self._window[1]
        self._window = (now, nbatch)
        if elapsed <= 0 or done <= 0:
            return
        self.last_speed = done * self.batch_size / elapsed
        metrics = (param.eval_metric.get_name_value()
                   if param.eval_metric is not None else [])
        if not metrics:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, nbatch, self.last_speed)
        for name, value in metrics:
            logging.info(
                "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
                param.epoch, nbatch, self.last_speed, name, value)


class ProgressBar:
    """Text progress bar per epoch (`callback.py` ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
