"""Monitor: statistics of every internal entry, for debugging.

A port of `mxnet_tpu/monitor.py` (the reference's `python/mxnet/monitor.py`):
installed on executors, it collects a statistic of every entry matching
``pattern`` on one batch in ``interval`` and prints them.

* ``mode='eager'`` (the reference's): the executor hands each entry's
  NDArray to ``stat_func`` (default |x|/size through ``asnumpy``), one
  host fetch an entry.
* ``mode='ingraph'``: the statistic (``stat_func`` here maps a tensor to
  a 0-d tensor; default |x|.sum()/size in float32) is computed on the
  device inside the monitored forward's own walk, and `toc` brings the
  whole bundle back in one transfer a device.  Forwards outside the
  interval compute none.
"""
from __future__ import annotations

import logging
import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Monitor"]


def _asum_host(x):
    """|x|/size(x) on the host, the reference's default statistic."""
    a = x.asnumpy()
    return float(np.abs(a).sum() / a.size)


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 mode="eager"):
        if mode not in ("eager", "ingraph"):
            raise MXNetError("Monitor mode must be 'eager' or 'ingraph', "
                             "got %r" % (mode,))
        self.mode = mode
        self._ingraph_stat = stat_func if mode == "ingraph" else None
        self.stat_func = None if mode == "ingraph" else \
            (stat_func or _asum_host)
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, value):
        """The executors' callback: queue ``name``'s statistic while this
        batch is monitored (a device tensor in ``ingraph`` mode)."""
        if not self.activated or not self.re_prog.match(name):
            return
        if self.mode == "eager":
            value = self.stat_func(value)
        self.queue.append((self.step, name, value))

    def install(self, exe):
        """Attach to an executor (`monitor.py` install)."""
        if self.mode == "ingraph":
            exe.set_monitor_callback(self.stat_helper, mode="ingraph",
                                     stat_fn=self._ingraph_stat,
                                     active_fn=lambda: self.activated)
        else:
            exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if the interval hits."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the batch: [(step, name, statistic)]."""
        if not self.activated:
            return []
        self.activated = False
        res = list(self.queue)
        self.queue = []
        if self.mode == "ingraph" and res:
            res = [(step, name, v) for (step, name, _), v in
                   zip(res, _fetch([v for _, _, v in res]))]
        if self.sort:
            res.sort(key=lambda x: x[1])
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
        return res


def _fetch(values):
    """0-d device tensors as floats: one stack and one transfer a
    device."""
    out = [None] * len(values)
    by_device = {}
    for i, v in enumerate(values):
        by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        host = torch.stack([values[i] for i in idx]).cpu().tolist()
        for i, x in zip(idx, host):
            out[i] = float(x)
    return out
