"""BaseModule: the generic training loops (`mxnet_tpu/module/base_module.py`,
the reference's `python/mxnet/module/base_module.py`).

`fit` keeps the JAX package's order of operations: the auto-checkpoint
is loaded before `init_params` (its parameters go in as the initial
values, so a store that updates on the kvstore starts from them), the
epoch's random state is taken before the iterator's reset (a resume
replays the epoch's shuffle from it), replayed batches are skipped
without staging, and the prefetch workers are closed in ``finally``.  A
module with the hooks `Module` has stages its input on the devices
(``MXNET_DEVICE_PREFETCH``) and accumulates the metric there
(``MXNET_METRIC_INTERVAL`` > 1); others update the metric on the host.
After each update the nonfinite lr backoff is polled
(``MXNET_NONFINITE_BACKOFF``, with the ``MXNET_NONFINITE_GUARD`` skip),
and each batch ends with a telemetry step record once a sink is
attached.  ``stats`` reads back what this module's fits added to
``train.host_blocking_fetches``, ``io.device_batches``,
``train.auto_checkpoints`` and ``train.resumes`` in `telemetry`.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import metric as metric_mod
from .. import telemetry
from ..base import MXNetError
from ..callback import BatchEndParam
from ..model import STATS, _call, _FitRun, save_checkpoint

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._stats = dict.fromkeys(STATS, 0)

    @property
    def stats(self):
        """What this module's fits added to the `model.STATS` counters of
        `telemetry` (a copy)."""
        return dict(self._stats)

    # -- the interface of a module -------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, *args, **kwargs):
        raise NotImplementedError()

    def init_params(self, *args, **kwargs):
        raise NotImplementedError()

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    @property
    def symbol(self):
        return self._symbol

    # -- the generic loops (base_module.py:237 ff.) --------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """The metric over ``eval_data`` as [(name, value)]."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be bound and initialized")
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                _call(batch_end_callback,
                      BatchEndParam(epoch=epoch, nbatch=nbatch,
                                    eval_metric=eval_metric))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` as numpy, padding dropped."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("module must be bound and initialized")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad].asnumpy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise MXNetError("output count changed across batches")
            merged = [np.concatenate([out[i] for out in output_list])
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=None,
            eval_batch_end_callback=None, initializer=None,
            arg_params=None, aux_params=None, allow_missing=False,
            force_rebind=False, force_init=False, begin_epoch=0,
            num_epoch=None, monitor=None, auto_checkpoint=None,
            checkpoint_every=0, resume=None):
        """Train (`base_module.py:237`).  ``auto_checkpoint=prefix`` with
        ``checkpoint_every=n`` writes ``prefix-auto.ckpt`` every n batches
        and at each epoch's end; ``resume="auto"`` goes on from it
        exactly: parameters, optimizer state and counts, the cursor, the
        random state."""
        from .. import initializer as init_mod
        from .. import random as random_mod

        if num_epoch is None:
            raise MXNetError("num_epoch must be specified")
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        optimizer_params = optimizer_params or {"learning_rate": 0.01}
        run = _FitRun(auto_checkpoint, checkpoint_every, resume, self._stats,
                      self.logger)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        # the checkpoint's parameters go in as the initial values, before
        # init_optimizer: a store that updates on the kvstore takes them
        self.init_params(
            initializer=initializer,
            arg_params=run.state["arg"] if run.state else arg_params,
            aux_params=run.state["aux"] if run.state else aux_params,
            allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        train_data = run.stage(
            train_data, eval_metric,
            plan=getattr(self, "_prefetch_plan", None),
            install=getattr(self, "_metric_stats_install", None),
            fetch=getattr(self, "_metric_stats_fetch", None),
            uninstall=getattr(self, "_metric_stats_uninstall", None))

        kv = getattr(self, "_kvstore", None)
        # the optimizer state to checkpoint: the module's updater, or the
        # one its store installed
        run.restore(getattr(self, "_updater", None)
                    or getattr(kv, "_updater", None),
                    self._state_ctx() if hasattr(self, "_state_ctx")
                    else None, kv, getattr(self, "_optimizer", None),
                    getattr(self, "_update_on_kvstore", False))
        if run.state is not None:
            begin_epoch = run.state["epoch"]
        # with checkpoints on, the first epoch's order is reset()'s, which
        # a resume can replay
        epoch_rng = run.begin(reset=bool(run.prefix), skip=run.resume_batch)

        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                skip = run.resume_batch if epoch == begin_epoch else 0
                for nbatch, data_batch in enumerate(train_data):
                    if nbatch < skip:
                        continue
                    if monitor is not None:
                        monitor.tic()
                    self.forward_backward(data_batch)
                    self.update()
                    run.after_update()
                    # the statistics rode the step; one blocking fetch an
                    # interval
                    run.batch_metric(nbatch + 1, lambda: self.update_metric(
                        eval_metric, data_batch.label))
                    if monitor is not None:
                        monitor.toc_print()
                    if batch_end_callback is not None:
                        _call(batch_end_callback,
                              BatchEndParam(epoch=epoch, nbatch=nbatch,
                                            eval_metric=eval_metric))
                    # one telemetry record a step, once a sink is attached
                    telemetry.step_end(extra={"epoch": epoch,
                                              "nbatch": nbatch})
                    if run.due(nbatch + 1):
                        arg_p, aux_p = self.get_params()
                        run.save(arg_p, aux_p, epoch, nbatch + 1, epoch_rng)
                run.flush_metric()
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)
                arg_p, aux_p = self.get_params()
                self.set_params(arg_p, aux_p)
                if epoch_end_callback is not None:
                    _call(epoch_end_callback, epoch, self.symbol, arg_p,
                          aux_p)
                if eval_data:
                    res = self.score(
                        eval_data, eval_metric,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                epoch_rng = random_mod.get_state()
                train_data.reset()
                if run.writer:
                    # a crash between epochs resumes at (epoch + 1, 0)
                    run.save(arg_p, aux_p, epoch + 1, 0, epoch_rng)
        finally:
            run.close()

    def set_params(self, arg_params, aux_params):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=False,
                         force_init=True)

    def install_monitor(self, monitor):
        raise NotImplementedError()

    def save_checkpoint(self, prefix, epoch):
        """``prefix-symbol.json`` and ``prefix-%04d.params`` of the current
        parameters (the JAX package's bytes)."""
        arg_p, aux_p = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_p, aux_p)
