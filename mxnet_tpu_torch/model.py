"""FeedForward and the data-parallel training loop.

A port of `mxnet_tpu/model.py` (the reference's `python/mxnet/model.py`):
`_create_kvstore`, `_train_multi_device` (the loop: copy the batch to
each device, forward, backward, update through the KVStore or each
device's updater, host metric), the checkpoint helpers
(``prefix-symbol.json`` + ``prefix-%04d.params`` with ``arg:``/``aux:``
names, the JAX package's bytes) and `FeedForward` (``fit``, ``predict``,
``score``, ``save``, ``load``, ``create``).

``ctx=None`` trains on ``[current_context()]``, the card.  The parameter
dicts (``arg_params``, ``aux_params``) are host copies on the CPU, as in
the reference, initialized there and copied to every device; the
devices' mean comes back into them after each epoch.  The optimizer's
update is `optimizer.get_fused_updater`'s one `update_multi` a device a
step (``MXNET_FUSED_UPDATE=0``: one `update` a parameter).

Refused with an error, never accepted and ignored: ``auto_checkpoint``,
``checkpoint_every``, ``resume`` and their ``MXNET_AUTO_CHECKPOINT``,
``MXNET_AUTO_CHECKPOINT_EVERY`` and ``MXNET_AUTO_RESUME`` pins, and
``MXNET_NONFINITE_BACKOFF``: they come with the fault-tolerance slice.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

from . import initializer as init_mod
from . import kvstore as kvs_mod
from . import metric as metric_mod
from . import ndarray as nd
from .base import MXNetError
from .callback import BatchEndParam
from .context import Context, cpu, current_context
from .executor_manager import DataParallelExecutorManager, _check_arguments
from .io import DataIter, NDArrayIter
from .ndarray import NDArray, zeros
from .optimizer import Optimizer, get_fused_updater
from .symbol import Symbol

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint"]


def _create_kvstore(kvstore, num_device, arg_params):
    """The KVStore and whether it runs the update (`model.py:36-77`)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs_mod.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs_mod.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(p.shape))
                               for p in arg_params.values()) \
                    if arg_params else 0
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """(`model.py:79-87`)"""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _live_params(param_arrays, grad_arrays):
    """(index, arg_list, grad_list) of the parameters that have
    gradients."""
    return [(i, a, g) for i, (a, g) in enumerate(zip(param_arrays,
                                                     grad_arrays))
            if g[0] is not None]


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push the gradients, pull the updated weights (`model.py:89-98`):
    one bucketed push and pull; the store's updater applies the bucket
    in one `update_multi`, or one `update` a parameter under
    ``MXNET_FUSED_UPDATE=0``."""
    live = _live_params(param_arrays, grad_arrays)
    if not live:
        return
    keys = [i for i, _, _ in live]
    kvstore.push(keys, [g for _, _, g in live], priority=0)
    kvstore.pull(keys, out=[a for _, a, _ in live], priority=0)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Update on each device with faked indices (`model.py:100-117`),
    after summing the gradients through ``kvstore`` if there is one.
    ``updater`` is `get_fused_updater`'s closure and takes one list a
    device, device-major, so a key-drawing optimizer draws in the same
    order whether it runs them as one `update_multi` or one `update` a
    parameter (``MXNET_FUSED_UPDATE=0``)."""
    live = _live_params(param_arrays, grad_arrays)
    if not live:
        return
    keys = [i for i, _, _ in live]
    if kvstore:
        kvstore.push(keys, [g for _, _, g in live], priority=0)
        kvstore.pull(keys, out=[g for _, _, g in live], priority=0)
    for k in range(num_device):
        updater([i * num_device + k for i in keys],
                [g[k] for _, _, g in live], [a[k] for _, a, _ in live])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """prefix-symbol.json + prefix-%04d.params (`model.py:315-341`)."""
    symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) that `save_checkpoint` wrote
    (`model.py:343-377`)."""
    from . import symbol as sym_mod

    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def _refuse_fault_tolerance(auto_checkpoint, checkpoint_every, resume):
    """The auto-checkpoint, resume and nonfinite-backoff knobs, by
    argument or pin, raise: they come with the fault-tolerance slice."""
    env = os.environ
    asked = {
        "auto_checkpoint": auto_checkpoint,
        "checkpoint_every": checkpoint_every,
        "resume": resume,
        "MXNET_AUTO_CHECKPOINT": env.get("MXNET_AUTO_CHECKPOINT"),
        "MXNET_AUTO_CHECKPOINT_EVERY":
            env.get("MXNET_AUTO_CHECKPOINT_EVERY", "0") not in ("", "0"),
        "MXNET_AUTO_RESUME": env.get("MXNET_AUTO_RESUME", "0").lower()
        in ("1", "true", "yes"),
        "MXNET_NONFINITE_BACKOFF":
            float(env.get("MXNET_NONFINITE_BACKOFF", "0") or 0) != 0,
    }
    on = sorted(k for k, v in asked.items() if v)
    if on:
        raise MXNetError(
            "%s: mid-epoch auto-checkpoints, resume and the nonfinite lr "
            "backoff are not ported yet (the fault-tolerance slice, "
            "ROADMAP queue 3)" % ", ".join(on))


def _call(callbacks, *args):
    for cb in callbacks if isinstance(callbacks, list) else [callbacks]:
        cb(*args)


def _train_multi_device(symbol, ctx, arg_names, param_names, aux_names,
                        arg_params, aux_params, begin_epoch, end_epoch,
                        epoch_size, optimizer, kvstore, update_on_kvstore,
                        train_data, eval_data=None, eval_metric=None,
                        epoch_end_callback=None, batch_end_callback=None,
                        logger=None, work_load_list=None, monitor=None,
                        eval_batch_end_callback=None):
    """The training loop (`model.py:119-312`)."""
    if logger is None:
        logger = logging
    metric_mod.metric_interval()  # raises for the in-graph accumulation
    executor_manager = DataParallelExecutorManager(
        symbol=symbol, ctx=ctx, train_data=train_data,
        param_names=param_names, arg_names=arg_names, aux_names=aux_names,
        work_load_list=work_load_list, logger=logger)
    if monitor:
        executor_manager.install_monitor(monitor)
    executor_manager.set_params(arg_params, aux_params)

    updater = None
    if not update_on_kvstore:
        updater = get_fused_updater(optimizer)
    if kvstore:
        _initialize_kvstore(kvstore=kvstore,
                            param_arrays=executor_manager.param_arrays,
                            arg_params=arg_params,
                            param_names=executor_manager.param_names,
                            update_on_kvstore=update_on_kvstore)
    if update_on_kvstore:
        kvstore.set_optimizer(optimizer)

    train_data.reset()
    for epoch in range(begin_epoch, end_epoch):
        tic = time.time()
        eval_metric.reset()
        nbatch = 0
        while True:
            do_reset = True
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                executor_manager.load_data_batch(data_batch)
                executor_manager.forward(is_train=True)
                executor_manager.backward()
                if update_on_kvstore:
                    _update_params_on_kvstore(executor_manager.param_arrays,
                                              executor_manager.grad_arrays,
                                              kvstore)
                else:
                    _update_params(executor_manager.param_arrays,
                                   executor_manager.grad_arrays,
                                   updater=updater, num_device=len(ctx),
                                   kvstore=kvstore)
                if monitor is not None:
                    monitor.toc_print()
                executor_manager.update_metric(eval_metric, data_batch.label)
                nbatch += 1
                if batch_end_callback is not None:
                    _call(batch_end_callback,
                          BatchEndParam(epoch=epoch, nbatch=nbatch,
                                        eval_metric=eval_metric))
                if epoch_size is not None and nbatch >= epoch_size:
                    do_reset = False
                    break
            if do_reset:
                logger.info("Epoch[%d] Resetting Data Iterator", epoch)
                train_data.reset()
            if epoch_size is None or nbatch >= epoch_size:
                break
        logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)

        executor_manager.copy_to(arg_params, aux_params)
        if epoch_end_callback is not None:
            _call(epoch_end_callback, epoch, symbol, arg_params, aux_params)

        if eval_data:
            eval_metric.reset()
            eval_data.reset()
            for i, eval_batch in enumerate(eval_data):
                executor_manager.load_data_batch(eval_batch)
                executor_manager.forward(is_train=False)
                executor_manager.update_metric(eval_metric, eval_batch.label)
                if eval_batch_end_callback is not None:
                    _call(eval_batch_end_callback,
                          BatchEndParam(epoch=epoch, nbatch=i,
                                        eval_metric=eval_metric))
            eval_data.reset()
            for name, value in eval_metric.get_name_value():
                logger.info("Epoch[%d] Validation-%s=%f", epoch, name, value)


def _host(value):
    """An NDArray on the CPU from an NDArray, a tensor or a numpy array
    (a JAX package NDArray through its ``asnumpy``)."""
    if isinstance(value, NDArray):
        return value
    if hasattr(value, "asnumpy"):
        value = value.asnumpy()
    return nd.array(value, ctx=cpu(), dtype=getattr(value, "dtype", None))


class FeedForward:
    """sklearn-style model (`python/mxnet/model.py:379-906`)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=init_mod.Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        if not isinstance(symbol, Symbol):
            raise TypeError("symbol must be a Symbol")
        self.symbol = symbol
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = None if arg_params is None else \
            {k: _host(v) for k, v in arg_params.items()}
        self.aux_params = None if aux_params is None else \
            {k: _host(v) for k, v in aux_params.items()}
        self.allow_extra_params = allow_extra_params
        self.argument_checked = False
        self.begin_epoch = begin_epoch
        self._pred_exec = None

    def _check_arguments(self):
        if self.argument_checked:
            return
        self.argument_checked = True
        _check_arguments(self.symbol)
        if self.allow_extra_params:
            if self.arg_params:
                names = set(self.symbol.list_arguments())
                self.arg_params = {k: v for k, v in self.arg_params.items()
                                   if k in names}
            if self.aux_params:
                names = set(self.symbol.list_auxiliary_states())
                self.aux_params = {k: v for k, v in self.aux_params.items()
                                   if k in names}

    def _init_params(self, input_shapes, overwrite=False):
        """Host parameter dicts on the CPU: given values copied in, the
        rest drawn by the initializer in argument order."""
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % input_shapes)
        arg_names = self.symbol.list_arguments()
        param_names = [k for k in arg_names if k not in input_shapes]
        aux_names = self.symbol.list_auxiliary_states()
        arg_params = {k: zeros(s, ctx=cpu())
                      for k, s in zip(arg_names, arg_shapes)
                      if k in param_names}
        aux_params = {k: zeros(s, ctx=cpu())
                      for k, s in zip(aux_names, aux_shapes)}
        for given, mine in ((self.arg_params, arg_params),
                            (self.aux_params, aux_params)):
            for k, v in mine.items():
                if given and k in given and not overwrite:
                    v[:] = given[k]
                else:
                    self.initializer(k, v)
        self.arg_params = arg_params
        self.aux_params = aux_params
        return arg_names, param_names, aux_names

    def _init_predictor(self, input_shapes):
        if self._pred_exec is not None and all(
                self._pred_exec.arg_dict[n].shape == tuple(s)
                for n, s in input_shapes.items()):
            return
        pred_exec = self.symbol.simple_bind(self.ctx[0], grad_req="null",
                                            **input_shapes)
        pred_exec.copy_params_from(self.arg_params, self.aux_params)
        self._pred_exec = pred_exec

    def _init_iter(self, X, y, is_train):
        if isinstance(X, (np.ndarray, NDArray)):
            if y is None:
                if is_train:
                    raise ValueError("y must be specified when X is numpy")
                y = np.zeros(X.shape[0])
            batch_size = min(self.numpy_batch_size, X.shape[0])
            return NDArrayIter(
                X, y, batch_size=batch_size, shuffle=is_train,
                last_batch_handle="roll_over" if is_train else "pad")
        if not isinstance(X, DataIter):
            raise TypeError("X must be DataIter, numpy or NDArray")
        return X

    def _init_eval_iter(self, eval_data):
        if eval_data is None:
            return None
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            return self._init_iter(eval_data[0], eval_data[1], is_train=True)
        return eval_data

    def _bind_predictor(self, X, reset):
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        data_shapes = X.provide_data
        self._init_predictor(dict(data_shapes))
        return X, [self._pred_exec.arg_dict[n] for n, _ in data_shapes]

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy, padding dropped
        (`model.py:586-646`)."""
        X, data_arrays = self._bind_predictor(X, reset)
        batch_size = X.batch_size
        output_list = [[] for _ in self.symbol.list_outputs()]
        data_list = [[] for _ in X.provide_data] if return_data else None
        label_list = [[] for _ in X.provide_label] if return_data else None
        for i, batch in enumerate(X):
            if num_batch is not None and i == num_batch:
                break
            for arr, src in zip(data_arrays, batch.data):
                src.copyto(arr)
            self._pred_exec.forward(is_train=False)
            real_size = batch_size - batch.pad
            for lst, o in zip(output_list, self._pred_exec.outputs):
                lst.append(o.asnumpy()[:real_size])
            if return_data:
                for lst, d in zip(data_list, batch.data):
                    lst.append(d.asnumpy()[:real_size])
                for lst, lab in zip(label_list, batch.label):
                    lst.append(lab.asnumpy()[:real_size])
        outputs = [np.concatenate(lst) for lst in output_list]
        if len(outputs) == 1:
            outputs = outputs[0]
        if return_data:
            data = [np.concatenate(lst) for lst in data_list]
            label = [np.concatenate(lst) for lst in label_list]
            if len(data) == 1:
                data, label = data[0], label[0]
            return outputs, data, label
        return outputs

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The metric's value over ``X`` (`model.py` score)."""
        X, data_arrays = self._bind_predictor(X, reset)
        metric = eval_metric if isinstance(eval_metric,
                                           metric_mod.EvalMetric) \
            else metric_mod.create(eval_metric)
        for i, batch in enumerate(X):
            if num_batch is not None and i == num_batch:
                break
            for arr, src in zip(data_arrays, batch.data):
                src.copyto(arr)
            self._pred_exec.forward(is_train=False)
            metric.update(batch.label, self._pred_exec.outputs)
            if batch_end_callback is not None:
                _call(batch_end_callback,
                      BatchEndParam(epoch=0, nbatch=i, eval_metric=metric))
        return metric.get()[1]

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_batch_end_callback=None, auto_checkpoint=None,
            checkpoint_every=0, resume=None):
        """Train (`model.py:694-790`)."""
        _refuse_fault_tolerance(auto_checkpoint, checkpoint_every, resume)
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)
        self.kwargs["sym"] = self.symbol

        input_shapes = dict(data.provide_data + data.provide_label)
        arg_names, param_names, aux_names = self._init_params(input_shapes)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self.ctx), self.arg_params)
        param_idx2name = {}
        if update_on_kvstore:
            param_idx2name.update(enumerate(param_names))
        else:
            for i, n in enumerate(param_names):
                for k in range(len(self.ctx)):
                    param_idx2name[i * len(self.ctx) + k] = n
        self.kwargs["param_idx2name"] = param_idx2name

        if isinstance(self.optimizer, str):
            optimizer = Optimizer.create_optimizer(
                self.optimizer, rescale_grad=(1.0 / data.batch_size),
                **self.kwargs)
        elif isinstance(self.optimizer, Optimizer):
            optimizer = self.optimizer
        else:
            raise TypeError("optimizer must be a name or an Optimizer")

        _train_multi_device(
            self.symbol, self.ctx, arg_names, param_names, aux_names,
            self.arg_params, self.aux_params,
            begin_epoch=self.begin_epoch, end_epoch=self.num_epoch,
            epoch_size=self.epoch_size, optimizer=optimizer,
            train_data=data, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback,
            kvstore=kvstore, update_on_kvstore=update_on_kvstore,
            logger=logger, work_load_list=work_load_list, monitor=monitor,
            eval_batch_end_callback=eval_batch_end_callback)

    def save(self, prefix, epoch=None):
        """(`model.py` save)"""
        if epoch is None:
            epoch = self.num_epoch
        if epoch is None:
            raise MXNetError("epoch unknown; pass epoch=")
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """(`model.py:814`)"""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           num_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=init_mod.Uniform(0.01),
               eval_data=None, eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_batch_end_callback=None, **kwargs):
        """Create and fit in one call (`model.py` create)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
