"""Module: a symbol over a data-parallel executor group
(`mxnet_tpu/module/module.py`, the reference's
`python/mxnet/module/module.py:18-441`).

The host parameter dicts live on the CPU, as `model.FeedForward`'s do;
`init_params` draws or copies them there and into every device's
executor, and `get_params` brings back the devices' mean.  The update is
`optimizer.get_fused_updater`'s one `update_multi` a device a step, or
the KVStore's (``kvstore`` 'local', 'device', a `KVStore`, or None; the
store runs the update when `model._create_kvstore` says so).  `bind`
takes ``grad_req`` for the parameters (a string or a dict by name); the
data get gradients only with ``inputs_need_grad`` (`get_input_grads`),
the labels never.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..executor_manager import (DataParallelExecutorGroup, _reduce_blocks,
                                _split_input_slice)
from ..model import (_create_kvstore, _host, _initialize_kvstore, _state_ctx,
                     _update_params, _update_params_on_kvstore)
from ..ndarray import NDArray, zeros
from ..optimizer import Optimizer, get_fused_updater
from .base_module import BaseModule

__all__ = ["Module"]


class _DataStub:
    """provide_data/provide_label/batch_size carrier for binding the
    group."""

    def __init__(self, provide_data, provide_label, batch_size):
        self.provide_data = provide_data
        self.provide_label = provide_label
        self.batch_size = batch_size


def _merge(arrays):
    """The devices' NDArrays of one output, concatenated on the first
    one's device."""
    if len(arrays) == 1:
        return arrays[0]
    dev = arrays[0].data.device
    return NDArray(torch.cat([a.data.to(dev) for a in arrays]),
                   arrays[0].context)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        elif isinstance(context, Context):
            context = [context]
        self._context = list(context)
        self._work_load_list = work_load_list or [1] * len(self._context)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params = None
        self._aux_params = None
        self._exec_group = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._inputs_need_grad = False

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    def _grad_reqs(self, for_training, inputs_need_grad, grad_req):
        """Each argument's grad_req: the parameters' from ``grad_req``,
        the data's "write" only with ``inputs_need_grad``, the labels'
        "null"."""
        reqs = {}
        for n in self._symbol.list_arguments():
            if not for_training:
                reqs[n] = "null"
            elif n in self._param_names:
                reqs[n] = grad_req.get(n, "null") \
                    if isinstance(grad_req, dict) else grad_req
            elif n in self._data_names and inputs_need_grad:
                reqs[n] = "write"
            else:
                reqs[n] = "null"
        return reqs

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind an executor a context; with ``shared_module``, on its
        parameter and gradient arrays (`BucketingModule`'s buckets)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self._inputs_need_grad = bool(inputs_need_grad and for_training)
        self.binded = True
        label_shapes = label_shapes or []
        batch_size = data_shapes[0][1][0]
        slices = _split_input_slice(batch_size, self._work_load_list)
        stub = _DataStub(list(data_shapes), list(label_shapes), batch_size)
        shared_group = shared_module._exec_group if shared_module else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._symbol.list_arguments(), self._param_names,
            self._context, slices, stub, shared_group=shared_group,
            grad_req=self._grad_reqs(for_training, inputs_need_grad,
                                     grad_req))
        if shared_module is not None and shared_module.params_initialized:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Fill the host parameters (given values first, else the
        initializer) and copy them into every executor."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("bind() before init_params()")
        if self._arg_params is None:
            self._arg_params = {
                name: zeros(blocks[0].shape, cpu(), dtype=blocks[0].dtype)
                for name, blocks in zip(self._param_names,
                                        self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: zeros(blocks[0].shape, cpu(), dtype=blocks[0].dtype)
                for name, blocks in zip(self._aux_names,
                                        self._exec_group.aux_arrays)}
        for name, arr in self._arg_params.items():
            if arg_params and name in arg_params:
                arr[:] = _host(arg_params[name])
            elif initializer is not None:
                initializer(name, arr)
            elif not allow_missing and not force_init:
                raise MXNetError("no initializer and no value for %r" % name)
        for name, arr in self._aux_params.items():
            if aux_params and name in aux_params:
                arr[:] = _host(aux_params[name])
            elif initializer is not None:
                initializer(name, arr)
        self.params_initialized = True
        for e in self._exec_group.train_execs:
            e.copy_params_from(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """The KVStore (`model._create_kvstore`) and the optimizer: by name,
        with ``rescale_grad`` 1 / batch size, or an `Optimizer`."""
        if self.optimizer_initialized and not force_init:
            return
        optimizer_params = dict(optimizer_params or {"learning_rate": 0.01})
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if isinstance(optimizer, str):
            batch_size = self._exec_group.slices[-1].stop
            if kvstore and "dist" in kvstore.type:
                batch_size *= kvstore.num_workers
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._param_names))
            else:
                for i, n in enumerate(self._param_names):
                    for k in range(len(self._context)):
                        idx2name[i * len(self._context) + k] = n
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = Optimizer.create_optimizer(
                optimizer, param_idx2name=idx2name, **optimizer_params)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        if kvstore:
            _initialize_kvstore(
                kvstore=kvstore, param_arrays=self._exec_group.param_arrays,
                arg_params=self._arg_params, param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(optimizer)
        else:
            self._updater = get_fused_updater(optimizer)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._exec_group.load_data_batch(data_batch)
        self._exec_group.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if out_grads is None:
            self._exec_group.backward()
            return
        for e in self._exec_group.train_execs:
            e.backward(out_grads)

    def update(self):
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        outs = [e.outputs for e in self._exec_group.train_execs]
        if merge_multi_context:
            return [_merge([o[i] for o in outs]) for i in range(len(outs[0]))]
        return outs

    def get_input_grads(self, merge_multi_context=True):
        """The data's gradients of the last backward (bound with
        ``inputs_need_grad``)."""
        if not self._inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True to get the "
                             "input gradients")
        grads = [[e.grad_dict[n] for e in self._exec_group.train_execs]
                 for n in self._data_names]
        if merge_multi_context:
            return [_merge(g) for g in grads]
        return grads

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    # -- the hooks of BaseModule.fit's loop ---------------------------------
    def _prefetch_plan(self):
        """The staging plan for io.DevicePrefetchIter (None before
        bind)."""
        if self._exec_group is None:
            return None
        return self._exec_group.prefetch_plan()

    def _metric_stats_install(self, eval_metric):
        return self._exec_group.install_metric_stats(eval_metric)

    def _metric_stats_fetch(self, eval_metric):
        return self._exec_group.fetch_metric_stats(eval_metric)

    def _metric_stats_uninstall(self):
        self._exec_group.uninstall_metric_stats()

    def _state_ctx(self):
        """Where a resumed optimizer-state key goes (see `restore_auto`)."""
        return _state_ctx(self._context, self._update_on_kvstore)

    def get_params(self):
        """(arg, aux) host dicts: the mean over the devices."""
        arg = {k: v.copy() for k, v in self._arg_params.items()}
        aux = {k: v.copy() for k, v in self._aux_params.items()}
        for name, blocks in zip(self._param_names,
                                self._exec_group.param_arrays):
            arg[name][:] = _reduce_blocks(blocks) / len(blocks)
        for name, blocks in zip(self._aux_names, self._exec_group.aux_arrays):
            aux[name][:] = _reduce_blocks(blocks) / len(blocks)
        return arg, aux

    def install_monitor(self, monitor):
        for e in self._exec_group.train_execs:
            monitor.install(e)
