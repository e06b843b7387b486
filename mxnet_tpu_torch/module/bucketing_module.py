"""BucketingModule (`mxnet_tpu/module/bucketing_module.py`, the
reference's `python/mxnet/module/bucketing_module.py`).

Variable-length sequences: one `Module` a bucket from
``sym_gen(bucket_key)``, bound on first use.  Every bucket binds the
default bucket's parameter and gradient NDArrays themselves
(`DataParallelExecutorGroup(shared_group=)`), so one update reaches
every bucket, and the default bucket's optimizer and updater serve all
of them.  The reference shared the executors' memory pool as well
(`graph_executor.h:48-55`); each bucket here allocates its own
activations.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    def _call_sym_gen(self, key):
        out = self._sym_gen(key)
        if isinstance(out, tuple):
            return out
        return out, ("data",), ("softmax_label",)

    def _module(self, key):
        sym, data_names, label_names = self._call_sym_gen(key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket."""
        if self.binded and not force_rebind:
            return
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._buckets = {self._default_bucket_key: module}
        self.binded = True
        self.for_training = for_training

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding it on the default
        bucket's parameters on first use (`bucketing_module.py:181`)."""
        if not self.binded:
            raise MXNetError("bind() before switch_bucket()")
        if bucket_key not in self._buckets:
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]

    def init_params(self, **kwargs):
        if self.params_initialized and not kwargs.get("force_init", False):
            return
        self._buckets[self._default_bucket_key].init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        if self.optimizer_initialized and not kwargs.get("force_init",
                                                         False):
            return
        self._buckets[self._default_bucket_key].init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._borrow_optimizer()
        self._curr_module.forward(data_batch, is_train=is_train)

    def _borrow_optimizer(self):
        """A bucket updates with the default bucket's optimizer, updater
        and store (its parameters are the default bucket's already)."""
        default = self._buckets[self._default_bucket_key]
        cur = self._curr_module
        if cur is not default:
            cur.params_initialized = True
            if not cur.optimizer_initialized:
                cur._optimizer = default._optimizer
                cur._updater = default._updater
                cur._kvstore = default._kvstore
                cur._update_on_kvstore = default._update_on_kvstore
                cur.optimizer_initialized = True

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def install_monitor(self, monitor):
        for mod in self._buckets.values():
            mod.install_monitor(monitor)
