"""PythonModule: a module written in Python (`mxnet_tpu/module/
python_module.py`, the reference's `python/mxnet/module/python_module.py`).

A subclass supplies `_compute_output_shapes` and `forward` (setting
``self._outputs``); it has no parameters, so initialization, the
optimizer, `update` and `backward` do nothing (a loss or metric stage
at the end of a `SequentialModule`).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule

__all__ = ["PythonModule"]


class PythonModule(BaseModule):
    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None
        self._outputs = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = list(data_shapes)
        self._label_shapes = list(label_shapes or [])
        self._output_shapes = self._compute_output_shapes()
        self.binded = True
        self.for_training = for_training
        self.params_initialized = True  # no parameters

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_params(self, **kwargs):
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        self.optimizer_initialized = True

    def get_params(self):
        return {}, {}

    def update(self):
        pass

    def backward(self, out_grads=None):
        pass

    def get_outputs(self, merge_multi_context=True):
        return self._outputs

    def update_metric(self, eval_metric, labels):
        pass

    def install_monitor(self, monitor):
        pass
