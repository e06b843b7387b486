"""SequentialModule: a chain of modules (`mxnet_tpu/module/
sequential_module.py`, the reference's
`python/mxnet/module/sequential_module.py`).

Each module's first output is the next one's ``data``; the last module
(or one added with ``take_labels=True``) gets the labels.  `backward`
runs the chain in reverse with the head gradients for the last module
only, as the JAX package's does.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("add modules first")
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False) or \
                i == len(self._modules) - 1
            module.bind(my_data_shapes,
                        label_shapes if take_labels else None,
                        for_training=for_training, force_rebind=force_rebind)
            # this module's outputs are the next one's data
            _, out_shapes, _ = module.symbol.infer_shape(
                **dict(my_data_shapes))
            my_data_shapes = [("data", s) for s in (out_shapes or [])][:1] \
                or my_data_shapes
        self.binded = True
        self.for_training = for_training

    def init_params(self, **kwargs):
        for module in self._modules:
            module.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        for module in self._modules:
            module.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i < len(self._modules) - 1:
                outs = module.get_outputs()
                batch = DataBatch(
                    data=outs, label=data_batch.label, pad=data_batch.pad,
                    provide_data=[("data", outs[0].shape)],
                    provide_label=data_batch.provide_label)

    def backward(self, out_grads=None):
        for module in reversed(self._modules):
            module.backward(out_grads)
            out_grads = None

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._modules[-1].update_metric(eval_metric, labels)

    def get_params(self):
        arg, aux = {}, {}
        for module in self._modules:
            a, x = module.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def install_monitor(self, monitor):
        for module in self._modules:
            module.install_monitor(monitor)
