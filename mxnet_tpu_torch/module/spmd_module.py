"""SPMDModule: the Module interface over the fused `parallel.SPMDTrainer`
(`mxnet_tpu/module/spmd_module.py`).

The same `fit`/`score`/`predict`/`bind`/`init_params`/`init_optimizer`
surface as `Module` (`BaseModule`'s loops drive it), but forward,
backward and the update run as one `SPMDTrainer.step` in `update()`, and
``forward(is_train=False)`` is `SPMDTrainer.forward`.  The trainer runs
on one device: ``mesh=None`` (or a mesh of one device) is the card
unless ``ctx`` says otherwise, and a mesh of more devices raises.  The
optimizer is 'sgd', 'ccsgd' or 'adam' with the JAX module's defaults
(momentum and wd 0, Adam's lr 0.002, its second moment in float32).

    mod = mx.mod.SPMDModule(net, dtype="bfloat16")
    mod.fit(train_iter, num_epoch=10, optimizer="adam",
            optimizer_params={"learning_rate": 1e-3})
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import initializer as init_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray
from ..parallel.trainer import SPMDTrainer, _host, _one_device
from .base_module import BaseModule

__all__ = ["SPMDModule"]


class SPMDModule(BaseModule):
    def __init__(self, symbol, mesh=None, dtype=np.float32,
                 param_sharding=None, logger=None, ctx=None):
        super().__init__(logger or logging)
        _one_device(mesh)
        self._symbol = symbol
        self._mesh = mesh
        self._dtype = dtype
        self._param_sharding = param_sharding
        self._ctx = ctx
        self._trainer = None
        self._data_shapes = None
        self._initializer = None
        self._arg_params = None
        self._aux_params = None
        self._pending_batch = None
        self._outputs = None

    # -- setup -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False, **_):
        if self.binded and not force_rebind:
            return
        shapes = dict(data_shapes)
        for name, s in (label_shapes or []):
            shapes[name] = s
        self._data_shapes = {n: tuple(s) for n, s in shapes.items()}
        self.binded = True
        self.for_training = for_training

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, **_):
        """Keep the initializer and given values for the trainer, which
        `init_optimizer` builds (or copy them in, once it exists)."""
        if not self.binded:
            raise MXNetError("bind before init_params")
        if self._trainer is not None:
            self.set_params(arg_params or {}, aux_params or {})
        else:
            self._initializer = initializer or init_mod.Uniform(0.01)
            self._arg_params = arg_params
            self._aux_params = aux_params
        self.params_initialized = True

    def init_optimizer(self, kvstore=None, optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """Build the trainer (``kvstore`` is accepted and unused: the
        gradients are the trainer's own)."""
        if self.optimizer_initialized and not force_init:
            return
        p = dict(optimizer_params or {})
        if optimizer not in ("sgd", "ccsgd", "adam"):
            raise MXNetError(
                "SPMDModule fuses the optimizer into the step; sgd and "
                "adam are supported (got %r): use Module for others"
                % (optimizer,))
        self._trainer = SPMDTrainer(
            self._symbol, self._mesh, self._data_shapes,
            initializer=self._initializer, optimizer=optimizer,
            lr=p.get("learning_rate", 0.002 if optimizer == "adam" else 0.01),
            momentum=p.get("momentum", 0.0), wd=p.get("wd", 0.0),
            beta1=p.get("beta1", 0.9), beta2=p.get("beta2", 0.999),
            epsilon=p.get("epsilon", 1e-8),
            clip_gradient=p.get("clip_gradient"), dtype=self._dtype,
            param_sharding=self._param_sharding, ctx=self._ctx)
        if self._arg_params:
            self.set_params(self._arg_params, self._aux_params or {})
        self.optimizer_initialized = True

    # -- the step ------------------------------------------------------------
    def _batch_dict(self, data_batch):
        arrays = list(data_batch.data) + list(data_batch.label or [])
        provided = [n for n, _ in (data_batch.provide_data or [])
                    + (data_batch.provide_label or [])]
        by_name = dict(zip(provided or self._trainer.data_names, arrays))
        return {n: (v.data if isinstance(v, NDArray) else v)
                for n, v in by_name.items()
                if n in self._trainer.data_names}

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        if self._trainer is None:
            if is_train:
                raise MXNetError("init_optimizer before training forward")
            # inference after bind and init_params: an inert trainer,
            # which fit's init_optimizer replaces
            self.init_optimizer(optimizer_params={"learning_rate": 0.0})
            self.optimizer_initialized = False
        batch = self._batch_dict(data_batch)
        if is_train:
            self._pending_batch = batch  # the step runs in update()
            self._outputs = None
        else:
            self._outputs = self._trainer.forward(batch)
            self._pending_batch = None

    def backward(self, out_grads=None):
        pass  # inside the step

    def update(self):
        if self._pending_batch is None:
            raise MXNetError("update: no pending training batch")
        self._outputs = self._trainer.step(self._pending_batch)
        self._pending_batch = None

    def get_outputs(self, merge_multi_context=True):
        if self._outputs is None:
            raise MXNetError("no outputs; run forward/update first")
        return [NDArray(o.detach()) for o in self._outputs]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # -- parameters ------------------------------------------------------------
    def get_params(self):
        """(arg, aux) dicts of float32 NDArrays on the CPU."""
        arg, aux = self._trainer.get_params()
        return ({n: nd.array(v, ctx=cpu()) for n, v in arg.items()},
                {n: nd.array(v, ctx=cpu()) for n, v in aux.items()})

    def set_params(self, arg_params, aux_params, **_):
        """Copy values into the trainer's float32 masters and aux states
        (the optimizer state stays)."""
        if self._trainer is None:
            self._arg_params, self._aux_params = arg_params, aux_params
            return
        for table, given in ((self._trainer.params, arg_params or {}),
                             (self._trainer.aux, aux_params or {})):
            for n, v in given.items():
                if n in table:
                    table[n].copy_(torch.from_numpy(_host(v)))
