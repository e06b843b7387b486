"""Data-parallel executor group: one executor per context.

A port of `mxnet_tpu/executor_manager.py` (the reference's
`python/mxnet/executor_manager.py`): `_split_input_slice` divides a batch
by ``work_load_list``, `DataParallelExecutorGroup` binds one executor per
context and copies each device's slice of a batch into it, and
`DataParallelExecutorManager` drives the group for `model.FeedForward`.
Gradients are reduced by the training loop (through the KVStore, or by
each device's updater) and `copy_to` averages the devices' parameters
into the host dicts.

A group bound with ``shared_group`` (a `module.BucketingModule` bucket)
binds the shared group's parameter and gradient NDArrays themselves, so
every bucket reads and updates one set of tensors.  `prefetch_plan`
tells `io.DevicePrefetchIter` where each device's slice goes, and
`load_data_batch` binds a staged batch's slices in place of the copy,
after checking every shape.  `install_metric_stats` puts a metric's
device statistics into every executor's training step, and
`fetch_metric_stats` brings them back in one blocking fetch.  The
group counts ``io.device_batches`` (staged batches bound) and
``train.host_blocking_fetches`` (metric fetches) in `telemetry`.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from . import telemetry
from .base import MXNetError
from .io import PrefetchPlan
from .kvstore import _reduce
from .ndarray import NDArray, zeros

__all__ = ["DataParallelExecutorGroup", "DataParallelExecutorManager"]


def _reduce_blocks(blocks):
    """The sum of the devices' copies of one array, as a tensor on the
    first one's device."""
    return _reduce(blocks).data


def _split_input_slice(batch_size, work_load_list):
    """Per-device slices of a batch, proportional to the work load
    (`executor_manager.py:13-45`)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size smaller than device count")
    slices = []
    begin = 0
    for i in range(len(work_load_list)):
        end = int(round(batch_size * (sum(work_load_list[: i + 1]) / total)))
        end = min(end, batch_size)
        slices.append(slice(begin, end))
        begin = end
    if begin != batch_size:
        slices[-1] = slice(slices[-1].start, batch_size)
    return slices


def _check_arguments(symbol):
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise MXNetError("duplicate argument names in symbol")
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise MXNetError("duplicate aux names in symbol")


def _load_general(data, targets):
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, NDArray):
            d_src.copyto(d_targets)
        else:
            for slice_idx, d_dst in d_targets:
                d_src[slice_idx.start:slice_idx.stop].copyto(d_dst)


class DataParallelExecutorGroup:
    """One executor per context, each bound to its slice of the batch
    (`executor_manager.py:180-262`)."""

    def __init__(self, sym, arg_names, param_names, ctx, slices, train_data,
                 shared_group=None, grad_req="write"):
        _check_arguments(sym)
        self.sym = sym
        self.arg_names = arg_names
        self.param_names = param_names
        self.ctx = ctx
        self.slices = slices

        data_shapes = {k: tuple(v) for k, v in
                       train_data.provide_data + train_data.provide_label}
        self.data_names = [k for k, _ in train_data.provide_data]
        self.label_names = [k for k, _ in train_data.provide_label]
        self.aux_names = sym.list_auxiliary_states()
        self.param_idx = [i for i, name in enumerate(arg_names)
                          if name in param_names]

        self.train_execs = []
        for i, ctxi in enumerate(ctx):
            rows = slices[i].stop - slices[i].start
            shapes = {k: (rows,) + v[1:] for k, v in data_shapes.items()}
            if shared_group is None:
                exe = sym.simple_bind(ctxi, grad_req=grad_req, **shapes)
            else:
                exe = self._bind_shared(sym, ctxi, shapes, grad_req,
                                        shared_group.train_execs[i])
            self.train_execs.append(exe)

        self.data_arrays = [
            [(slices[i], e.arg_dict[name])
             for i, e in enumerate(self.train_execs)]
            for name in self.data_names]
        self.label_arrays = [
            [(slices[i], e.arg_dict[name])
             for i, e in enumerate(self.train_execs)]
            for name in self.label_names]
        self.param_arrays = [[e.arg_arrays[i] for e in self.train_execs]
                             for i in self.param_idx]
        self.grad_arrays = [[e.grad_arrays[i] for e in self.train_execs]
                            for i in self.param_idx]
        self.aux_arrays = [[e.aux_arrays[i] for e in self.train_execs]
                           for i in range(len(self.aux_names))]

    def _bind_shared(self, sym, ctx, shapes, grad_req, shared):
        """An executor of ``sym`` whose parameters, their gradients and
        the aux states are ``shared``'s NDArrays (a bucket of a
        `BucketingModule` reads and updates the default bucket's)."""
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % (shapes,))
        own = shared.arg_dict
        own_grads = shared.grad_dict
        args, grads = [], []
        for n, s in zip(sym.list_arguments(), arg_shapes):
            if n in self.param_names:
                if own[n].shape != tuple(s):
                    raise MXNetError(
                        "shared parameter %r has shape %s, this symbol "
                        "needs %s" % (n, own[n].shape, tuple(s)))
                args.append(own[n])
                grads.append(own_grads.get(n))
            else:
                args.append(zeros(s, ctx))
                grads.append(zeros(s, ctx))
        return sym.bind(ctx, args, grads, grad_req, shared.aux_arrays)

    def prefetch_plan(self):
        """The `io.DevicePrefetchIter` plan of this group: its batch slices
        and contexts (made once)."""
        plan = getattr(self, "_plan", None)
        if plan is None:
            plan = self._plan = PrefetchPlan(self.slices, self.ctx)
        return plan

    def load_data_batch(self, data_batch):
        """Bind a batch staged by this group's plan in place; copy each
        device's slice of any other batch into its executor."""
        parts = getattr(data_batch, "device_parts", None)
        if parts is not None and parts.get("key") == self.prefetch_plan().key:
            pairs = [
                (src, dst)
                for per_dev, targets in zip(
                    list(parts["data"]) + list(parts["label"]),
                    list(self.data_arrays) + list(self.label_arrays))
                for src, (_, dst) in zip(per_dev, targets)]
            for src, dst in pairs:  # check all before binding any
                if src.shape != dst.shape:
                    raise MXNetError(
                        "staged batch slice shape %s does not match "
                        "bound array %s (ragged batch?)"
                        % (src.shape, dst.shape))
            for ctx, event in zip(self.ctx, parts["events"]):
                if event is not None:  # the copy is ordered, not waited
                    torch.cuda.current_stream(
                        ctx.torch_device()).wait_event(event)
            for src, dst in pairs:
                t = src.data
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
                if t.dtype != dst.data.dtype:
                    t = t.to(dst.data.dtype)
                dst._data = t
            telemetry.inc("io.device_batches")
            return
        _load_general(data_batch.data, self.data_arrays)
        _load_general(data_batch.label, self.label_arrays)

    def forward(self, is_train=False):
        for e in self.train_execs:
            e.forward(is_train=is_train)

    def backward(self):
        for e in self.train_execs:
            e.backward()

    def update_metric(self, metric, labels):
        for e, sl in zip(self.train_execs, self.slices):
            lab = [l[sl.start:sl.stop] for l in labels]
            metric.update(lab, e.outputs)

    def install_metric_stats(self, metric):
        """Add ``metric``'s device statistics to every executor's training
        step (`Executor.set_step_stat_fn`).  False, leaving the host
        update, where the metric has none or the symbol has no label."""
        n = metric.device_stats_size()
        if not n or not self.label_names:
            return False
        arg_names = self.sym.list_arguments()
        if any(name not in arg_names for name in self.label_names):
            return False
        label_idx = [arg_names.index(name) for name in self.label_names]

        def stat_fn(outputs, args):
            return metric.device_batch_stats([args[i] for i in label_idx],
                                             list(outputs))

        for e in self.train_execs:
            e.set_step_stat_fn(stat_fn, n)
        return True

    def uninstall_metric_stats(self):
        for e in self.train_execs:
            e.set_step_stat_fn(None)

    def fetch_metric_stats(self, metric):
        """Fold the devices' accumulated statistics into ``metric``: one
        blocking fetch, counted.  False when nothing accumulated since the
        last fetch."""
        pending = [p for p in (e.pop_step_stats() for e in self.train_execs)
                   if p is not None]
        if not pending:
            return False
        telemetry.blocking_fetch("metric_interval")
        total = np.zeros((metric.device_stats_size(),), np.float64)
        for p in pending:
            total += p.cpu().numpy().astype(np.float64)
        metric.apply_device_stats(total)
        return True


class DataParallelExecutorManager:
    """The group and the parameter/gradient lists for the training loop
    (`executor_manager.py:288-318`)."""

    def __init__(self, symbol, ctx, train_data, param_names, arg_names,
                 aux_names, work_load_list=None, logger=None):
        if logger is None:
            logger = logging
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if len(work_load_list) != num_device:
            raise MXNetError("work_load_list must match ctx length")
        self.slices = _split_input_slice(train_data.batch_size,
                                         work_load_list)
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.execgrp = DataParallelExecutorGroup(
            symbol, arg_names, param_names, ctx, self.slices, train_data)
        self.symbol = symbol
        self.curr_execgrp = self.execgrp

    def install_monitor(self, monitor):
        for e in self.curr_execgrp.train_execs:
            monitor.install(e)

    def set_params(self, arg_params, aux_params):
        for e in self.curr_execgrp.train_execs:
            e.copy_params_from(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """Average each parameter and aux state over the devices into the
        host dicts (the KVStore's sum, then a divide, as the JAX
        package's fused mean)."""
        blocks = list(self.param_arrays) + list(self.aux_arrays)
        dsts = [arg_params[n] for n in self.param_names] + \
            [aux_params[n] for n in self.aux_names]
        for dst, devs in zip(dsts, blocks):
            dst[:] = _reduce(devs).data / len(devs)

    @property
    def param_arrays(self):
        return self.curr_execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.curr_execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.curr_execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)

    def prefetch_plan(self):
        return self.curr_execgrp.prefetch_plan()

    def install_metric_stats(self, metric):
        return self.curr_execgrp.install_metric_stats(metric)

    def uninstall_metric_stats(self):
        self.curr_execgrp.uninstall_metric_stats()

    def fetch_metric_stats(self, metric):
        return self.curr_execgrp.fetch_metric_stats(metric)
