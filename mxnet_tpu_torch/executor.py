"""The graph function of a Symbol, and the Executor over it.

A port of `mxnet_tpu/executor.py`.  `_build_graph_fn` is its plain walk:
the symbol's nodes in topological order become one function over torch
tensors, ``fn(args, aux, rng, is_train) -> (outputs, new_aux)``, which
runs eagerly and differentiates through torch autograd (the JAX package
traces the same walk under `jax.vjp`).  Its ``on_entry(name, tensor)``
sees every variable and op output as the walk makes it (the eager
monitor).

``rng`` is a key of `random` (a pair of uint32 words) or None.  A node
whose op draws random numbers (``need_rng``) gets a `torch.Generator` on
the arguments' device, seeded from ``fold_in(rng, node position)`` where
the JAX package hands it ``jax.random.fold_in(rng, position)``: the same
structure, PyTorch's own draws.

`Executor` (`Symbol.bind`, `Symbol.simple_bind`; the reference's
`symbolic.h:316-384`) holds the bound argument, gradient and aux
NDArrays.  It keeps the JAX package's key order: binding takes one key
of `random` (`next_key`), and forward number n runs with
``fold_in(that key, n)``.  A training forward runs eagerly and keeps
autograd's graph for `backward` (the JAX package defers it into one
fused forward and backward program; the outputs are the same values).
`backward` differentiates the outputs against ones (the loss heads
ignore it) or the given head gradients, and writes, adds or skips each
gradient by ``grad_req``.  An argument written between a training
forward and its `backward` (an optimizer update in between) makes
`backward` recompute that forward at the current arguments from the aux
states the forward read, so the aux states take one update, as in the
JAX package's replay after its fused update deletes the buffers its
pending forward held (a write that leaves those buffers alive keeps the
JAX package on the forward's values: ROADMAP queue 3).

The monitor (`set_monitor_callback`) sees every entry of a forward's own
walk: ``eager`` hands each entry's NDArray to the callback, ``ingraph``
computes one statistic an entry on the device in that walk and hands
the callback 0-d device tensors of one stacked bundle, which
`monitor.Monitor` fetches in one transfer.  `set_step_stat_fn` adds a
statistic of each training step's outputs and arguments (the metric's
``device_batch_stats``) to a device carry in `backward`, with no host
sync until `pop_step_stats` hands the carry to the caller.  Each
training step (in `backward`) and each other forward feeds the retrace
watch of `telemetry` its arguments' shapes and dtypes.

Refused with an error, never accepted and ignored: ``group2ctx`` over
more than one device, the rematerialization pins
``MXNET_BACKWARD_DO_MIRROR``, ``MXNET_BACKWARD_MIRROR_POLICY`` and
``MXNET_BACKWARD_MIRROR_STEP``, and the AOT cache.
"""
from __future__ import annotations

import os

import torch

from . import random as _random
from . import telemetry
from .base import MXNetError
from .context import Context
from .ndarray import NDArray
from .ops.registry import OpCtx
from .symbol import _topo_order

__all__ = ["_build_graph_fn", "Executor", "AotCache"]


def _build_graph_fn(symbol):
    """fn(arg_tensors, aux_tensors, rng, is_train, on_entry=None) ->
    (outputs, new_aux) for ``symbol``; arguments in `list_arguments`
    order, aux states in `list_auxiliary_states` order.  ``on_entry``,
    if given, is called with each variable's name and tensor and each
    op output's ``<node>_<output>`` name and tensor, in walk order."""
    heads = symbol._heads
    order = _topo_order(heads)
    arg_index = {n: i for i, n in enumerate(symbol.list_arguments())}
    # aux slots per node, in the same global order as list_auxiliary_states()
    aux_slots = {}
    n_aux = 0
    for node in order:
        if not node.is_variable:
            k = len(node.op.list_aux(node.params))
            if k:
                aux_slots[id(node)] = (n_aux, n_aux + k)
                n_aux += k
    seq_of = {id(node): seq for seq, node in enumerate(order)}

    def fn(arg_arrays, aux_arrays, rng, is_train, on_entry=None):
        env = {}
        new_aux = list(aux_arrays)
        device = arg_arrays[0].device if arg_arrays else None
        for node in order:
            if node.is_variable:
                t = arg_arrays[arg_index[node.name]]
                env[(id(node), 0)] = t
                if on_entry is not None:
                    on_entry(node.name, t)
                continue
            inputs = [env[(id(s), i)] for s, i in node.inputs]
            lo, hi = aux_slots.get(id(node), (0, 0))
            gen = None
            if getattr(node.op, "need_rng", False) and rng is not None:
                key = _random.fold_in(rng, seq_of[id(node)])
                gen = torch.Generator(device=device)
                gen.manual_seed(_random.key_seed(key))
            outs, aux_up = node.op.apply(OpCtx(is_train=is_train, rng=gen),
                                         node.params, inputs, new_aux[lo:hi])
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
            if on_entry is not None:
                for o, name in zip(outs, node.op.list_outputs(node.params)):
                    on_entry("%s_%s" % (node.name, name), o)
            for i, u in enumerate(aux_up):
                if u is not None:
                    new_aux[lo + i] = u
        outputs = tuple(env[(id(n), i)] for n, i in heads)
        return outputs, tuple(new_aux)

    return fn


def _later(what, where="ROADMAP queue 1"):
    return MXNetError("%s is not ported yet (%s)" % (what, where))


def _check_mirror_pins():
    """The JAX package's rematerialization pins change what a training
    step stores; the port has no rematerialization yet, so each raises
    rather than being ignored."""
    truthy = ("1", "true", "yes")
    if os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0").lower() in truthy:
        raise _later("MXNET_BACKWARD_DO_MIRROR")
    if os.environ.get("MXNET_BACKWARD_MIRROR_POLICY", "").lower() \
            not in ("", "none"):
        raise _later("MXNET_BACKWARD_MIRROR_POLICY")
    if os.environ.get("MXNET_BACKWARD_MIRROR_STEP", "0") not in ("", "0"):
        raise _later("MXNET_BACKWARD_MIRROR_STEP")


def _asum(x):
    """The reference Monitor's default statistic: |x|.sum() / size."""
    return x.float().abs().sum() / max(x.numel(), 1)


class AotCache:
    """The JAX package's store of ahead-of-time compiled programs.  PyTorch
    runs eagerly; its counterpart (CUDA-graph capture) is later work."""

    def __init__(self, *args, **kwargs):
        raise _later("AotCache (CUDA-graph capture)")


def _as_list(arrays, names, what, allow_missing=False):
    if arrays is None:
        return None
    if isinstance(arrays, dict):
        missing = [n for n in names if n not in arrays]
        if missing and not allow_missing:
            raise MXNetError("%s missing entries for %s" % (what, missing))
        return [arrays.get(n) for n in names]
    arrays = list(arrays)
    if len(arrays) != len(names):
        raise MXNetError("%s: expected %d arrays (%s), got %d"
                         % (what, len(names), names, len(arrays)))
    return arrays


def _as_nd(value, ctx):
    """A bound array as an NDArray on ``ctx``'s device; one that lives on
    another device raises (the executor computes on one)."""
    if value is None:
        return None
    if not isinstance(value, NDArray):
        return NDArray(value, ctx)
    if ctx is not None and value.data.device != ctx.torch_device():
        raise MXNetError("bind: an array on %s, the executor on %s"
                         % (value.context, ctx))
    return value


class Executor:
    """A bound computation: one Symbol and its argument, gradient and aux
    NDArrays on one context."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None):
        _check_mirror_pins()
        self._symbol = symbol
        self._ctx = Context(ctx) if ctx is not None else None
        if group2ctx and any(Context(c) != self._ctx
                             for c in group2ctx.values()):
            raise _later("group2ctx over more than one device "
                         "(model-parallel placement)", "ROADMAP queue 5")
        self._group2ctx = dict(group2ctx or {})
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.arg_arrays = [_as_nd(a, self._ctx) for a in
                           _as_list(args, self._arg_names, "args")]
        # a dict args_grad may omit names: those get no gradient, as in
        # the reference's bind (grad_req forced to null below)
        grads = _as_list(args_grad, self._arg_names, "args_grad",
                         allow_missing=isinstance(args_grad, dict))
        self.grad_arrays = None if grads is None else \
            [_as_nd(g, self._ctx) for g in grads]
        self.aux_arrays = [_as_nd(a, self._ctx) for a in (_as_list(
            aux_states, self._aux_names, "aux_states") or [])]
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, dict):
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self._arg_names}
        else:
            self._grad_req = dict(zip(self._arg_names, grad_req))
        bad = {r for r in self._grad_req.values()
               if r not in ("write", "add", "null")}
        if bad:
            raise MXNetError("grad_req must be write, add or null, got %s"
                             % sorted(bad))
        if self.grad_arrays is not None:
            for n, g in zip(self._arg_names, self.grad_arrays):
                if g is None:
                    self._grad_req[n] = "null"
        self._fn = _build_graph_fn(symbol)
        self._base_key = _random.next_key()
        self._step = 0
        self._pending = None  # (leaves, versions, aux read, outputs, rng)
        self._outputs = None
        self._monitor_cb = None
        self._monitor_mode = "eager"
        self._monitor_stat_fn = None
        self._monitor_active_fn = None
        self._step_stat_fn = None
        self._stats_acc = None

    # -- dict views (python/mxnet/executor.py) -----------------------------
    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        if self.grad_arrays is None:
            return {}
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def outputs(self):
        """The outputs of the latest forward."""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs

    def set_monitor_callback(self, callback, mode="eager", stat_fn=None,
                             active_fn=None):
        """Report every internal entry of each later forward.

        ``mode='eager'`` (the reference's): ``callback(name, NDArray)``.
        ``mode='ingraph'``: ``stat_fn`` (tensor -> 0-d tensor; default
        |x|.sum()/size in float32) runs on each entry on its device in
        the forward's walk, and ``callback(name, value)`` gets each
        value as a 0-d float32 tensor of one stacked bundle, nothing
        fetched; a forward for which ``active_fn()`` is False computes
        no statistic."""
        if mode not in ("eager", "ingraph"):
            raise MXNetError("monitor mode must be 'eager' or 'ingraph', "
                             "got %r" % (mode,))
        self._monitor_cb = callback
        self._monitor_mode = mode
        self._monitor_stat_fn = stat_fn
        self._monitor_active_fn = active_fn

    def set_step_stat_fn(self, fn, n_stats=0):
        """Install (or clear, ``fn=None``) ``fn(outputs, args) -> (n_stats,)
        float32 tensor``, taken in every later `backward` that has no
        ``out_grads`` from the step's outputs and argument tensors and
        added to a carry on the device (the metric's statistics,
        ``MXNET_METRIC_INTERVAL`` > 1)."""
        self._step_stat_fn = fn
        self._stats_acc = None

    def pop_step_stats(self):
        """The carry on the device (the caller fetches it), reset; None
        when nothing was added since the last pop."""
        acc, self._stats_acc = self._stats_acc, None
        return acc

    # -- execution ---------------------------------------------------------
    def _run(self, rng, is_train, aux=None, on_entry=None):
        """One forward from the bound arguments and ``aux`` (default: the
        bound aux states): (leaves, aux read, outputs), the leaves the
        tensors whose gradients `backward` takes."""
        want = self.grad_arrays is not None and is_train
        args = []
        for n, nd in zip(self._arg_names, self.arg_arrays):
            t = nd.data
            if want and self._grad_req[n] != "null" and \
                    t.is_floating_point():
                t = t.detach().requires_grad_()
            args.append(t)
        # a training step updates the aux arrays in place below, so the
        # graph reads copies (an op may keep its aux input for backward)
        if aux is None:
            aux = [a.data.clone() if is_train else a.data
                   for a in self.aux_arrays]
        with torch.set_grad_enabled(want):
            outs, new_aux = self._fn(args, aux, rng, is_train, on_entry)
        if is_train:
            for nd, a in zip(self.aux_arrays, new_aux):
                nd.data.copy_(a.detach())
        return args, aux, outs

    def forward(self, is_train=False, **kwargs):
        """Run forward; ``kwargs`` copy new values into the bound
        arguments by name first."""
        for k, v in kwargs.items():
            if k not in self._arg_names:
                raise MXNetError("forward: unknown argument %r" % k)
            dst = self.arg_arrays[self._arg_names.index(k)]
            if isinstance(v, NDArray):
                v.copyto(dst)
            else:
                dst[:] = v
        self._step += 1
        rng = _random.fold_in(self._base_key, self._step)
        on_entry = None
        names, stats = [], []
        if self._monitor_cb is not None and self._monitor_mode == "eager":
            # every internal entry (`graph_executor.cc:835-849`'s per-op
            # callback), reported from this forward's own walk
            def on_entry(name, t):
                self._monitor_cb(name, NDArray(t.detach(), self._ctx))
        elif self._monitor_cb is not None and (
                self._monitor_active_fn is None
                or self._monitor_active_fn()):
            stat = self._monitor_stat_fn or _asum

            def on_entry(name, t):
                names.append(name)
                stats.append(torch.as_tensor(
                    stat(t.detach()), dtype=torch.float32,
                    device=t.device).reshape(()))
        if not (is_train and self.grad_arrays is not None):
            # a training forward is watched as the step, in backward
            self._watch_retrace("executor.forward%s[%s]" % (
                "_monitored" if on_entry is not None else "",
                "train" if is_train else "eval"))
        leaves, aux, outs = self._run(rng, is_train, on_entry=on_entry)
        if names:
            for name, value in zip(names, torch.stack(stats)):
                self._monitor_cb(name, value)
        self._pending = None
        if is_train and self.grad_arrays is not None:
            self._pending = (leaves, [t._version for t in leaves], aux,
                             outs, rng)
        self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward's outputs, against
        ones (loss heads ignore them) or ``out_grads``, into the bound
        gradient arrays by ``grad_req``."""
        if self.grad_arrays is None:
            raise MXNetError("bind with args_grad to use backward()")
        if self._pending is None:
            raise MXNetError("call forward(is_train=True) before backward()")
        leaves, versions, aux, outs, rng = self._pending
        if any(t._version != v for t, v in zip(leaves, versions)):
            # an argument was written since forward (an update between
            # forward and backward): recompute at its new value from the
            # aux states that forward read, whose update replaces the
            # first one, as the JAX package replays its pending forward
            leaves, _, outs = self._run(rng, True, aux=aux)
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [(g.data if isinstance(g, NDArray) else
                     torch.as_tensor(g)).to(o.device, o.dtype)
                    for g, o in zip(out_grads, outs)]
        with_stats = self._step_stat_fn is not None and out_grads is None
        self._watch_retrace(
            "executor.train_step", cots,
            program=("donate" if out_grads is None else "keep")
            + ("+stats" if with_stats else ""))
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        wrt = [i for i, t in enumerate(leaves) if t.requires_grad]
        grads = [None] * len(wrt)
        if pairs and wrt:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[i] for i in wrt],
                [c for _, c in pairs], allow_unused=True)
        got = dict(zip(wrt, grads))
        if with_stats:
            with torch.no_grad():
                step = self._step_stat_fn([o.detach() for o in outs],
                                          [t.detach() for t in leaves])
                step = step.to(torch.float32)
                self._stats_acc = step if self._stats_acc is None \
                    else self._stats_acc + step
        self._pending = None
        self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        for i, (name, nd) in enumerate(zip(self._arg_names,
                                           self.grad_arrays)):
            req = self._grad_req.get(name, "write")
            if req == "null" or nd is None:
                continue
            g = got.get(i)
            if req == "add":
                if g is not None:
                    nd.data.add_(g)
            elif g is None:
                nd.data.zero_()
            else:
                nd.data.copy_(g)

    def _watch_retrace(self, site, cots=None, program=None):
        """Feed the retrace watch one call's signature (the bound
        arguments, aux states and head gradients), scoped by the Symbol:
        a change of shape or dtype fires where the JAX executor
        recompiles (a ragged batch, a rebind)."""
        if not telemetry.retrace_enabled():
            return
        sig = telemetry.arrays_signature(
            [a.data for a in self.arg_arrays], self._arg_names)
        sig += telemetry.arrays_signature(
            [a.data for a in self.aux_arrays],
            ["aux:%s" % n for n in self._aux_names])
        if cots is not None:
            sig += telemetry.arrays_signature(
                cots, ["cot%d" % i for i in range(len(cots))])
        telemetry.watch_jit(site, sig,
                            scope=telemetry.watch_scope(self._symbol),
                            meta={"program": program} if program else None)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameters in by name (`executor.py` copy_params_from)."""
        for what, names, arrays, params in (
                ("argument", self._arg_names, self.arg_arrays, arg_params),
                ("aux state", self._aux_names, self.aux_arrays,
                 aux_params or {})):
            for name, array in params.items():
                if name not in names:
                    if not allow_extra_params:
                        raise MXNetError("unknown %s %r" % (what, name))
                    continue
                dst = arrays[names.index(name)]
                if tuple(array.shape) != dst.shape:
                    raise MXNetError("copyto shape mismatch %s vs %s"
                                     % (tuple(array.shape), dst.shape))
                dst[:] = array

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound to the shapes inferred from ``kwargs``,
        with new arrays of the same dtypes (the reference rebinds sharing
        memory, `graph_executor.h:48-55`)."""
        from .ndarray import zeros

        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("reshape: cannot infer new shapes")
        new_args = [zeros(s, ctx=self._ctx, dtype=a.dtype)
                    for s, a in zip(arg_shapes, self.arg_arrays)]
        new_grads = None
        if self.grad_arrays is not None:
            new_grads = [zeros(s, ctx=self._ctx, dtype=a.dtype)
                         if g is not None else None
                         for s, a, g in zip(arg_shapes, self.arg_arrays,
                                            self.grad_arrays)]
        new_aux = [zeros(s, ctx=self._ctx, dtype=x.dtype)
                   for s, x in zip(aux_shapes, self.aux_arrays)]
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, new_aux, group2ctx=self._group2ctx)
