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

Rematerialization (the reference's mirroring plan, `static_graph.cc:
410-560`) is read from the JAX package's pins when a graph function is
built, at bind: ``MXNET_BACKWARD_MIRROR_POLICY`` (``dots``, ``attn``,
``streams``, ``nothing``, ``none``; ``MXNET_BACKWARD_DO_MIRROR=1`` alone
means ``dots``) picks what a training step keeps (`_mirror_policy`), and
``MXNET_BACKWARD_MIRROR_STEP`` (``k`` or ``block``) cuts the walk into
segments recomputed in the backward (`_mirror_segments`, with the nodes'
``force_mirroring`` attributes).  Both run as PyTorch's selective
checkpointing (`remat`): each region is one `torch.utils.checkpoint`
call.  The JAX package wraps its whole step in one `jax.checkpoint`;
PyTorch's non-reentrant checkpoint recomputes a region whole at its
first use in the backward, so one region over the whole graph would hold
every activation again at once.  So a policy runs over the segments of
``MIRROR_STEP`` where that pin is set, else over about sqrt(N) runs of
the walk's N op nodes, each cut where the fewest entries cross it
(`_sqrt_runs`, the plan of Chen et al.'s sublinear-memory training): the
step then holds the runs' boundaries and one run's recompute at a time,
whatever the nodes are called.  With both pins set, each segment runs
under the policy; the JAX package instead nests segments that keep
nothing inside its whole-step checkpoint under the policy, so what is
kept differs from it there (the gradients do not).  Outputs and
gradients are those of the plain walk, bit for bit: the regions change
when values are computed, never what.

Refused with an error, never accepted and ignored: ``group2ctx`` over
more than one device, and the AOT cache.
"""
from __future__ import annotations

import math
import os
import re

import torch

from . import random as _random
from . import remat
from . import telemetry
from .base import MXNetError
from .context import Context
from .ndarray import NDArray
from .ops.registry import OpCtx
from .symbol import _topo_order

__all__ = ["_build_graph_fn", "Executor", "AotCache"]


def _layer_groups(order):
    """The op nodes of ``order`` in runs that share a ``layer<k>_`` name
    prefix (None outside any): [(tag, [nodes])], in topological order."""
    groups = []
    for node in order:
        if node.is_variable:
            continue
        m = re.match(r"(layer\d+)_", node.name or "")
        tag = m.group(1) if m else None
        if groups and groups[-1][0] == tag:
            groups[-1][1].append(node)
        else:
            groups.append((tag, [node]))
    return groups


def _mirror_segments(order):
    """Plan the MXNET_BACKWARD_MIRROR_STEP rematerialization regions, as
    the JAX package's `_mirror_segments` does.

    The reference keeps every MIRROR_STEP-th eligible node as a checkpoint
    boundary and recomputes the nodes in between during backward
    (`static_graph.cc:423-438`): consecutive op nodes are grouped into
    segments of ``step`` ops, each recomputed in the backward from its
    inputs.  Per-node ``force_mirroring`` attributes: ``"0"``/``"False"``
    pins the node as a stored boundary; anything truthy keeps it inside a
    segment even where the step count would cut one.
    ``MXNET_BACKWARD_MIRROR_STEP=block`` segments on ``layer<k>_`` name
    prefixes instead (ops outside any stay stored boundaries; the
    attributes are ignored).

    Returns None when the pin is unset (or block mode finds no
    layer-prefixed node), else a list of (nodes, remat) runs covering the
    op nodes of ``order`` in sequence."""
    step_env = os.environ.get("MXNET_BACKWARD_MIRROR_STEP", "")
    if not step_env:
        return None
    if step_env.lower() == "block":
        groups = _layer_groups(order)
        if not any(tag is not None for tag, _ in groups):
            return None  # not a layer-structured graph: no-op
        return [(nodes, tag is not None) for tag, nodes in groups]
    step = max(int(step_env), 1)

    def boundary_attr(node):
        v = (node.attrs or {}).get("force_mirroring")
        if v is None:
            return None
        return str(v).lower() in ("0", "false")

    segments = []
    run, count = [], 0
    for node in order:
        if node.is_variable:
            # variables carry no compute: they never cut a run
            continue
        forced_boundary = boundary_attr(node)
        if forced_boundary:
            if run:
                segments.append((run, True))
                run, count = [], 0
            segments.append(([node], False))
            continue
        run.append(node)
        count += 1
        if count >= step and forced_boundary is None:
            segments.append((run, True))
            run, count = [], 0
    if run:
        segments.append((run, True))
    return segments


# MXNET_BACKWARD_MIRROR_POLICY=dots: the JAX package's `_mirror_saveable`
_mirror_saveable = remat.dots_saveable


def _mirror_policy():
    """The whole-graph rematerialization policy from the environment, as
    the JAX package's `_mirror_policy` reads it: MXNET_BACKWARD_MIRROR_POLICY
    ``dots`` (`_mirror_saveable`: keep matrix products and convolutions),
    ``attn`` (keep the outputs tagged ``attn_out``), ``streams`` (``attn_out``
    and ``act_out``) or ``nothing``; an explicit ``none`` wins over
    MXNET_BACKWARD_DO_MIRROR, which alone means ``dots``.  Returns a
    `remat` policy or None; anything else raises."""
    pol = os.environ.get("MXNET_BACKWARD_MIRROR_POLICY", "").lower()
    if pol == "none":
        return None  # explicit 'none' wins over MXNET_BACKWARD_DO_MIRROR
    if not pol:
        if os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0").lower() in (
                "1", "true", "yes"):
            pol = "dots"
        else:
            return None
    if pol == "dots":
        return _mirror_saveable
    if pol in ("attn", "attn_out"):
        return remat.save_only_these_names("attn_out")
    if pol == "streams":
        return remat.save_only_these_names("attn_out", "act_out")
    if pol == "nothing":
        return remat.nothing_saveable
    raise MXNetError(
        "MXNET_BACKWARD_MIRROR_POLICY must be one of none/dots/attn/"
        "streams/nothing, got %r" % pol)


def _sqrt_runs(order, heads):
    """The op nodes of ``order`` in about sqrt(N) runs for a whole-graph
    policy: each run takes at least ceil(sqrt(N)) nodes, then ends at the
    first place among the next as many where the fewest entries made so
    far are read later (the heads, kept as outputs anyway, not counted).
    Those entries are what the step stores between runs, so a chain of
    layers is cut where one activation crosses.  Depends on the graph's
    edges alone, not on its node names."""
    ops = [n for n in order if not n.is_variable]
    n = len(ops)
    at = {id(node): i for i, node in enumerate(ops)}
    head_keys = {(id(s), i) for s, i in heads}
    last = {}  # entry -> position of the last op reading it
    for i, node in enumerate(ops):
        for s, j in node.inputs:
            if id(s) in at:
                last[(id(s), j)] = i
    # live[i]: entries made at or before ops[i] and read after it
    live, alive = [], set()
    for i, node in enumerate(ops):
        alive |= {(id(node), j)
                  for j in range(len(node.op.list_outputs(node.params)))
                  if last.get((id(node), j), -1) > i
                  and (id(node), j) not in head_keys}
        alive = {k for k in alive if last[k] > i}
        live.append(len(alive))
    size = math.isqrt(n - 1) + 1 if n else 1  # ceil(sqrt(n))
    runs, start = [], 0
    while start < n:
        lo, hi = start + size - 1, min(start + 2 * size - 1, n - 1)
        if lo >= n - 1:
            runs.append(ops[start:])
            break
        cut = min(range(lo, hi), key=lambda i: (live[i], i))
        runs.append(ops[start:cut + 1])
        start = cut + 1
    return runs


def _remat_runs(order, heads, policy):
    """The regions of a training walk: [(nodes, region policy or None)],
    None for nodes that run plainly; None when nothing is recomputed.
    The MIRROR_STEP segments where that pin is set (a stored boundary runs
    under ``policy`` if there is one, plainly if not; a segment under
    ``policy`` or, without one, keeping nothing); else, with a policy,
    `_sqrt_runs` (see the module's note)."""
    segments = _mirror_segments(order)
    if segments is not None:
        return [(nodes, policy if policy is not None else
                 (remat.nothing_saveable if keep else None))
                for nodes, keep in segments]
    if policy is None:
        return None
    return [(nodes, policy) for nodes in _sqrt_runs(order, heads)]


def _build_graph_fn(symbol, mirror_policy=None):
    """fn(arg_tensors, aux_tensors, rng, is_train, on_entry=None) ->
    (outputs, new_aux) for ``symbol``; arguments in `list_arguments`
    order, aux states in `list_auxiliary_states` order.  ``on_entry``,
    if given, is called with each variable's name and tensor and each
    op output's ``<node>_<output>`` name and tensor, in walk order.

    ``mirror_policy`` (`_mirror_policy`) and MXNET_BACKWARD_MIRROR_STEP,
    read here, make a training walk with autograd on run in remat regions
    (`_remat_runs`); a walk with ``on_entry`` (a monitored one) runs
    plainly, as the JAX package's monitor walk does."""
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

    def run_node(node, env, new_aux, rng, is_train, device, on_entry=None):
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

    def plain(arg_arrays, aux_arrays, rng, is_train, on_entry=None):
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
            run_node(node, env, new_aux, rng, is_train, device, on_entry)
        outputs = tuple(env[(id(n), i)] for n, i in heads)
        return outputs, tuple(new_aux)

    runs = _remat_runs(order, heads, mirror_policy)
    if runs is None:
        return plain

    # each region's inputs (entries made before it) and outputs (entries
    # read after it, or heads): its boundary, stored across the step
    plans, needed = [], {(id(n), i) for n, i in heads}
    for nodes, policy in reversed(runs):
        in_keys, local = [], set()
        for node in nodes:
            for s_, i in node.inputs:
                key = (id(s_), i)
                if key not in local and key not in in_keys:
                    in_keys.append(key)
            for i in range(len(node.op.list_outputs(node.params))):
                local.add((id(node), i))
        plans.append((nodes, policy, in_keys,
                      sorted(k for k in local if k in needed)))
        needed |= set(in_keys)
    plans.reverse()

    def segmented(arg_arrays, aux_arrays, rng, is_train):
        env = {(id(node), 0): arg_arrays[arg_index[node.name]]
               for node in order if node.is_variable}
        new_aux = list(aux_arrays)
        device = arg_arrays[0].device if arg_arrays else None
        for nodes, policy, in_keys, out_keys in plans:
            if policy is None:
                for node in nodes:
                    run_node(node, env, new_aux, rng, is_train, device)
                continue
            ranges = [aux_slots[id(n)] for n in nodes if id(n) in aux_slots]

            def region(*vals, nodes=nodes, in_keys=in_keys,
                       out_keys=out_keys, ranges=ranges):
                # its own env and aux slots: a recompute in the backward
                # writes nothing the step has kept (BatchNorm's moving
                # statistics take the forward's update alone)
                local_env = dict(zip(in_keys, vals))
                local_aux = [None] * len(new_aux)
                at = len(in_keys)
                for lo, hi in ranges:
                    local_aux[lo:hi] = vals[at:at + hi - lo]
                    at += hi - lo
                for node in nodes:
                    run_node(node, local_env, local_aux, rng, is_train,
                             device)
                return tuple(local_env[k] for k in out_keys) + tuple(
                    a for lo, hi in ranges for a in local_aux[lo:hi])

            outs = remat.run_region(
                region, policy, *(env[k] for k in in_keys),
                *(a for lo, hi in ranges for a in new_aux[lo:hi]))
            env.update(zip(out_keys, outs))
            at = len(out_keys)
            for lo, hi in ranges:
                new_aux[lo:hi] = outs[at:at + hi - lo]
                at += hi - lo
        outputs = tuple(env[(id(n), i)] for n, i in heads)
        return outputs, tuple(new_aux)

    def fn(arg_arrays, aux_arrays, rng, is_train, on_entry=None):
        if on_entry is not None or not is_train or \
                not torch.is_grad_enabled():
            return plain(arg_arrays, aux_arrays, rng, is_train, on_entry)
        return segmented(arg_arrays, aux_arrays, rng, is_train)

    return fn


def _later(what, where="ROADMAP queue 1"):
    return MXNetError("%s is not ported yet (%s)" % (what, where))


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
        # read at bind, as the JAX executor reads it
        self._mirror_policy = _mirror_policy()
        self._symbol = symbol
        self._ctx = Context(ctx) if ctx is not None else None
        if group2ctx and any(Context(c) != self._ctx
                             for c in group2ctx.values()):
            raise _later("group2ctx over more than one device "
                         "(model-parallel placement)",
                         "ROADMAP.md queue 1, item 3")
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
        self._fn = _build_graph_fn(symbol, self._mirror_policy)
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
