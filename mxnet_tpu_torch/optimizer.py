"""Optimizers of the port.

A port of `mxnet_tpu/optimizer.py` (the reference's
`python/mxnet/optimizer.py`): the registry, `Optimizer` with the lr/wd
multipliers, `rescale_grad`, `clip_gradient`, an `lr_scheduler` and the
update counts, and SGD (momentum), ccSGD, SGLD, Adam, AdaGrad, RMSProp,
AdaDelta and Test, with `get_updater` and `get_fused_updater` for the
KVStore and the training loops.

Each optimizer's arithmetic is written once, over lists of tensors with
`torch._foreach_*` ops, in the JAX package's order of operations.
`update` runs it on one parameter; `update_multi` on the whole list in
one pass of each op, in place on the weights and the state (the JAX
package's one jitted program with donated buffers).  The host-side
scalars (lr, wd and their multipliers, Adam's bias-corrected ``lr_t``)
are computed the same way in both, so both forms give the same numbers;
``MXNET_FUSED_UPDATE=0`` sends the fused updater's list calls through
`update` one parameter at a time.

Random draws take the next key of `random` per parameter update, in call
order: SGLD's noise (``jax.random.normal``'s construction; torch's
`erfinv` agrees with XLA's to float32 rounding) and Adam's bfloat16
second moment (``v_dtype='bfloat16'``), stored through
`stochastic_round_bf16` bit for bit as the JAX package stores it.

``MXNET_NONFINITE_GUARD=1`` skips, on the device, an `update_multi` call
(one bucket) whose gradients hold a NaN or Inf anywhere: the bucket's
nonfinite count is a device tensor computed before anything is written,
the update is computed into new tensors, and each weight and state takes
``torch.where(bad, old, new)``.  Nothing is read on the host, so the
guard adds no sync.  The skip reaches the host through the staged health
moments (``telemetry.health``), where the loops count it and may back
the lr off (``MXNET_NONFINITE_BACKOFF``).  Under the guard, Adam's
bias-correction count is a float32 device counter a bucket that advances
only on applied steps (``_guard_counts``, checkpointed), so a run with k
skipped steps equals, bit for bit, a run where they never happened; the
host counts still advance.  ``MXNET_TELEMETRY_HEALTH=1`` stages the same
moments without the guard.  ``MXNET_CHAOS=nan_grad:N`` poisons the N-th
call's gradients (`chaos.grad_poison`).  Without either pin the update
runs in place exactly as before.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import chaos
from . import random as _random
from . import telemetry
from .base import MXNetError, torch_dtype
from .ndarray import zeros
from .random import random_bits

__all__ = ["Optimizer", "SGD", "SGLD", "ccSGD", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Test", "create", "get_updater", "get_fused_updater",
           "fused_update_enabled", "nonfinite_guard_enabled", "register",
           "stochastic_round_bf16"]


def fused_update_enabled():
    """The MXNET_FUSED_UPDATE switch (default on), read at every call."""
    return os.environ.get("MXNET_FUSED_UPDATE", "1").lower() not in (
        "0", "false", "no")


def nonfinite_guard_enabled():
    """MXNET_NONFINITE_GUARD=1: `update_multi` leaves every weight and
    state of a bucket unchanged when any of its gradient elements is NaN
    or Inf, decided on the device.  The guard rides the fused path only:
    under MXNET_FUSED_UPDATE=0 per-key updates are not guarded."""
    return os.environ.get("MXNET_NONFINITE_GUARD", "0").lower() in (
        "1", "true", "yes")


def stochastic_round_bf16(x, key):
    """Stochastically round float32 ``x`` to bfloat16, bit for bit as the
    JAX package does with the same key.

    With beta2 = 0.999 the per-step relative change of Adam's second
    moment (~1e-3) sits below bf16's ~2**-8 ulp, so round-to-nearest
    would stall the average.  Adding 16 uniform random bits below the bf16
    mantissa before truncating makes the rounding unbiased.  The bits are
    the low 16 of `random.random_bits` (``jax.random.bits`` in uint16 is
    the low half of its uint32 words at the same positions).

    ``key`` is a key of `random`; its words may be int64 tensors of shape
    (b, 1), and then ``x`` is (b, ...) and row i is rounded with key i.
    """
    batched = isinstance(key[0], torch.Tensor) and key[0].dim() == 2
    shape = tuple(x.shape[1:]) if batched else tuple(x.shape)
    rnd = random_bits(key, shape, x.device) & 0xFFFF
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    hi = (bits + rnd) & 0xFFFF0000
    # back to the int32 bit pattern (two's complement) of the float32
    hi = torch.where(hi >= 2 ** 31, hi - 2 ** 32, hi).to(torch.int32)
    return hi.view(torch.float32).to(torch.bfloat16)


def _tensors(state):
    """An optimizer state (None, an NDArray or a tuple of them) as a list
    of its tensors."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [s.data for s in state]
    return [state.data]


class Optimizer:
    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, rescale_grad=1.0, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError("unknown optimizer %r" % name)
        return Optimizer.opt_registry[name.lower()](
            rescale_grad=rescale_grad, **kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 arg_names=None, sym=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult = {}
        self.wd_mult = {}
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def __getstate__(self):
        """Pickle without the Symbol: its multipliers are already in the
        dicts it seeded."""
        state = self.__dict__.copy()
        state["sym"] = None
        return state

    # -- multipliers (optimizer.py:124-170) -------------------------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            for name, a in self.sym.attr_dict().items():
                if "__lr_mult__" in a:
                    self.lr_mult[name] = float(a["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight decay applies to ``*weight``/``*gamma`` parameters only,
        unless a multiplier says otherwise."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not n.endswith(("weight", "gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            for name, a in self.sym.attr_dict().items():
                if "__wd_mult__" in a:
                    self.wd_mult[name] = float(a["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def create_state(self, index, weight):
        raise NotImplementedError()

    # -- the update -------------------------------------------------------
    def _step_scalars(self, index):
        """Host-side scalars of one update, resolved as the reference's
        update() resolves them: the multipliers against the count before
        this update, then the count bump."""
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        return (lr, wd)

    def _needs_key(self):
        """Whether `_apply` draws random numbers (one key a parameter)."""
        return False

    def _grads(self, gs):
        """rescale_grad, then clip_gradient, on copies of the gradients."""
        g = torch._foreach_mul(gs, self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        return g

    def _apply(self, ws, gs, states, scalars, keys):
        """Update the weight tensors ``ws`` and the state tensors
        ``states`` (one list of tensors a parameter) in place, from the
        gradient tensors ``gs``; ``scalars`` holds one row of
        `_step_scalars` a parameter, ``keys`` one key a parameter or
        None."""
        raise NotImplementedError()

    def update(self, index, weight, grad, state):
        """Update one parameter (NDArrays ``weight``, ``grad``; ``state``
        from `create_state`) in place."""
        scalars = [self._step_scalars(index)]
        keys = [_random.next_key()] if self._needs_key() else None
        self._apply([weight.data], [grad.data], [_tensors(state)], scalars,
                    keys)

    # -- the device step counter of guarded count-dependent optimizers --
    # (the JAX package's `_counts_in_graph` protocol)
    def _counts_in_graph(self):
        """Whether the guard carries a device step counter (optimizers
        whose scalars depend on the update count)."""
        return False

    def _step_scalars_base(self, index):
        """The count-independent scalars of the counter path; bumps the
        host counts like `_step_scalars`."""
        return self._step_scalars(index)

    def _traced_step_scalars(self, scalars, t):
        """Fold the float32 device counts ``t`` (one a parameter) into
        the scalar rows, on the device.  Default: count-independent."""
        return scalars

    def update_multi(self, indices, weights, grads, states, donate=True):
        """Update many parameters in one pass of each ``torch._foreach_*``
        op: the same numbers as `update` over the lists in order, its
        counts and schedules included.  ``donate`` is accepted for the
        JAX package's callers; the update is in place either way.  Under
        ``MXNET_NONFINITE_GUARD`` or ``MXNET_TELEMETRY_HEALTH`` see the
        module's docstring."""
        indices = list(indices)
        if not indices:
            return
        guard = nonfinite_guard_enabled()
        health = telemetry.health_enabled() or guard
        tcount = guard and self._counts_in_graph()
        scalars, keys = [], []
        for i in indices:
            scalars.append(self._step_scalars_base(i) if tcount
                           else self._step_scalars(i))
            keys.append(_random.next_key() if self._needs_key() else None)
        ws = [w.data for w in weights]
        gs = [g.data for g in grads]
        ss = [_tensors(s) for s in states]
        keys = keys if self._needs_key() else None
        if chaos.enabled():
            # MXNET_CHAOS=nan_grad:N: this call's gradients poisoned, so
            # the guard is testable end to end
            poison = chaos.grad_poison()
            if poison is not None:
                gs = [torch.full_like(g, poison) for g in gs]
        self._watch_retrace(ws, weights[0].context, health, guard, tcount)
        if not health:
            self._apply(ws, gs, ss, scalars, keys)
            return
        # the bucket's nonfinite count, before anything is written
        nonfinite = torch.sum(~torch.isfinite(torch.cat(
            [g.reshape(-1) for g in gs])))
        bad = nonfinite > 0
        if tcount:
            scalars = self._traced_step_scalars(
                scalars, self._guard_count(indices, bad, ws[0].device))
        if guard:
            # the update into new tensors: the old ones stay for the where
            old_ws, new_ws = ws, _copies(ws)
            flat = _copies([t for s in ss for t in s])
            new_ss = [[flat.pop(0) for _ in s] for s in ss]
        else:
            old_ws, new_ws, new_ss = _copies(ws), ws, ss
        self._apply(new_ws, gs, new_ss, scalars, keys)
        upd_sq = _sq_sum(torch._foreach_sub(
            [n.float() for n in new_ws], [o.float() for o in old_ws]))
        if guard:
            upd_sq = torch.where(bad, torch.zeros_like(upd_sq), upd_sq)
        moments = torch.stack([_sq_sum(gs), upd_sq, _sq_sum(old_ws),
                               nonfinite.float()])
        if guard:
            for o, n in zip(ws + [t for s in ss for t in s],
                            new_ws + [t for s in new_ss for t in s]):
                torch.where(bad, o, n, out=o)
        telemetry.stage_health(
            ("grad_sq", "update_sq", "param_sq", "nonfinite"), moments)

    def _guard_count(self, indices, bad, device):
        """The bucket's applied-step counts after this call, (n,) float32
        on ``device``: the carried counter (from the host counts as they
        stood before this call's bump, the first time), plus one unless
        the bucket is skipped."""
        counts_map = getattr(self, "_guard_counts", None)
        if counts_map is None:
            counts_map = self._guard_counts = {}
        ckey = tuple(indices)
        tc = counts_map.get(ckey)
        if tc is None:
            tc = [self._index_update_count.get(i, 0) - 1 for i in indices]
        if not isinstance(tc, torch.Tensor) or tc.device != device:
            # a host copy (first use, a restored checkpoint): one
            # asynchronous copy, no sync
            tc = torch.as_tensor(np.asarray(
                tc.cpu() if isinstance(tc, torch.Tensor) else tc,
                np.float32)).to(device, non_blocking=True)
        t_new = tc + (~bad).float()
        counts_map[ckey] = t_new
        return t_new

    def _watch_retrace(self, ws, ctx, health, guard, tcount):
        """The retrace watch over the fused update: a changed bucket
        shape profile, device context or a mutated hyperparameter fires
        one diagnosed event where the JAX package recompiles its update
        program."""
        if not telemetry.retrace_enabled():
            return
        sig = telemetry.arrays_signature(
            ws, ["w%d" % i for i in range(len(ws))])
        meta = {"donate": True, "health": bool(health),
                "guard": bool(guard), "tcount": bool(tcount),
                "device": str(ctx)}
        for k, v in self._trace_key():
            meta["hp:%s" % k] = telemetry._dtype_name(v)
        telemetry.watch_jit("optimizer.update_multi", sig,
                            scope=telemetry.watch_scope(self), meta=meta)

    # recomputed on the host every call, or mutated every step
    _UNTRACED_ATTRS = frozenset(("lr", "wd", "num_update", "sym",
                                 "lr_scheduler"))

    def _trace_key(self):
        """The hyperparameters the JAX package's update program bakes in
        (its jit-cache key): the scalar attributes other than the
        schedule's moving parts."""
        items = []
        for k, v in sorted(self.__dict__.items()):
            if k in self._UNTRACED_ATTRS or k.startswith("_"):
                continue
            if isinstance(v, (int, float, bool, str, bytes, type(None))) \
                    or isinstance(v, torch.dtype):
                items.append((k, v))
        return tuple(items)


def _copies(ts):
    """New tensors with the values of ``ts``, in one multi-tensor copy."""
    out = [torch.empty_like(t) for t in ts]
    if out:
        torch._foreach_copy_(out, ts)
    return out


def _sq_sum(ts):
    """The float32 sum of squares over every element of ``ts``, from one
    multi-tensor norm a tensor."""
    norms = torch._foreach_norm([t.float() for t in ts])
    return torch.stack(norms).square().sum()


def _col(scalars, j):
    """Column j of the per-parameter scalar rows, as a list."""
    return [float(row[j]) for row in scalars]


def _decayed(gs, ws, wds):
    """g + wd * w for every parameter, in new tensors."""
    out = torch._foreach_mul(ws, wds)
    torch._foreach_add_(out, gs)
    return out


@Optimizer.register
class SGD(Optimizer):
    """SGD with momentum and weight decay (`optimizer.py:231`,
    `sgd-inl.h:21-40`): mom = momentum * mom - lr * (g + wd * w);
    w += mom."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def _apply(self, ws, gs, states, scalars, keys):
        step = _decayed(self._grads(gs), ws, _col(scalars, 1))
        torch._foreach_mul_(step, _col(scalars, 0))
        if states[0]:
            moms = [s[0] for s in states]
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, step)
            torch._foreach_add_(ws, moms)
        else:
            torch._foreach_sub_(ws, step)


class ccSGD(SGD):
    """Alias of SGD (the reference's C++-fused variant)."""


Optimizer.opt_registry["ccsgd"] = ccSGD


@Optimizer.register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (`optimizer.py` SGLD):
    w - lr/2 * (g + wd * w) + sqrt(lr) * N(0, 1)."""

    def create_state(self, index, weight):
        return None

    def _needs_key(self):
        return True

    def _step_scalars(self, index):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        return (lr / 2, wd, math.sqrt(lr))

    def _apply(self, ws, gs, states, scalars, keys):
        step = _decayed(self._grads(gs), ws, _col(scalars, 1))
        torch._foreach_mul_(step, _col(scalars, 0))
        torch._foreach_sub_(ws, step)
        noise = [_random.normal_from_key(k, tuple(w.shape), w.device).to(
            w.dtype) for k, w in zip(keys, ws)]
        torch._foreach_mul_(noise, _col(scalars, 2))
        torch._foreach_add_(ws, noise)


@Optimizer.register
class Adam(Optimizer):
    """Adam (`optimizer.py` Adam; Kingma & Ba), weight decay folded into
    the gradient, bias correction in ``lr_t``.

    ``v_dtype='bfloat16'`` stores the second moment in bfloat16: the
    moment math runs in float32 and the stored table is rounded with
    `stochastic_round_bf16` and the update's key."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, decay_factor=(1 - 1e-8), v_dtype="float32",
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.decay_factor = decay_factor
        self.v_dtype = torch_dtype(v_dtype)
        if self.v_dtype not in (torch.float32, torch.bfloat16):
            raise MXNetError("Adam: v_dtype must be float32 or bfloat16, "
                             "got %r" % (v_dtype,))

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=self.v_dtype))

    def _needs_key(self):
        return self.v_dtype == torch.bfloat16

    def _step_scalars(self, index):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        # bias correction in host float64, as the reference computes it
        coef1 = 1 - self.beta1 ** t
        coef2 = 1 - self.beta2 ** t
        return (lr * math.sqrt(coef2) / coef1, wd)

    # Under MXNET_NONFINITE_GUARD the bias-correction count is the
    # bucket's device counter, which skipped steps do not advance; the
    # fold runs in float32 on the device (the host path's in float64), so
    # guarded Adam is within a few ulp of unguarded Adam.
    def _counts_in_graph(self):
        return True

    def _step_scalars_base(self, index):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)  # the host counts: checkpoints, schedules
        return (lr, wd)

    def _traced_step_scalars(self, scalars, t):
        # lr * sqrt(1 - b2**t) / (1 - b1**t) in float32, lr rounded to
        # float32 first, as the JAX package's traced fold
        coef1 = 1 - torch.pow(self.beta1, t)
        lr_t = torch._foreach_mul(
            list(torch.sqrt(1 - torch.pow(self.beta2, t)).unbind()),
            [float(row[0]) for row in scalars])
        torch._foreach_div_(lr_t, list(coef1.unbind()))
        return [(lr, row[1]) for lr, row in zip(lr_t, scalars)]

    def _apply(self, ws, gs, states, scalars, keys):
        b1, b2 = self.beta1, self.beta2
        g = _decayed(self._grads(gs), ws, _col(scalars, 1))
        m = [s[0] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        bf16 = self.v_dtype == torch.bfloat16
        v = [s[1].float() for s in states] if bf16 else [s[1] for s in states]
        torch._foreach_mul_(v, b2)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_add_(v, g2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.epsilon)
        lr_t = [row[0] for row in scalars]
        step = torch._foreach_mul(m, lr_t if isinstance(
            lr_t[0], torch.Tensor) else _col(scalars, 0))
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(ws, step)
        if bf16:
            for s, v32, k in zip(states, v, keys):
                s[1].copy_(stochastic_round_bf16(v32, k))


@Optimizer.register
class AdaGrad(Optimizer):
    """AdaGrad (`optimizer.py` AdaGrad):
    hist += g^2; w -= lr * (g / sqrt(hist + eps) + wd * w)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def _apply(self, ws, gs, states, scalars, keys):
        g = self._grads(gs)
        hist = [s[0] for s in states]
        torch._foreach_add_(hist, torch._foreach_mul(g, g))
        den = torch._foreach_add(hist, self.float_stable_eps)
        torch._foreach_sqrt_(den)
        step = torch._foreach_div(g, den)
        torch._foreach_add_(step, torch._foreach_mul(ws, _col(scalars, 1)))
        torch._foreach_mul_(step, _col(scalars, 0))
        torch._foreach_sub_(ws, step)


@Optimizer.register
class RMSProp(Optimizer):
    """RMSProp (`optimizer.py` RMSProp; Tieleman & Hinton with the
    gradient-mean subtraction, as in the reference)."""

    def __init__(self, learning_rate=0.002, gamma1=0.95, gamma2=0.9,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2

    def create_state(self, index, weight):
        return tuple(zeros(weight.shape, weight.context, dtype=weight.dtype)
                     for _ in range(3))  # n, g, delta

    def _apply(self, ws, gs, states, scalars, keys):
        g1, g2 = self.gamma1, self.gamma2
        g = _decayed(self._grads(gs), ws, _col(scalars, 1))
        n = [s[0] for s in states]
        gbar = [s[1] for s in states]
        delta = [s[2] for s in states]
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - g1)
        torch._foreach_mul_(n, g1)
        torch._foreach_add_(n, sq)
        torch._foreach_mul_(gbar, g1)
        torch._foreach_add_(gbar, torch._foreach_mul(g, 1 - g1))
        den = torch._foreach_sub(n, torch._foreach_mul(gbar, gbar))
        torch._foreach_add_(den, 1e-4)
        torch._foreach_sqrt_(den)
        step = torch._foreach_div(g, den)
        torch._foreach_mul_(step, _col(scalars, 0))
        torch._foreach_mul_(delta, g2)
        torch._foreach_sub_(delta, step)
        torch._foreach_add_(ws, delta)


@Optimizer.register
class AdaDelta(Optimizer):
    """AdaDelta (`optimizer.py` AdaDelta); no learning rate, as in the
    reference."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=weight.dtype))

    def _apply(self, ws, gs, states, scalars, keys):
        rho, eps = self.rho, self.epsilon
        g = self._grads(gs)
        acc_g = [s[0] for s in states]
        acc_d = [s[1] for s in states]
        torch._foreach_mul_(acc_g, rho)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - rho)
        torch._foreach_add_(acc_g, sq)
        cur = torch._foreach_add(acc_d, eps)
        torch._foreach_sqrt_(cur)
        den = torch._foreach_add(acc_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(cur, den)
        torch._foreach_mul_(cur, g)
        torch._foreach_mul_(acc_d, rho)
        sq = torch._foreach_mul(cur, cur)
        torch._foreach_mul_(sq, 1 - rho)
        torch._foreach_add_(acc_d, sq)
        decay = torch._foreach_mul(ws, _col(scalars, 1))
        torch._foreach_sub_(ws, cur)
        torch._foreach_sub_(ws, decay)


@Optimizer.register
class Test(Optimizer):
    """Test optimizer (`optimizer.py:737`): w += rescale_grad * grad, and
    the state holds the new weight.  Counts and lr are not tracked."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def _step_scalars(self, index):
        return ()

    def _apply(self, ws, gs, states, scalars, keys):
        torch._foreach_add_(ws, torch._foreach_mul(gs, self.rescale_grad))
        for s, w in zip(states, ws):
            s[0].copy_(w)


create = Optimizer.create_optimizer
register = Optimizer.register


def get_updater(optimizer):
    """The KVStore updater closure (`optimizer.py:755`): creates each
    key's state on first use, then applies `optimizer.update`."""
    states = {}

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        optimizer.update(index, weight, grad, states[index])

    updater.optimizer = optimizer
    updater.states = states
    return updater


def get_fused_updater(optimizer, donate=True):
    """`get_updater`'s closure with a list form: called with lists of
    indices, gradients and weights it applies `Optimizer.update_multi` to
    the whole bucket, or `update` one parameter at a time while
    ``MXNET_FUSED_UPDATE=0`` (read at every call).  ``donate`` is accepted
    for the JAX package's callers and unused: the update is in place."""
    states = {}

    def updater(index, grad, weight):
        if isinstance(index, (list, tuple)):
            for i, w in zip(index, weight):
                if i not in states:
                    states[i] = optimizer.create_state(i, w)
            if not fused_update_enabled():
                for i, g, w in zip(index, grad, weight):
                    optimizer.update(i, w, g, states[i])
                return
            optimizer.update_multi(list(index), list(weight), list(grad),
                                   [states[i] for i in index])
            return
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        optimizer.update(index, weight, grad, states[index])

    updater.optimizer = optimizer
    updater.states = states
    updater.supports_multi = True
    return updater
