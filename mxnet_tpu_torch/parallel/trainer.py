"""The fused trainer, on one device.

A port of `mxnet_tpu/parallel/trainer.py` `SPMDTrainer` for one device
(the card by default): forward, backward and the optimizer update of a
Symbol graph in one call of `step`, with the JAX trainer's numerics:

* float32 master parameters, optimizer state and aux states; the graph
  computes in ``dtype`` by casting every floating argument except labels
  (``cast_arg``), and autograd's cast returns float32 gradients;
* a cotangent of ones on every head (loss heads ignore it);
* ``rescale = 1 / global_batch``, the first data input's leading
  dimension, not the token count;
* SGD with momentum and Adam with bias-corrected ``lr_t`` and weight
  decay folded into the gradient, applied to ``*_weight``/``*_gamma``
  only (`_wd_mult`), after clipping the rescaled gradient.

The update is one multi-tensor pass (`torch._foreach_*`) over all
parameters, in place on the master tensors and the optimizer state (the
JAX step donates them).  PyTorch runs eagerly, so `run_steps` is a Python
loop of steps; CUDA-graph capture is later work.

Refused with an error, never accepted and ignored: a mesh of more than
one device, ``param_sharding``, ``abstract=True``, an ``adam_v_dtype``
other than float32 (the bfloat16 table's stochastic rounding waits), and
``MXNET_CE_SHARD=1``.  `get_params` returns numpy arrays; `load_params`
carries the JAX trainer's parameters across.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import random as _random
from ..base import MXNetError
from ..context import resolve
from ..executor import _build_graph_fn
from ..initializer import Uniform

__all__ = ["SPMDTrainer", "load_params"]

# the compute dtypes the kernels take
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype-like or a name
    (bfloat16 included, with or without ml_dtypes)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else \
        getattr(dtype, "name", None) or np.dtype(dtype).name
    if name not in _DTYPES:
        raise MXNetError("SPMDTrainer: compute dtype must be one of %s, got "
                         "%r" % (sorted(_DTYPES), dtype))
    return _DTYPES[name]


def _one_device(mesh):
    """Raise unless ``mesh`` is None or describes one device: 1, a shape
    such as (1,), or a dict of axis sizes such as {"data": 1}."""
    if mesh is None:
        return
    sizes = mesh.values() if isinstance(mesh, dict) else \
        mesh if isinstance(mesh, (tuple, list)) else [mesh]
    try:
        one = int(np.prod([int(s) for s in sizes])) == 1
    except (TypeError, ValueError):
        one = False
    if not one:
        raise MXNetError(
            "SPMDTrainer runs on one device in this port: mesh must be None "
            "or describe one device (1, (1,), {'data': 1}), got %r" % (mesh,))


def _wd_mult(name):
    """Reference `Optimizer.set_wd_mult` default: weight decay applies to
    *_weight/*_gamma only — biases/beta/BN stats are excluded
    (`optimizer.py:76-87`)."""
    return 1.0 if name.endswith(("weight", "gamma")) else 0.0


def _host(value):
    """A float32 numpy copy of a numpy array, a tensor or an object with
    ``asnumpy()`` (the JAX package's NDArray)."""
    if hasattr(value, "asnumpy"):
        value = value.asnumpy()
    elif isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.array(value, dtype=np.float32)


class SPMDTrainer:
    """One-device fused trainer for a Symbol graph.

    Parameters
    ----------
    symbol : Symbol whose outputs are loss heads (SoftmaxOutput etc.).
    mesh : None, or a description of one device (see `_one_device`).
    data_shapes : dict name -> global batch shape.
    initializer : `initializer.Initializer`, default ``Uniform(0.07)``.
    dtype : compute dtype (torch, numpy or a name); masters stay float32.
    optimizer : 'sgd' (momentum/wd) or 'adam' (beta1/beta2/epsilon).
    ctx : device; None is the card (``cuda:0``), ``"cpu"`` the CPU.
    """

    def __init__(self, symbol, mesh=None, data_shapes=None, initializer=None,
                 lr=0.01, momentum=0.9, wd=0.0001, dtype=torch.float32,
                 param_sharding=None, optimizer="sgd", beta1=0.9,
                 beta2=0.999, epsilon=1e-8, clip_gradient=None,
                 adam_v_dtype=None, abstract=False, ctx=None):
        _one_device(mesh)
        if data_shapes is None:
            raise MXNetError("SPMDTrainer needs data_shapes")
        if param_sharding is not None:
            raise MXNetError("SPMDTrainer: param_sharding (tensor "
                             "parallelism) is not ported yet")
        if abstract:
            raise MXNetError("SPMDTrainer: abstract=True (AOT lowering for a "
                             "TPU topology) has no counterpart in the port")
        if adam_v_dtype is not None and \
                _torch_dtype(adam_v_dtype) != torch.float32:
            raise MXNetError(
                "SPMDTrainer: adam_v_dtype=%r is not ported yet (its "
                "stochastic rounding); use None or float32" % (adam_v_dtype,))
        if os.environ.get("MXNET_CE_SHARD", "0") == "1":
            raise MXNetError("SPMDTrainer: MXNET_CE_SHARD=1 (the vocab-sharded "
                             "CE head) is not ported yet")
        if optimizer not in ("sgd", "ccsgd", "adam"):
            raise MXNetError(
                "SPMDTrainer fuses the optimizer; sgd and adam are "
                "supported (got %r)" % (optimizer,))
        self.device = resolve(ctx)
        self.symbol = symbol
        self.lr, self.momentum, self.wd = float(lr), momentum, wd
        self.optimizer = "sgd" if optimizer == "ccsgd" else optimizer
        self._adam_hp = (beta1, beta2, epsilon)
        self.clip_gradient = clip_gradient
        self._compute_dtype = _torch_dtype(dtype)

        arg_shapes, _, aux_shapes = symbol.infer_shape(**data_shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % (data_shapes,))
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_names = [n for n in self.arg_names if n in data_shapes]
        self.param_names = [n for n in self.arg_names if n not in data_shapes]
        self._shape_of = dict(zip(self.arg_names, arg_shapes))

        # masters drawn in place on the device, in param_names order: the
        # same keys, in the same order, as the JAX trainer's host init
        initializer = initializer or Uniform(0.07)
        self.params = {}
        for n in self.param_names:
            p = torch.zeros(self._shape_of[n], dtype=torch.float32,
                            device=self.device)
            initializer(n, p)
            self.params[n] = p
        self.aux = {
            n: (torch.ones if n.endswith("moving_var") else torch.zeros)(
                tuple(s), dtype=torch.float32, device=self.device)
            for n, s in zip(self.aux_names, aux_shapes)}
        self.reset_optimizer()

        self._graph_fn = _build_graph_fn(symbol)
        self._base_key = _random.next_key()
        self._rescale = 1.0 / self._shape_of[self.data_names[0]][0]
        self._nstep = 0

    # -- state ---------------------------------------------------------------
    def reset_optimizer(self):
        """Zero the optimizer state: SGD momenta, or Adam's moments and its
        step count."""
        zeros = lambda: [torch.zeros_like(self.params[n])  # noqa: E731
                         for n in self.param_names]
        self._t = 0
        self.momenta = zeros()
        self._adam_v = zeros() if self.optimizer == "adam" else None

    def get_params(self):
        """(arg, aux) dicts of float32 numpy arrays (the checkpoint path;
        numpy until the port has an NDArray)."""
        arg = {n: p.detach().cpu().numpy() for n, p in self.params.items()}
        aux = {n: a.detach().cpu().numpy() for n, a in self.aux.items()}
        return arg, aux

    def set_lr(self, lr):
        """Change the learning rate of later steps."""
        self.lr = float(lr)

    def shard_batch(self, batch):
        """Host numpy/tensor dict -> tensors on the trainer's device."""
        out = {}
        for n, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            out[n] = t.to(self.device)
        return out

    # -- the step ------------------------------------------------------------
    def _cast_arg(self, name, x):
        # labels stay in their own dtype (class ids > 256 are not exact
        # in bf16); everything else floating casts to the compute dtype
        if "label" in name or not x.is_floating_point():
            return x
        return x.to(self._compute_dtype)

    def _run(self, params, batch, rng, is_train):
        args = [self._cast_arg(n, batch[n] if n in batch else params[n])
                for n in self.arg_names]
        outs, new_aux = self._graph_fn(args,
                                       [self.aux[n] for n in self.aux_names],
                                       rng, is_train)
        if is_train:
            self.aux = {n: a.detach()
                        for n, a in zip(self.aux_names, new_aux)}
        return outs

    def _grads(self, batch, rng):
        """(outputs, float32 gradients in param_names order) of one forward
        and backward at the current parameters, ones on every head."""
        leaves = {n: p.detach().requires_grad_()
                  for n, p in self.params.items()}
        with torch.enable_grad():
            outs = self._run(leaves, batch, rng, True)
            cot = [torch.ones((), dtype=o.dtype, device=o.device).expand(
                o.shape) for o in outs]
            grads = torch.autograd.grad(
                outs, [leaves[n] for n in self.param_names], cot,
                allow_unused=True)
        grads = [torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(self.param_names, grads)]
        return [o.detach() for o in outs], grads

    def _update(self, grads):
        """The optimizer step, in place on the masters: one multi-tensor
        pass per operation over every parameter."""
        params = [self.params[n] for n in self.param_names]
        torch._foreach_mul_(grads, self._rescale)
        if self.clip_gradient:
            torch._foreach_clamp_min_(grads, -self.clip_gradient)
            torch._foreach_clamp_max_(grads, self.clip_gradient)
        if self.wd:
            decayed = [i for i, n in enumerate(self.param_names)
                       if _wd_mult(n)]
            torch._foreach_add_([grads[i] for i in decayed],
                                [params[i] for i in decayed], alpha=self.wd)
        if self.optimizer == "adam":
            b1, b2, eps = self._adam_hp
            self._t += 1
            # lr_t in float32, as the JAX step computes it
            t = np.float32(self._t)
            coef1 = np.float32(1) - np.float32(b1) ** t
            coef2 = np.float32(1) - np.float32(b2) ** t
            lr_t = np.float32(self.lr) * np.sqrt(coef2) / coef1
            m, v = self.momenta, self._adam_v
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(params, m, denom, value=-float(lr_t))
        elif self.momentum:
            torch._foreach_mul_(self.momenta, self.momentum)
            torch._foreach_add_(self.momenta, grads, alpha=-self.lr)
            torch._foreach_add_(params, self.momenta)
        else:
            torch._foreach_add_(params, grads, alpha=-self.lr)

    def _train_step(self, batch, rng):
        outs, grads = self._grads(batch, rng)
        self._update(grads)
        return outs

    def step(self, batch):
        """One fused train step.  Returns the graph outputs."""
        self._nstep += 1
        rng = _random.fold_in(self._base_key, self._nstep)
        return self._train_step(self.shard_batch(batch), rng)

    def run_steps(self, batch, nsteps):
        """nsteps train steps.  `batch` leaves may carry a leading
        (nsteps, ...) axis for per-step data; others are reused."""
        self._nstep += nsteps
        rng = _random.fold_in(self._base_key, self._nstep)
        dev = self.shard_batch(batch)
        stacked = {n: v.dim() > len(self._shape_of.get(n, v.shape))
                   for n, v in dev.items()}
        for i in range(nsteps):
            b = {n: (v[i] if stacked[n] else v) for n, v in dev.items()}
            self._train_step(b, _random.fold_in(rng, i))

    def gradients(self, batch):
        """{name: float32 gradient} of one forward and backward at the
        current parameters, before the update's rescale: what a step
        would apply, for checking the backward kernels.  Updates
        nothing."""
        rng = _random.fold_in(self._base_key, self._nstep + 1)
        _, grads = self._grads(self.shard_batch(batch), rng)
        return dict(zip(self.param_names, grads))

    def forward(self, batch):
        """The graph outputs at inference (no gradient, is_train False);
        missing data inputs (labels) are zeros."""
        rng = _random.fold_in(self._base_key, 0)
        dev = self.shard_batch(batch)
        for n in self.data_names:  # labels are inert at inference
            if n not in dev:
                dev[n] = torch.zeros(self._shape_of[n], dtype=torch.float32,
                                     device=self.device)
        with torch.no_grad():
            return self._run(self.params, dev, rng, False)


def load_params(trainer, arg_params, aux_params=None):
    """Copy parameters into ``trainer``'s float32 masters and reset its
    optimizer state.

    ``arg_params`` (and ``aux_params``) map names to arrays: numpy arrays,
    tensors, or the JAX trainer's ``get_params()`` NDArrays.  Every name of
    ``trainer.param_names`` must be present with its shape, and no other;
    anything else raises `MXNetError` before a value is copied."""
    checks = [("arg", trainer.params, arg_params)]
    if aux_params is not None:
        checks.append(("aux", trainer.aux, aux_params))
    host = {}
    for what, mine, given in checks:
        missing = sorted(set(mine) - set(given))
        extra = sorted(set(given) - set(mine))
        if missing or extra:
            raise MXNetError("load_params: %s names differ: missing %s, "
                             "unexpected %s" % (what, missing, extra))
        for n, t in mine.items():
            a = _host(given[n])
            if tuple(a.shape) != tuple(t.shape):
                raise MXNetError("load_params: %s has shape %s, the trainer "
                                 "expects %s" % (n, tuple(a.shape),
                                                 tuple(t.shape)))
            host[(what, n)] = a
    for what, mine, _ in checks:
        for n, t in mine.items():
            t.copy_(torch.from_numpy(host[(what, n)]))
    trainer.reset_optimizer()
