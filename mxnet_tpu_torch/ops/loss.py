"""Loss heads with the reference's backward.

A port of `mxnet_tpu/ops/loss.py`.  A loss head's training gradient is
not the autodiff of its forward: like the reference
(`src/operator/softmax_output-inl.h`, `regression_output-inl.h`) its
backward ignores the incoming head gradient.  `SoftmaxOutput` returns
``(softmax - onehot(label)) * grad_scale``, with the rows of
``ignore_label`` zeroed under ``use_ignore``; the regression heads
``(out - label) * grad_scale`` (`MAERegressionOutput` its sign).  Each is
a `torch.autograd.Function`, as it is a `jax.custom_vjp` in JAX.
`softmax_cross_entropy` (a summed loss of shape (1,)) scales its
gradient by the incoming one, and `IdentityAttachKLSparseReg` is the
identity forward whose backward adds the KL-sparseness penalty.

The one-hot is never built: the backward copies the saved softmax and
subtracts 1 at each row's label (``scatter_add_``), in the softmax's
dtype.  At the GPT-2 training shape a (32768, 32768) one-hot would be
4.3 GB in float32.  A label outside [0, classes) subtracts nothing, as
`jax.nn.one_hot` gives it an all-zero row.

`FusedSoftmaxCE` is the dense head's FullyConnected + SoftmaxOutput in
one op whose logits never reach device memory: it returns the per-token
NLL and has the same loss-head gradient, through the fused CE kernels
(`pallas_kernels/fused_ce.py`).  The vocab-sharded form
(``MXNET_CE_SHARD=1``) needs more than one card and is refused by the
trainer; without a mesh the JAX op takes the replicated path too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .indexing import as_index, pick
from .pallas_kernels.fused_ce import fused_softmax_ce
from .registry import OpDef, Param, register


class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore):
        out = torch.softmax(data, dim=1)
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, ignore_label, use_ignore)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore = ctx.args
        classes = out.shape[1]
        lbl = label.long().unsqueeze(1)
        hit = ((lbl >= 0) & (lbl < classes)).to(out.dtype)
        grad = out.clone().scatter_add_(1, lbl.clamp(0, classes - 1), -hit)
        if use_ignore:
            keep = (label != ignore_label).to(out.dtype)
            grad.mul_(keep.unsqueeze(1))
        if grad_scale != 1.0:
            grad.mul_(grad_scale)
        return grad, None, None, None, None


class SoftmaxOutput(OpDef):
    """Softmax with cross-entropy gradient (`softmax_output-inl.h`).

    Forward: softmax over axis 1 ((n, c) or (n, c, ...) with
    multi_output).  Backward: `(softmax - onehot(label)) * grad_scale`,
    entries with `label == ignore_label` zeroed when `use_ignore`.
    Registered alias `Softmax` like the reference's deprecated name.
    """

    name = "SoftmaxOutput"
    params = {
        "grad_scale": Param(float, default=1.0),
        "ignore_label": Param(float, default=-1.0),
        "multi_output": Param(bool, default=False),
        "use_ignore": Param(bool, default=False),
    }

    def list_arguments(self, params):
        return ["data", "label"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        lshape = (d[0],) + tuple(d[2:]) if params["multi_output"] else (d[0],)
        return [d, lshape], [d], []

    def apply(self, octx, params, inputs, aux):
        return [_SoftmaxOutputFn.apply(
            inputs[0], inputs[1], params["grad_scale"],
            params["ignore_label"], params["use_ignore"])], []


register(SoftmaxOutput, aliases=["Softmax"])


class FusedSoftmaxCE(OpDef):
    """Fused FullyConnected + SoftmaxOutput head; the logits never reach
    device memory.

    Forward: the float32 (tokens,) negative log-likelihood of
    ``softmax(data @ weight.T + bias)`` at ``label``.  Backward: the
    loss-head rule ``(softmax - onehot(label)) * grad_scale`` with the
    incoming cotangent ignored, as `SoftmaxOutput`, so every parameter
    gradient equals the dense head's.  Weight and bias are named and
    shaped as FullyConnected's, so checkpoints carry across heads.
    """

    name = "FusedSoftmaxCE"
    params = {
        "num_hidden": Param(int, required=True),
        "grad_scale": Param(float, default=1.0),
        "ignore_label": Param(float, default=-1.0),
        "use_ignore": Param(bool, default=False),
        "no_bias": Param(bool, default=False),
        "block_n": Param(int, default=512),
        "block_v": Param(int, default=2048),
    }

    def list_arguments(self, params):
        args = ["data", "weight"]
        if not params["no_bias"]:
            args.append("bias")
        return args + ["label"]

    def infer_shape(self, params, in_shapes):
        nh = params["num_hidden"]
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if len(d) < 2:
            raise MXNetError(
                "FusedSoftmaxCE: data must be (batch, ...) with at least "
                "2 dims, got %s" % (d,))
        flat = int(np.prod(d[1:]))
        shapes = [d, (nh, flat)]
        if not params["no_bias"]:
            shapes.append((nh,))
        shapes.append((d[0],))
        return shapes, [(d[0],)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0].reshape(inputs[0].shape[0], -1)
        bias = None if params["no_bias"] else inputs[2]
        nll = fused_softmax_ce(
            x, inputs[1], bias, inputs[-1], grad_scale=params["grad_scale"],
            ignore_label=params["ignore_label"],
            use_ignore=params["use_ignore"], block_n=params["block_n"],
            block_v=params["block_v"])
        return [nll], []


register(FusedSoftmaxCE)


# -- Regression outputs ---------------------------------------------------


class _RegressionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, fwd, grad, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.args = (grad, grad_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad, grad_scale = ctx.args
        dx = grad(out, label.reshape(out.shape)) * grad_scale
        return dx.to(out.dtype), None, None, None, None


def _make_regression(name_, fwd_fn, grad_fn):
    class _Reg(OpDef):
        name = name_
        params = {"grad_scale": Param(float, default=1.0)}

        def list_arguments(self, params):
            return ["data", "label"]

        def infer_shape(self, params, in_shapes):
            d = in_shapes[0]
            if d is None:
                return in_shapes, [None], []
            return [d, d], [d], []

        def apply(self, octx, params, inputs, aux):
            return [_RegressionFn.apply(inputs[0], inputs[1], fwd_fn, grad_fn,
                                        params["grad_scale"])], []

    _Reg.__doc__ = "`src/operator/regression_output-inl.h` (%s)" % name_
    return _Reg


register(_make_regression("LinearRegressionOutput", lambda x: x,
                          lambda o, l: o - l))
register(_make_regression("LogisticRegressionOutput", torch.sigmoid,
                          lambda o, l: o - l))
register(_make_regression("MAERegressionOutput", lambda x: x,
                          lambda o, l: torch.sign(o - l)))


# -- softmax_cross_entropy (loss_binary_op-inl.h) -------------------------


class _SoftmaxCEFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label):
        ctx.save_for_backward(data, label)
        logp = torch.log_softmax(data, dim=1)
        # the JAX op's take_along_axis: a label out of range picks NaN,
        # a negative one in range wraps
        picked = pick(logp, label)
        return -torch.sum(picked).reshape(1)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        # jax.nn.one_hot: a label outside [0, classes) has a zero row
        onehot = as_index(label)[:, None] == torch.arange(
            data.shape[1], device=data.device)
        grad = torch.softmax(data, dim=1) - onehot.to(data.dtype)
        return g[0] * grad, None


class SoftmaxCrossEntropy(OpDef):
    """`src/operator/loss_binary_op-inl.h` — scalar summed CE loss."""

    name = "softmax_cross_entropy"

    def list_arguments(self, params):
        return ["data", "label"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [(1,)], []
        return [d, (d[0],)], [(1,)], []

    def apply(self, octx, params, inputs, aux):
        return [_SoftmaxCEFn.apply(inputs[0], inputs[1])], []


register(SoftmaxCrossEntropy)


# -- IdentityAttachKLSparseReg -------------------------------------------


class _KLSparseRegFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rho, penalty):
        ctx.save_for_backward(x)
        ctx.args = (rho, penalty)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        rho, penalty = ctx.args
        rho_hat = torch.mean(x, dim=0, keepdim=True)
        kl = penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + kl.to(x.dtype), None, None


class IdentityAttachKLSparseReg(OpDef):
    """`src/operator/identity_attach_KL_sparse_reg-inl.h` — identity forward;
    backward adds the KL-sparseness penalty gradient
    `penalty * (-rho/rho_hat + (1-rho)/(1-rho_hat))` where rho_hat is the
    batch mean activation (sigmoid-activity assumption)."""

    name = "IdentityAttachKLSparseReg"
    params = {
        "sparseness_target": Param(float, default=0.1),
        "penalty": Param(float, default=0.001),
        "momentum": Param(float, default=0.9),
    }

    def apply(self, octx, params, inputs, aux):
        return [_KLSparseRegFn.apply(inputs[0], params["sparseness_target"],
                                     params["penalty"])], []


register(IdentityAttachKLSparseReg)
