"""Loss heads with the reference's backward.

A port of `mxnet_tpu/ops/loss.py` `SoftmaxOutput`.  Its training gradient
is not the autodiff of its forward: like the reference
(`src/operator/softmax_output-inl.h`) its backward ignores the incoming
head gradient and returns ``(softmax - onehot(label)) * grad_scale``, with
the rows of ``ignore_label`` zeroed under ``use_ignore``.  That is a
`torch.autograd.Function`, as it is a `jax.custom_vjp` in JAX.

The one-hot is never built: the backward copies the saved softmax and
subtracts 1 at each row's label (``scatter_add_``), in the softmax's
dtype.  At the GPT-2 training shape a (32768, 32768) one-hot would be
4.3 GB in float32.  A label outside [0, classes) subtracts nothing, as
`jax.nn.one_hot` gives it an all-zero row.
"""
from __future__ import annotations

import torch

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
