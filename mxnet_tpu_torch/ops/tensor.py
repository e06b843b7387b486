"""Tensor-manipulation ops.

A port of `mxnet_tpu/ops/tensor.py` (the reference's
`src/operator/{reshape,concat,slice_channel,swapaxis,cast,block_grad,
crop,upsampling,elementwise_sum}-inl.h`), with the JAX package's
parameters, argument lists and shape rules.  Each body is one or a few
torch calls that run on both devices.

* `Reshape` takes ``shape`` (or the reference's ``target_shape``) with
  MXNet's codes, 0 = copy this dim of the input and -1 = infer it.
  `torch.reshape` returns a view wherever the strides allow, as the JAX
  reshape fuses away.
* `Concat`, `ElementWiseSum`, `Crop` and `UpSampling` take a variable
  number of inputs, counted in ``num_args`` (``key_var_num_args``).
* `Crop` clamps its offset into the input, as `jax.lax.dynamic_slice`
  clamps its start.
* `UpSampling`'s bilinear mode is `F.interpolate` with half-pixel
  centres (``align_corners=False``), which gives `jax.image.resize`'s
  values: at the edges both weigh only the pixels inside the input
  (`tests/test_torch_conv_ops.py` holds them at scales 2 and 3).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, np_dtype, torch_dtype
from .registry import OpDef, Param, register


class Reshape(OpDef):
    """`src/operator/reshape-inl.h`.  Accepts `target_shape` (reference) or
    `shape` with 0=copy-dim and -1=infer extensions."""

    name = "Reshape"
    params = {
        "target_shape": Param("shape", default=None),
        "shape": Param("shape", default=None),
    }

    def _resolve(self, params, d):
        tgt = params["shape"] or params["target_shape"]
        if tgt is None:
            raise MXNetError("Reshape: need target_shape or shape")
        tgt = list(tgt)
        for i, v in enumerate(tgt):
            if v == 0:
                tgt[i] = d[i]
        if -1 in tgt:
            known = int(np.prod([v for v in tgt if v != -1]))
            tgt[tgt.index(-1)] = int(np.prod(d)) // max(known, 1)
        if int(np.prod(tgt)) != int(np.prod(d)):
            raise MXNetError("Reshape: size mismatch %s -> %s" % (d, tgt))
        return tuple(tgt)

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d], [self._resolve(params, d)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        return [x.reshape(self._resolve(params, tuple(x.shape)))], []


register(Reshape)


class Flatten(OpDef):
    """Flatten to (batch, -1) (`src/operator/reshape-inl.h` Flatten)."""

    name = "Flatten"

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d], [(d[0], int(np.prod(d[1:])))], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)], []


register(Flatten)


class Concat(OpDef):
    """`src/operator/concat-inl.h` — variable-arity concat along `dim`."""

    name = "Concat"
    params = {
        "num_args": Param(int, required=True),
        "dim": Param(int, default=1),
    }
    key_var_num_args = "num_args"

    def list_arguments(self, params):
        return ["arg%d" % i for i in range(params["num_args"])]

    def infer_shape(self, params, in_shapes):
        dim = params["dim"]
        if any(s is None for s in in_shapes):
            return in_shapes, [None], []
        out = list(in_shapes[0])
        out[dim] = sum(s[dim] for s in in_shapes)
        return in_shapes, [tuple(out)], []

    def apply(self, octx, params, inputs, aux):
        return [torch.cat(inputs, dim=params["dim"])], []


register(Concat)


class SliceChannel(OpDef):
    """`src/operator/slice_channel-inl.h` — split into num_outputs along
    `axis` (default 1), optional squeeze of the split axis."""

    name = "SliceChannel"
    params = {
        "num_outputs": Param(int, required=True),
        "axis": Param(int, default=1),
        "squeeze_axis": Param(bool, default=False),
    }

    def list_outputs(self, params):
        return ["output%d" % i for i in range(params["num_outputs"])]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        n = params["num_outputs"]
        if d is None:
            return in_shapes, [None] * n, []
        ax = params["axis"]
        if d[ax] % n:
            raise MXNetError("SliceChannel: axis %d size %d not divisible by %d"
                             % (ax, d[ax], n))
        piece = list(d)
        piece[ax] = d[ax] // n
        if params["squeeze_axis"]:
            if piece[ax] != 1:
                raise MXNetError("SliceChannel: squeeze_axis needs size-1 slices")
            piece.pop(ax)
        return [d], [tuple(piece)] * n, []

    def apply(self, octx, params, inputs, aux):
        x, ax = inputs[0], params["axis"]
        outs = torch.chunk(x, params["num_outputs"], dim=ax)
        if params["squeeze_axis"]:
            outs = [o.squeeze(ax) for o in outs]
        return list(outs), []


register(SliceChannel)


class ElementWiseSum(OpDef):
    """`src/operator/elementwise_sum-inl.h` — n-ary add, left to right."""

    name = "ElementWiseSum"
    params = {"num_args": Param(int, required=True)}
    key_var_num_args = "num_args"

    def list_arguments(self, params):
        return ["arg%d" % i for i in range(params["num_args"])]

    def infer_shape(self, params, in_shapes):
        known = [s for s in in_shapes if s is not None]
        s = known[0] if known else None
        return [s] * len(in_shapes), [s], []

    def apply(self, octx, params, inputs, aux):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out], []


register(ElementWiseSum)


class SwapAxis(OpDef):
    """`src/operator/swapaxis-inl.h`."""

    name = "SwapAxis"
    params = {"dim1": Param(int, default=0), "dim2": Param(int, default=0)}

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        s = list(d)
        a, b = params["dim1"], params["dim2"]
        s[a], s[b] = s[b], s[a]
        return [d], [tuple(s)], []

    def apply(self, octx, params, inputs, aux):
        return [inputs[0].transpose(params["dim1"], params["dim2"])], []


register(SwapAxis)


class Cast(OpDef):
    """`src/operator/cast-inl.h` — dtype cast (the gradient casts back)."""

    name = "Cast"
    params = {"dtype": Param(str, required=True)}

    def infer_type(self, params, in_types):
        name = params["dtype"]
        out = torch.bfloat16 if name == "bfloat16" else np_dtype(name)
        return in_types, [out], []

    def apply(self, octx, params, inputs, aux):
        return [inputs[0].to(torch_dtype(params["dtype"]))], []


register(Cast)


class BlockGrad(OpDef):
    """`src/operator/block_grad-inl.h` — identity forward, zero gradient."""

    name = "BlockGrad"

    def apply(self, octx, params, inputs, aux):
        return [inputs[0].detach()], []


register(BlockGrad)


class Crop(OpDef):
    """`src/operator/crop-inl.h` — crop NCHW input to `h_w` (or to the size
    of a second reference input) at `offset`, or centered."""

    name = "Crop"
    params = {
        "num_args": Param(int, default=1),
        "offset": Param("shape", default=(0, 0)),
        "h_w": Param("shape", default=(0, 0)),
        "center_crop": Param(bool, default=False),
    }
    key_var_num_args = "num_args"

    def list_arguments(self, params):
        if params["num_args"] == 2:
            return ["data", "crop_like"]
        return ["data"]

    def _target(self, params, like):
        if params["num_args"] == 2 and like is not None:
            return like[2], like[3]
        hw = params["h_w"]
        if hw == (0, 0):
            raise MXNetError("Crop: need h_w or a crop_like input")
        return hw[0], hw[1]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        like = in_shapes[1] if len(in_shapes) > 1 else None
        if d is None or (params["num_args"] == 2 and like is None):
            return in_shapes, [None], []
        th, tw = self._target(params, like)
        return in_shapes, [(d[0], d[1], th, tw)], []

    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        like = tuple(inputs[1].shape) if len(inputs) > 1 else None
        th, tw = self._target(params, like)
        h, w = x.shape[2], x.shape[3]
        if params["center_crop"]:
            oy, ox = (h - th) // 2, (w - tw) // 2
        else:
            oy, ox = params["offset"]
        # clamp the start into the input, as jax.lax.dynamic_slice does
        oy = min(max(oy, 0), h - th)
        ox = min(max(ox, 0), w - tw)
        return [x[:, :, oy:oy + th, ox:ox + tw]], []


register(Crop)


class UpSampling(OpDef):
    """`src/operator/upsampling-inl.h` — nearest or bilinear upsampling of
    one or more inputs to `scale`× the first input, concatenated along
    channels (bilinear as `jax.image.resize` computes it, not the
    reference's learned deconvolution filter)."""

    name = "UpSampling"
    params = {
        "scale": Param(int, required=True),
        "sample_type": Param(str, default="nearest"),
        "num_args": Param(int, default=1),
        "num_filter": Param(int, default=0),  # accepted for parity
    }
    key_var_num_args = "num_args"

    def list_arguments(self, params):
        n = params["num_args"]
        return ["arg%d" % i for i in range(n)] if n > 1 else ["data"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if any(s is None for s in in_shapes):
            return in_shapes, [None], []
        sc = params["scale"]
        c = sum(s[1] for s in in_shapes)
        return in_shapes, [(d[0], c, d[2] * sc, d[3] * sc)], []

    def apply(self, octx, params, inputs, aux):
        sc = params["scale"]
        oh, ow = inputs[0].shape[2] * sc, inputs[0].shape[3] * sc
        ups = []
        for x in inputs:
            if params["sample_type"] == "bilinear":
                up = F.interpolate(x, size=(oh, ow), mode="bilinear",
                                   align_corners=False)
            else:
                up = x.repeat_interleave(oh // x.shape[2], dim=2) \
                    .repeat_interleave(ow // x.shape[3], dim=3)
            ups.append(up)
        out = ups[0] if len(ups) == 1 else torch.cat(ups, dim=1)
        return [out.to(inputs[0].dtype)], []


register(UpSampling)


class _CrossDeviceCopy(OpDef):
    """`src/operator/cross_device_copy.cc` — the marker op the reference's
    executor special-cased; on one device it is the identity."""

    name = "_CrossDeviceCopy"

    def apply(self, octx, params, inputs, aux):
        return [inputs[0]], []


register(_CrossDeviceCopy)
