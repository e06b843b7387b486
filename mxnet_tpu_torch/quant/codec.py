"""Symmetric per-channel quantization codec (int8 / fp8), in PyTorch.

A port of `mxnet_tpu/quant/codec.py` (the port keeps its own copy).  One
codec serves every consumer:

* serving weights (``MXNET_SERVE_QUANT``): `TransformerKVModel` quantizes
  its matmul weights once at load (`quantize`, channel axis 0, the output
  row of each (out, in) projection) and runs scaled matmuls,
  ``y = (x @ W_q.T) * scale``;
* int8 paged KV (``MXNET_SERVE_KV_QUANT``): the block pool stores int8
  rows with one f32 scale per cached token row (`quantize_rows`), so an
  incremental write never re-scales a row already written;
* the dist-PS wire format (``MXNET_PS_QUANT``): `encode_wire` /
  `decode_wire` quantize a host array per fixed-size group.  Nothing in
  the port sends it until `dist` is ported (ROADMAP.md queue 1, item 3).

Everything is symmetric (no zero points) and deterministic: the same
input gives the same bits.  The functions take torch tensors (any
device) or numpy arrays (the host path of the wire format); int8 stays
numpy on the host, while fp8 is stored as ``torch.float8_e4m3fn`` on
both paths, since numpy has no float8 type of its own.  The arithmetic
is the JAX codec's, in its order: an f32 amax, the scale ``amax / qmax``
(1 for an all-zero channel), the f32 divide, then round half to even
(int8 only) and clip, then the cast.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["QuantSpec", "resolve", "fp8_supported", "quantize",
           "dequantize", "quantize_rows", "row_amax", "encode_wire",
           "decode_wire", "wire_nbytes", "WIRE_GROUP"]

_OFF = ("", "0", "none", "off", "false", "no", "bf16", "fp32")


class QuantSpec:
    """One quantization format: its storage dtype and the symmetric range
    ``qmax`` the per-channel (or per-row, per-group) amax maps onto: 127
    for int8, 448 for fp8 e4m3 (its largest finite value)."""

    __slots__ = ("name", "qmax")

    def __init__(self, name):
        name = str(name).lower()
        if name == "int8":
            self.qmax = 127.0
        elif name == "fp8":
            if not fp8_supported():
                raise MXNetError(
                    "QuantSpec: fp8 (float8_e4m3fn) is not supported by "
                    "this torch build; use MXNET_SERVE_QUANT=int8")
            self.qmax = 448.0
        else:
            raise MXNetError(
                "QuantSpec: unknown format %r (expected 'int8' or 'fp8')"
                % (name,))
        self.name = name

    @property
    def dtype(self):
        """The torch storage dtype."""
        return torch.int8 if self.name == "int8" else torch.float8_e4m3fn

    def __repr__(self):
        return "QuantSpec(%r)" % self.name

    def __eq__(self, other):
        return isinstance(other, QuantSpec) and other.name == self.name

    def __hash__(self):
        return hash(("QuantSpec", self.name))


def resolve(spec):
    """An env string or spec as a `QuantSpec`, or None (quantization off):
    a `QuantSpec`, a format name ('int8', 'fp8') or a kill-switch
    spelling ('', '0', 'none', 'off', ...).  The one parser of
    ``MXNET_SERVE_QUANT``, ``MXNET_SERVE_KV_QUANT`` and
    ``MXNET_PS_QUANT``."""
    if spec is None or isinstance(spec, QuantSpec):
        return spec
    if str(spec).lower() in _OFF:
        return None
    return QuantSpec(spec)


def fp8_supported():
    """Whether this torch build stores and converts float8_e4m3fn (the
    scaled matmul upcasts to f32, so a convert is all fp8 weights need)."""
    return hasattr(torch, "float8_e4m3fn")


def _is_np(x):
    return isinstance(x, (np.ndarray, np.generic))


def _scale_from_amax(amax, qmax):
    # a zero channel gets scale 1 (its quantized values are all zero);
    # guards the divide on dead channels and never-written KV rows
    if _is_np(amax):
        return np.where(amax > 0, amax / qmax,
                        np.float32(1.0)).astype(np.float32)
    # divide by a tensor: CUDA turns a division by a Python scalar into a
    # product with its reciprocal, which can round one ulp away from the
    # CPU's (and JAX's) true division
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                       torch.ones((), dtype=torch.float32,
                                  device=amax.device))


def _cast_q(y, spec):
    if _is_np(y):
        if spec.name == "int8":
            return np.clip(np.round(y), -spec.qmax,
                           spec.qmax).astype(np.int8)
        return torch.from_numpy(np.ascontiguousarray(
            np.clip(y, -spec.qmax, spec.qmax))).to(spec.dtype)
    if spec.name == "int8":
        return torch.clamp(torch.round(y), -spec.qmax,
                           spec.qmax).to(torch.int8)
    return torch.clamp(y, -spec.qmax, spec.qmax).to(spec.dtype)


def _amax(x, dims):
    if not dims:
        return np.abs(x) if _is_np(x) else x.abs()
    if _is_np(x):
        return np.max(np.abs(x), axis=dims)
    return x.abs().amax(dim=dims)


def _f32(x):
    if _is_np(x):
        return np.asarray(x).astype(np.float32)
    return x.to(torch.float32)


def quantize(x, spec, axis=0):
    """Per-channel symmetric quantization of ``x``: one f32 scale per
    index of ``axis`` (amax over every other axis).  Returns ``(q,
    scale)``, ``scale`` shaped ``(x.shape[axis],)``.  For an (out, in)
    weight, ``axis=0`` is the per-output-channel layout the scaled matmul
    applies to its output's last dimension."""
    spec = resolve(spec)
    if spec is None:
        raise MXNetError("quantize: spec resolved to None (quant off)")
    x = _f32(x)
    ax = axis % x.ndim
    scale = _scale_from_amax(
        _amax(x, tuple(a for a in range(x.ndim) if a != ax)), spec.qmax)
    shape = [1] * x.ndim
    shape[ax] = -1
    return _cast_q(x / scale.reshape(shape), spec), scale


def row_amax(x):
    """The per-row amax `quantize_rows` scales by: ``|x|`` maxed over the
    last axis, in f32."""
    x = _f32(x)
    return _amax(x, (x.ndim - 1,))


def quantize_rows(x, spec, amax=None):
    """Per-row symmetric quantization: one f32 scale per index of every
    leading axis, amax over the last axis only.  Returns ``(q, scale)``,
    ``scale`` shaped ``x.shape[:-1]``: the K/V pool's layout, where each
    cached token row carries its own scale.  ``amax`` overrides the row's
    own: a sub-mesh replica quantizes each shard's slice of a row by the
    max of every shard's `row_amax`, the whole row's."""
    spec = resolve(spec)
    if spec is None:
        raise MXNetError("quantize_rows: spec resolved to None (quant off)")
    x = _f32(x)
    if amax is None:
        amax = _amax(x, (x.ndim - 1,))
    scale = _scale_from_amax(amax, spec.qmax)
    return _cast_q(x / scale[..., None], spec), scale


def dequantize(q, scale, axis=None):
    """Inverse of `quantize` / `quantize_rows`: ``q * scale`` in f32.
    ``axis=None`` is the row layout (``scale.shape == q.shape[:-1]``); an
    integer ``axis`` the per-channel one.  Numpy in, numpy out (an fp8
    ``q`` is a CPU tensor even then)."""
    host = _is_np(scale)
    if isinstance(q, torch.Tensor) and host:
        q = q.to(torch.float32).numpy()
    q = _f32(q)
    scale = _f32(scale)
    if axis is None:
        return q * scale[..., None]
    shape = [1] * q.ndim
    shape[axis % q.ndim] = -1
    return q * scale.reshape(shape)


# -- dist-PS wire format (MXNET_PS_QUANT), host only ------------------------

WIRE_GROUP = 256  # values per wire scale (both ends must agree)


def encode_wire(arr, spec, group=WIRE_GROUP):
    """Quantize a host array for the wire: flatten, pad to a multiple of
    ``group``, quantize each group symmetrically, and return the
    self-describing payload (storage, per-group f32 scales, the original
    shape and dtype).  Deterministic, so a retried push re-encodes the
    same bits.  The group is clamped to the array, so a tiny array never
    ships more bytes quantized than plain."""
    spec = resolve(spec)
    arr = np.asarray(arr)
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    group = max(1, min(int(group), len(flat)))
    pad = (-len(flat)) % group
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    q, scale = quantize_rows(flat.reshape(-1, group), spec)
    return {"q": q, "scale": scale, "shape": tuple(arr.shape),
            "dtype": arr.dtype.str, "format": spec.name,
            "group": group}


def decode_wire(msg):
    """Inverse of `encode_wire`: the dequantized array at its original
    shape and dtype, keyed off the message (not the environment), so
    quantizing and plain senders reduce through one server."""
    flat = dequantize(msg["q"], np.asarray(msg["scale"]))
    n = int(np.prod(msg["shape"])) if msg["shape"] else 1
    return flat.reshape(-1)[:n].reshape(msg["shape"]).astype(msg["dtype"])


def wire_nbytes(msg):
    """Payload bytes of an encoded wire message."""
    return int(msg["q"].nbytes + msg["scale"].nbytes)
