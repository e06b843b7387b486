"""Weight initializers.

A port of `mxnet_tpu/initializer.py` (the reference's
`python/mxnet/initializer.py`): an initializer is called as
``init(name, arr)`` and routes on the parameter name's suffix (bias,
gamma, beta and moving statistics get fixed values; weights get the
strategy).  ``arr`` is an `NDArray`, a torch tensor or a numpy array,
filled in place; a draw runs on the array's own device.

Every draw takes the next key of `random`, one per weight in the order
the weights are initialized.  After `random.seed(s)`, `Uniform` and
`Xavier`'s uniform draw give the JAX package's values bit for bit;
`Normal`, `Xavier(rnd_type='gaussian')` and `MSRAPrelu` agree with it to
float32 rounding (torch's `erfinv` is not XLA's).  `Orthogonal` draws
from numpy's global generator and takes numpy's SVD, as the reference
does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "Load", "Mixed"]


def _fill(arr, value):
    """Write ``value`` (a scalar, a numpy array or a tensor) into arr."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    if isinstance(arr, NDArray):
        arr = arr.data
    if isinstance(arr, torch.Tensor):
        if isinstance(value, torch.Tensor):
            arr.copy_(value)
        else:
            arr.fill_(value)
    else:
        arr[...] = value.cpu().numpy() if isinstance(value, torch.Tensor) \
            else value


class Initializer:
    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    def _init_bilinear(self, name, arr):
        """Bilinear upsampling kernel (reference `_init_bilinear`)."""
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, torch.from_numpy(weight.reshape(shape)))

    def _init_bias(self, name, arr):
        _fill(arr, 0.0)

    def _init_gamma(self, name, arr):
        _fill(arr, 1.0)

    def _init_beta(self, name, arr):
        _fill(arr, 0.0)

    def _init_zero(self, name, arr):
        _fill(arr, 0.0)

    def _init_one(self, name, arr):
        _fill(arr, 1.0)

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override _init_weight")

    def _init_default(self, name, arr):
        raise MXNetError(
            "unknown parameter name pattern %r; use a known suffix "
            "(weight/bias/gamma/beta/...)" % name
        )


def _device(arr):
    if isinstance(arr, NDArray):
        return arr.data.device
    return arr.device if isinstance(arr, torch.Tensor) else \
        torch.device("cpu")


def _uniform(arr, low, high):
    """U[low, high) of arr's shape with the next key, float32."""
    bits = _random.random_bits(_random.next_key(), tuple(arr.shape),
                               _device(arr))
    return _random.uniform_from_bits(bits, low, high)


def _normal(arr, scale):
    """scale * N(0, 1) of arr's shape with the next key, float32."""
    return _random.normal(0.0, 1.0, tuple(arr.shape), _device(arr)) * scale


class Uniform(Initializer):
    """U[-scale, scale] (`initializer.py:147`), drawn with the next key of
    `random`."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        _fill(arr, _uniform(arr, -self.scale, self.scale))


class Normal(Initializer):
    """N(0, sigma^2) (`initializer.py:160`)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _fill(arr, _normal(arr, self.sigma))


class Orthogonal(Initializer):
    """Orthogonal init (`initializer.py:171`; Saxe et al.), from numpy's
    global generator and SVD."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill(arr, (self.scale * q).reshape(arr.shape).astype(np.float32))


class Xavier(Initializer):
    """Xavier/Glorot (`initializer.py:190`): U[-s, s] or s * N(0, 1) with
    s = sqrt(magnitude / factor), factor the average, fan-in or fan-out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("invalid factor_type %r" % self.factor_type)
        scale = float(np.float32(np.sqrt(self.magnitude / factor)))
        if self.rnd_type == "uniform":
            _fill(arr, _uniform(arr, -scale, scale))
        else:
            _fill(arr, _normal(arr, scale))


class MSRAPrelu(Xavier):
    """He init for PReLU nets: Gaussian Xavier with magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)


class Bilinear(Initializer):
    """Bilinear-upsampling kernels for any parameter name: the public form
    of the ``upsampling*``-prefix dispatch (FCN-xs `init_fcnxs.py:20-34`)."""

    def __call__(self, name, arr):
        self._init_bilinear(name, arr)

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


class Load:
    """Initialize from a dict of saved arrays (or a file `ndarray.save`
    wrote), falling back to ``default_init`` (`initializer.py` Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load

            param = nd_load(param)
        self.param = {
            k[4:] if k.startswith(("arg:", "aux:")) else k: v
            for k, v in param.items()
        }
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError("Load: shape mismatch for %r" % name)
            _fill(arr, src.data if isinstance(src, NDArray) else src)
        else:
            if self.default_init is None:
                raise MXNetError("Load: no init for %r" % name)
            self.default_init(name, arr)


class Mixed:
    """Route each name to the first initializer whose regex matches it
    (`initializer.py` Mixed)."""

    def __init__(self, patterns, initializers):
        import re

        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(name):
                init(name, arr)
                return
        raise MXNetError("Mixed: no pattern matched %r; add a '.*' fallback"
                         % name)
