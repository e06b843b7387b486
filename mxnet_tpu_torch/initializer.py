"""Weight initializers.

A port of `mxnet_tpu/initializer.py` `Initializer` (the reference's
`python/mxnet/initializer.py`): an initializer is called as
``init(name, arr)`` and routes on the parameter name's suffix (bias,
gamma, beta and moving statistics get fixed values; weights get the
strategy), and `Uniform`.  ``arr`` is a numpy array or a torch tensor,
filled in place; a tensor's draw runs on its own device.  After
`random.seed(s)`, `Uniform` draws the JAX package's values bit for bit,
one key per weight in the order it is called.
"""
from __future__ import annotations

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform"]


def _fill(arr, value):
    """Write ``value`` (a scalar or a CPU/same-device tensor) into arr."""
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


class Uniform(Initializer):
    """U[-scale, scale] (`initializer.py:147`), drawn with the next key of
    `random`."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        device = arr.device if isinstance(arr, torch.Tensor) else None
        bits = _random.random_bits(_random.next_key(), tuple(arr.shape),
                                   device)
        _fill(arr, _random.uniform_from_bits(bits, -self.scale, self.scale))
