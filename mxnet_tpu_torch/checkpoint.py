"""Checkpoints with optimizer state and atomic writes.

A port of the part of `mxnet_tpu/checkpoint.py` that `model.py` needs:
`save`, `load`, `latest_epoch` and `restore_updater`.  The files are the
JAX package's: ``prefix-symbol.json``, ``prefix-%04d.params`` in the
`ndarray.save` format with ``arg:``/``aux:`` names, the updater's
per-key optimizer state pickled as numpy in ``prefix-%04d.states``, and
``prefix-latest`` naming the last epoch whose files are complete.  Every
file is written to a temporary name and renamed into place.  The
mid-epoch auto-checkpoints (``save_auto``, ``load_auto``,
``restore_auto``) come with the fault-tolerance slice.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from . import ndarray as nd
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray

__all__ = ["save", "load", "latest_epoch", "restore_updater"]


def _atomic_write(path, write_fn):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_bytes(path, blob):
    with open(path, "wb") as f:
        f.write(blob)


def _states_to_host(states):
    """updater.states {key: state} -> a picklable numpy tree."""

    def conv(v):
        if isinstance(v, NDArray):
            return v.asnumpy()
        if isinstance(v, (tuple, list)):
            return type(v)(conv(x) for x in v)
        return v

    return {k: conv(v) for k, v in states.items()}


def _states_from_host(states, ctx):
    def conv(v):
        if isinstance(v, np.ndarray):
            return nd.array(v, ctx=ctx, dtype=v.dtype)
        if isinstance(v, (tuple, list)):
            return type(v)(conv(x) for x in v)
        return v

    return {k: conv(v) for k, v in states.items()}


def save(prefix, epoch, symbol, arg_params, aux_params, updater=None):
    """Write a checkpoint atomically; with the training ``updater``
    (`optimizer.get_updater`), its optimizer state too."""
    _atomic_write("%s-symbol.json" % prefix, symbol.save)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    _atomic_write("%s-%04d.params" % (prefix, epoch),
                  lambda p: nd.save(p, save_dict))
    if updater is not None:
        states = getattr(updater, "states", updater)
        blob = pickle.dumps(_states_to_host(states), protocol=4)
        _atomic_write("%s-%04d.states" % (prefix, epoch),
                      lambda p: _write_bytes(p, blob))
    # the marker last: readers trust only the epochs it names
    _atomic_write("%s-latest" % prefix,
                  lambda p: _write_bytes(p, str(epoch).encode()))


def latest_epoch(prefix):
    """The last completely written epoch, or None."""
    path = "%s-latest" % prefix
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def load(prefix, epoch=None, ctx=None):
    """(symbol, arg_params, aux_params, states or None, epoch); epoch None
    loads the latest complete checkpoint.  The optimizer state's arrays
    go on ``ctx`` (the CPU unless given)."""
    from . import symbol as sym_mod

    if epoch is None:
        epoch = latest_epoch(prefix)
        if epoch is None:
            raise MXNetError("no checkpoint at prefix %r" % prefix)
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        (arg_params if tp == "arg" else aux_params)[name] = v
    states = None
    spath = "%s-%04d.states" % (prefix, epoch)
    if os.path.exists(spath):
        with open(spath, "rb") as f:
            states = _states_from_host(pickle.loads(f.read()),
                                       ctx if ctx is not None else cpu())
    return symbol, arg_params, aux_params, states, epoch


def restore_updater(updater, states):
    """Install loaded optimizer state into a `get_updater` closure."""
    updater.states.clear()
    updater.states.update(states)
