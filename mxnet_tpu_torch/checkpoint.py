"""Checkpoints with optimizer state and atomic writes.

A port of `mxnet_tpu/checkpoint.py`: `save`, `load`, `latest_epoch`,
`restore_updater`, and the training loops' mid-epoch auto-checkpoint,
`save_auto`, `load_auto` and `restore_auto`.  The files are the JAX
package's: ``prefix-symbol.json``, ``prefix-%04d.params`` in the
`ndarray.save` format with ``arg:``/``aux:`` names, the updater's
per-key optimizer state pickled as numpy in ``prefix-%04d.states``,
``prefix-latest`` naming the last epoch whose files are complete, and
``prefix-auto.ckpt``, one pickle (``format: 1``) of the parameters, the
optimizer state and counts, the (epoch, nbatch) cursor, the iterator
position, the random state now and at the epoch's start, and the
nonfinite guard's applied-step counters (``guard_counts``), so that a
``fit(resume="auto")`` after a kill goes on exactly, in either package.
Each auto-checkpoint counts ``train.auto_checkpoints`` and records an
``auto_checkpoint`` event in `telemetry`.
Every file is written to a temporary name and renamed into place.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from . import ndarray as nd
from . import telemetry
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray

__all__ = ["save", "load", "latest_epoch", "restore_updater", "save_auto",
           "load_auto", "restore_auto"]


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


def save_auto(prefix, arg_params, aux_params, updater=None, epoch=0,
              nbatch=0, epoch_rng=None, iter_pos=None, extra=None):
    """Write ``prefix``-auto.ckpt atomically and return its size in bytes.
    ``nbatch`` counts the finished batches of ``epoch``; ``epoch_rng`` is
    the `random.get_state` taken just before the epoch's iterator reset
    (a resume replays the epoch's shuffle from it); ``iter_pos`` is the
    number of batches the loop consumed since that reset (``nbatch``
    unless an ``epoch_size`` cut the pass).  ``updater``'s state, its
    optimizer's update counts and lr go with it."""
    from . import random as _random

    state = {
        "format": 1,
        "arg": {k: v.asnumpy() for k, v in arg_params.items()},
        "aux": {k: v.asnumpy() for k, v in aux_params.items()},
        "epoch": int(epoch),
        "nbatch": int(nbatch),
        "iter_pos": int(nbatch if iter_pos is None else iter_pos),
        "rng": _random.get_state(),
        "epoch_rng": epoch_rng,
        "extra": dict(extra or {}),
    }
    if updater is not None:
        states = getattr(updater, "states", None)
        if states is not None:
            state["states"] = _states_to_host(states)
        opt = getattr(updater, "optimizer", None)
        if opt is not None:
            state["opt_counts"] = (dict(opt._index_update_count),
                                   int(opt.num_update))
            state["opt_lr"] = float(opt.lr)
            # the guard's applied-step counters (they lag the host counts
            # by the skipped steps): without them a resume would re-seed
            # from the host counts and count the skips in Adam's bias
            # correction
            guard_counts = getattr(opt, "_guard_counts", None)
            if guard_counts:
                state["guard_counts"] = {
                    k: _host_counts(v) for k, v in guard_counts.items()}
    blob = pickle.dumps(state, protocol=4)
    _atomic_write("%s-auto.ckpt" % prefix, lambda p: _write_bytes(p, blob))
    telemetry.inc("train.auto_checkpoints")
    telemetry.record_event("auto_checkpoint", epoch=int(epoch),
                           nbatch=int(nbatch))
    return len(blob)


def _host_counts(counts):
    """A guard counter (a device tensor, or numpy from a restore) as the
    float32 numpy array the JAX package saves."""
    if hasattr(counts, "cpu"):
        counts = counts.cpu().numpy()
    return np.asarray(counts, np.float32)


def load_auto(prefix):
    """``prefix``-auto.ckpt as written, or None if there is none: the
    parameters and the optimizer state as NDArrays on the CPU (`restore_auto`
    places each state), the cursor and random states as saved."""
    path = "%s-auto.ckpt" % prefix
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        state = pickle.loads(f.read())
    state["arg"] = {k: nd.array(v, ctx=cpu(), dtype=v.dtype)
                    for k, v in state["arg"].items()}
    state["aux"] = {k: nd.array(v, ctx=cpu(), dtype=v.dtype)
                    for k, v in state["aux"].items()}
    if state.get("states") is not None:
        state["states"] = _states_from_host(state["states"], cpu())
    return state


def restore_auto(state, updater=None, ctx_of=None):
    """Install a `load_auto` result's optimizer state into a new
    ``updater``: each key's state (moved to ``ctx_of(key)`` where that is
    given and not None), the update counts and the lr."""
    if updater is None or state is None:
        return
    if state.get("states") is not None and hasattr(updater, "states"):
        states = state["states"]
        if ctx_of is not None:
            states = {k: _as_in(v, ctx_of(k)) for k, v in states.items()}
        updater.states.clear()
        updater.states.update(states)
    opt = getattr(updater, "optimizer", None)
    counts = state.get("opt_counts")
    if opt is not None and counts is not None:
        opt._index_update_count = dict(counts[0])
        opt.num_update = int(counts[1])
    if opt is not None and state.get("opt_lr") is not None:
        opt.lr = state["opt_lr"]
    if opt is not None and state.get("guard_counts"):
        # host numpy: update_multi copies each counter to its bucket's
        # device at its next use
        opt._guard_counts = {
            tuple(k): np.asarray(v, np.float32)
            for k, v in state["guard_counts"].items()}


def _as_in(state, ctx):
    """An optimizer state (None, an NDArray or a tuple of them) on
    ``ctx``."""
    if ctx is None or state is None:
        return state
    if isinstance(state, (tuple, list)):
        return type(state)(_as_in(s, ctx) for s in state)
    return state.as_in_context(ctx)
