"""Operators of the port.  Importing this package registers every op.

The registry (`registry`) holds the JAX package's op set under its names:
`elementwise`, `tensor`, `nn`, `loss` and the attention ops of
`attention`, which also holds the serving attention helpers (plain
torch).  The hand-written kernels live under `pallas_kernels`.

Like the JAX package's, the registry drives both API surfaces:
`populate_nd(ns)` makes the imperative functions on NDArrays (`mx.nd.*`,
the reference's `_init_ndarray_module`) and `symbol.populate(ns)` the
symbol factories (`mx.sym.*`).
"""
from __future__ import annotations

from . import registry
from . import elementwise  # noqa: F401  (registers ops)
from . import nn  # noqa: F401
from . import tensor  # noqa: F401
from . import loss  # noqa: F401
from . import attention  # noqa: F401
from .registry import OpCtx, OpDef, Param, get, list_ops, register

__all__ = ["OpCtx", "OpDef", "Param", "get", "list_ops", "populate_nd",
           "register"]


def _make_nd_function(op):
    import torch

    from .. import random as _random
    from ..ndarray import NDArray

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        inputs, params = [], {}
        for a in args:
            if not isinstance(a, NDArray):
                raise TypeError(
                    "%s: positional args must be NDArrays; pass params by name"
                    % op.name)
            inputs.append(a)
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                inputs.append(v)
            else:
                params[k] = v
        if op.key_var_num_args and op.key_var_num_args not in params:
            params[op.key_var_num_args] = len(inputs)
        parsed = op.parse_params(params)
        if op.list_aux(parsed):
            raise registry.MXNetError(
                "%s holds auxiliary state; use the symbolic API" % op.name)
        gen = None
        if op.need_rng and inputs:
            gen = torch.Generator(device=inputs[0].data.device)
            gen.manual_seed(_random.key_seed(_random.next_key()))
        with torch.no_grad():
            outs, _ = op.apply(registry.OpCtx(is_train=False, rng=gen),
                               parsed, [i.data for i in inputs], [])
        ctx = inputs[0].context if inputs else None
        results = [NDArray(o, ctx) for o in outs]
        if out is not None:
            if len(results) != 1:
                raise registry.MXNetError("%s: out= needs single output"
                                          % op.name)
            results[0].copyto(out)
            return out
        return results[0] if len(results) == 1 else results

    fn.__name__ = op.name
    fn.__doc__ = (op.__doc__ or "") + "\n\nImperative form (auto-generated)."
    return fn


def populate_nd(namespace):
    """Attach an imperative function for every registered op."""
    seen = {}
    for name in registry.list_ops():
        op = registry.get(name)
        if id(op) not in seen:
            seen[id(op)] = _make_nd_function(op)
        namespace[name] = seen[id(op)]
