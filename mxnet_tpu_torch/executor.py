"""The graph function of a Symbol.

A port of `mxnet_tpu/executor.py` `_build_graph_fn`'s plain walk: the
symbol's nodes in topological order become one function over torch
tensors, ``fn(args, aux, rng, is_train) -> (outputs, new_aux)``, which
runs eagerly and differentiates through torch autograd (the JAX package
traces the same walk under `jax.vjp`).

``rng`` is a key of `random` (a pair of uint32 words) or None.  A node
whose op draws random numbers (``need_rng``) gets a `torch.Generator` on
the arguments' device, seeded from ``fold_in(rng, node position)`` where
the JAX package hands it ``jax.random.fold_in(rng, position)``: the same
structure, PyTorch's own draws.  The rematerialization segments
(``MXNET_BACKWARD_MIRROR_STEP``), the `Executor` and the AOT cache wait
for a later slice.
"""
from __future__ import annotations

import torch

from . import random as _random
from .ops.registry import OpCtx
from .symbol import _topo_order

__all__ = ["_build_graph_fn"]


def _build_graph_fn(symbol):
    """fn(arg_tensors, aux_tensors, rng, is_train) -> (outputs, new_aux)
    for ``symbol``; arguments in `list_arguments` order, aux states in
    `list_auxiliary_states` order."""
    heads = symbol._heads
    order = _topo_order(heads)
    arg_index = {n: i for i, n in enumerate(symbol.list_arguments())}
    # aux slots per node, in the same global order as list_auxiliary_states()
    aux_slots = {}
    n_aux = 0
    for node in order:
        if not node.is_variable:
            k = len(node.op.list_aux(node.params))
            if k:
                aux_slots[id(node)] = (n_aux, n_aux + k)
                n_aux += k
    seq_of = {id(node): seq for seq, node in enumerate(order)}

    def fn(arg_arrays, aux_arrays, rng, is_train):
        env = {}
        new_aux = list(aux_arrays)
        device = arg_arrays[0].device if arg_arrays else None
        for node in order:
            if node.is_variable:
                env[(id(node), 0)] = arg_arrays[arg_index[node.name]]
                continue
            inputs = [env[(id(s), i)] for s, i in node.inputs]
            lo, hi = aux_slots.get(id(node), (0, 0))
            gen = None
            if getattr(node.op, "need_rng", False) and rng is not None:
                key = _random.fold_in(rng, seq_of[id(node)])
                gen = torch.Generator(device=device)
                gen.manual_seed(_random.key_seed(key))
            outs, aux_up = node.op.apply(OpCtx(is_train=is_train, rng=gen),
                                         node.params, inputs, new_aux[lo:hi])
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
            for i, u in enumerate(aux_up):
                if u is not None:
                    new_aux[lo + i] = u
        outputs = tuple(env[(id(n), i)] for n, i in heads)
        return outputs, tuple(new_aux)

    return fn
