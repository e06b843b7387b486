"""Rematerialization: the policies that choose what a training step keeps
from its forward for its backward, and the regions they run in.

The port's counterpart of the `jax.checkpoint` policies behind
`mxnet_tpu/executor.py` `_mirror_policy`, as PyTorch's selective
checkpointing: a region runs under `torch.utils.checkpoint.checkpoint`
(``use_reentrant=False``) with a policy that marks each dispatched op's
output ``MUST_SAVE`` (kept from the forward) or ``PREFER_RECOMPUTE``
(recomputed in the backward from what was kept):

* `dots_saveable` keeps matrix products and convolutions (the ATen ops
  that `F.linear`, `matmul` and the convolutions reach), the rule of
  `_mirror_saveable`;
* `save_only_these_names` keeps the outputs tagged with the given names
  (`checkpoint_name`, and the flash forward's own ``name``);
* `nothing_saveable` keeps nothing.

A policy sees only dispatched ops.  The CUDA kernels launch through
ctypes, which no policy can see, so two of the port's ops are custom
ops:

* ``mxt::checkpoint_name(x, name)`` (`checkpoint_name`), a copy of ``x``
  that a policy keeps by name; it runs only inside a region whose policy
  keeps ``name``, and elsewhere the tag is ``x`` itself, as
  `jax.ad_checkpoint.checkpoint_name` is outside `jax.checkpoint`;
* ``mxt::flash_attention`` (`ops/pallas_kernels/flash_attention.py`),
  the differentiable flash forward, with its output's name, so that a
  policy that keeps ``attn_out`` keeps the kernel's out and lse and its
  backward launches no second forward.

`run_region` runs one region, with the names its policy keeps in force
in its forward and in its recompute alike.
"""
from __future__ import annotations

import functools
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["checkpoint_name", "named_op", "run_region",
           "dots_saveable", "save_only_these_names", "nothing_saveable"]

_state = threading.local()


def _kept():
    """The names that the policy of the region running on this thread
    keeps (its forward or its recompute); empty outside a region."""
    return getattr(_state, "names", frozenset())


@torch.library.custom_op("mxt::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


def _tag_backward(ctx, grad):
    return grad, None


_checkpoint_name.register_autograd(_tag_backward)


# the dispatched ops whose output carries a checkpoint name: op -> the
# position of the name among its arguments (`named_op`)
_NAMED = {}


def named_op(op, position):
    """Register ``op`` (an op overload) as one whose output is named by its
    argument at ``position``, for `save_only_these_names`."""
    _NAMED[op] = position


named_op(torch.ops.mxt.checkpoint_name.default, 1)


def checkpoint_name(x, name):
    """``x`` tagged ``name`` for `save_only_these_names`: inside a remat
    region whose policy keeps ``name``, a copy through the dispatched op
    ``mxt::checkpoint_name``; elsewhere ``x`` itself, so no other policy
    pays for the copy."""
    return _checkpoint_name(x, name) if name in _kept() else x


_MUST, _RECOMPUTE = CheckpointPolicy.MUST_SAVE, \
    CheckpointPolicy.PREFER_RECOMPUTE
_aten = torch.ops.aten
# the matrix products and convolutions, as a dispatch mode sees them
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                   _aten.baddbmm.default, _aten.mv.default,
                   _aten.dot.default, _aten.convolution.default})


def dots_saveable(ctx, func, *args, **kwargs):
    """Keep the results of matrix products and convolutions, recompute
    the rest (the JAX package's `_mirror_saveable`: ``dot_general`` and
    ``conv_general_dilated``; a kernel launched through ctypes, as a
    ``pallas_call`` there, is neither)."""
    return _MUST if func in _DOTS else _RECOMPUTE


def nothing_saveable(ctx, func, *args, **kwargs):
    """Keep nothing: the whole region is recomputed in its backward."""
    return _RECOMPUTE


def save_only_these_names(*names):
    """A policy keeping the outputs of the named ops (`named_op`:
    ``mxt::checkpoint_name`` and the flash forward) whose name is one of
    ``names``."""
    names = frozenset(names)

    def policy(ctx, func, *args, **kwargs):
        at = _NAMED.get(func)
        return _RECOMPUTE if at is None or args[at] not in names else _MUST

    policy.names = names
    return policy


def run_region(fn, policy, *args):
    """``fn(*args)`` as one remat region: under non-reentrant
    `checkpoint`, keeping what ``policy`` marks ``MUST_SAVE``, with the
    names it keeps (its ``names``) tagged whenever ``fn`` runs (the
    forward and the backward's recompute).  Randomness comes from generators that ``fn`` builds
    itself, so the recompute draws the same bits."""
    names = getattr(policy, "names", frozenset())

    def tagged(*a):
        outer = _kept()
        _state.names = names
        try:
            return fn(*a)
        finally:
            _state.names = outer

    return checkpoint(tagged, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, policy))
