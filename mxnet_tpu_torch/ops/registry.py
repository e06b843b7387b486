"""Operator registry: metadata + PyTorch bodies.

A port of `mxnet_tpu/ops/registry.py` (the reference's
`include/mxnet/operator.h` `Operator`/`OperatorProperty` and the simple-op
registry of `operator_util.h`).  An operator is a function over tensors
plus metadata:

* ``apply(octx, params, inputs, aux) -> (outputs, aux_updates)`` takes and
  returns torch tensors.  Backward is torch autograd; ops whose training
  gradient is *not* the autodiff of their forward (SoftmaxOutput) use a
  `torch.autograd.Function` inside ``apply``, as the JAX ops use
  `jax.custom_vjp`.
* ``infer_shape`` completes shapes forward and backward from the data
  shapes alone, with the JAX package's rules, so both packages give a
  symbol the same argument shapes.
* ``key_var_num_args`` names the count parameter of an op that takes a
  variable number of inputs (`Concat`, `ElementWiseSum`, `Crop`,
  `UpSampling`); the symbol factories and `mx.nd` fill it in.  An op
  whose outputs are not all visible (`BatchNorm`: output, mean, var)
  defines ``num_visible_outputs(params)``.

The registry is the port's own: it holds only the ops the port defines.
"""
from __future__ import annotations

from ..base import MXNetError, check_shape

_REGISTRY: dict[str, "OpDef"] = {}


class OpCtx:
    """Per-call context threaded through ``apply``: the training flag and
    the op's random generator.

    ``rng`` is a `torch.Generator` on the op's device (or None), seeded by
    the graph function from the step seed and the node's position, where
    the JAX package hands each op a folded PRNG key.
    """

    __slots__ = ("is_train", "rng")

    def __init__(self, is_train=False, rng=None):
        self.is_train = is_train
        self.rng = rng

    def require_rng(self):
        if self.rng is None:
            raise MXNetError("operator requires a random generator but none "
                             "was provided")
        return self.rng


class Param:
    """Typed keyword parameter (dmlc::Parameter analogue, `base.h:227-276`)."""

    __slots__ = ("type", "default", "required")

    def __init__(self, type, default=None, required=False):
        self.type = type
        self.default = default
        self.required = required

    def parse(self, value):
        t = self.type
        if t is bool:
            if isinstance(value, str):
                return value.lower() in ("true", "1")
            return bool(value)
        if t == "shape":
            return check_shape(value) if value is not None else None
        if t is float:
            return float(value)
        if t is int:
            return int(value)
        if t is str:
            return str(value)
        return value


class OpDef:
    """Base class for operator definitions.  Subclass and register()."""

    name: str = None
    params: dict = {}
    # variable-arity input op (Concat/ElementWiseSum): name of the count param
    key_var_num_args: str = None
    need_rng: bool = False

    # -- metadata ---------------------------------------------------------
    def list_arguments(self, params):
        return ["data"]

    def list_outputs(self, params):
        return ["output"]

    def list_aux(self, params):
        return []

    def parse_params(self, kwargs):
        out = {}
        kwargs = dict(kwargs)
        for pname, p in self.params.items():
            if pname in kwargs:
                out[pname] = p.parse(kwargs.pop(pname))
            elif p.required:
                raise MXNetError("%s: required parameter %r missing" % (self.name, pname))
            else:
                out[pname] = p.default
        if kwargs:
            raise MXNetError("%s: unknown parameters %s" % (self.name, sorted(kwargs)))
        return out

    # -- shape/type inference --------------------------------------------
    def infer_shape(self, params, in_shapes):
        """Complete shapes.  ``in_shapes``: list aligned with list_arguments,
        entries are tuples or None.  Returns (in_shapes, out_shapes,
        aux_shapes); any entry may be None if not yet inferable."""
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d] * len(in_shapes), [d], []

    def infer_type(self, params, in_types):
        """(in_types, out_types, aux_types): every entry takes the first
        known input type (the JAX package's default rule)."""
        known = [t for t in in_types if t is not None]
        if not known:
            return in_types, [None] * len(self.list_outputs(params)), []
        t = known[0]
        return ([t] * len(in_types), [t] * len(self.list_outputs(params)),
                [t] * len(self.list_aux(params)))

    # -- compute ----------------------------------------------------------
    def apply(self, octx: OpCtx, params, inputs, aux):
        """Tensors in -> (list of outputs, list of aux updates (same
        length as list_aux; None = unchanged))."""
        raise NotImplementedError(self.name)


def register(op_cls_or_def, aliases=()):
    """Register an OpDef (class or instance).  Returns the instance."""
    op = op_cls_or_def() if isinstance(op_cls_or_def, type) else op_cls_or_def
    if not op.name:
        raise MXNetError("op must have a name")
    _REGISTRY[op.name] = op
    for a in aliases:
        _REGISTRY[a] = op
    return op


def get(name: str) -> OpDef:
    if name not in _REGISTRY:
        raise MXNetError("unknown operator %r" % name)
    return _REGISTRY[name]


def list_ops():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Declarative helpers for the "simple op" families
# (`src/operator/elementwise_*`, `broadcast_reduce_op`): one-liner
# registrations that surface in both mx.nd and mx.sym.
# ---------------------------------------------------------------------------


class _UnaryOp(OpDef):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn
        self.params = {}

    def apply(self, octx, params, inputs, aux):
        return [self._fn(inputs[0])], []


class _BinaryOp(OpDef):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn
        self.params = {}

    def list_arguments(self, params):
        return ["lhs", "rhs"]

    def infer_shape(self, params, in_shapes):
        a, b = in_shapes
        s = a if a is not None else b
        if a is not None and b is not None and a != b:
            raise MXNetError(
                "%s: shape mismatch %s vs %s" % (self.name, a, b)
            )
        return [s, s], [s], []

    def apply(self, octx, params, inputs, aux):
        return [self._fn(inputs[0], inputs[1])], []


class _ScalarOp(OpDef):
    """op(tensor, scalar) with optional reverse
    (`elementwise_binary_scalar_op`)."""

    params = {"scalar": Param(float, required=True)}

    def __init__(self, name, fn, reverse=False):
        self.name = name
        self._fn = fn
        self._reverse = reverse

    def apply(self, octx, params, inputs, aux):
        s, a = params["scalar"], inputs[0]
        return [self._fn(s, a) if self._reverse else self._fn(a, s)], []


def register_unary(name, fn, aliases=()):
    return register(_UnaryOp(name, fn), aliases=aliases)


def register_binary(name, fn, aliases=()):
    return register(_BinaryOp(name, fn), aliases=aliases)


def register_scalar(name, fn, reverse=False, aliases=()):
    return register(_ScalarOp(name, fn, reverse=reverse), aliases=aliases)
