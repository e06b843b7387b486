"""Symbolic graph layer.

A port of `mxnet_tpu/symbol.py` (the reference's `src/symbol/symbol.cc`
and `include/mxnet/symbolic.h:40-310`): the Symbol is a Python DAG whose
nodes point at the port's registry OpDefs.  `executor._build_graph_fn`
walks it into one function over torch tensors.  Shape inference walks
the DAG with the per-op `infer_shape` rules, so a trainer can build its
parameters from the data shapes alone.

The JSON wire format is the JAX package's (the reference's
``nodes``/``arg_nodes``/``heads``, op "null" for variables): a symbol
saved by either package loads in the other.  The arithmetic operators
(``+ - * / **``, unary ``-``) build the registry's binary ops between
symbols and its scalar ops (with their reversed forms) against a
number.  A symbol indexes, iterates and counts its outputs, and
`get_internals` groups every visible output of the graph.  An op with
hidden outputs (`BatchNorm`) shows only its visible ones.  `simple_bind`
and `bind` make an `executor.Executor`; `infer_type` propagates dtypes
forward with each op's rule; `attr_dict` feeds the optimizers' lr/wd
multipliers.
"""
from __future__ import annotations

import ast
import json

import numpy as np

from . import attribute, name as _name_mod
from . import ops as _registered  # noqa: F401  (registers every op)
from .base import MXNetError, check_shape, np_dtype
from .ops import registry as _ops


class _Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "params", "inputs", "attrs")

    def __init__(self, op, name, params=None, inputs=None, attrs=None):
        self.op = op  # OpDef or None for variables
        self.name = name
        self.params = params or {}
        self.inputs = inputs or []  # list of (_Node, out_index)
        self.attrs = dict(attrs) if attrs else {}

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.is_variable else len(self.op.list_outputs(self.params))

    def num_visible_outputs(self):
        if self.is_variable:
            return 1
        nv = getattr(self.op, "num_visible_outputs", None)
        return nv(self.params) if nv else self.num_outputs()


def _topo_order(heads):
    """Post-DFS order over nodes (reference `StaticGraph::PostDFSOrder`)."""
    order, visited = [], set()

    def visit(node):
        if id(node) in visited:
            return
        visited.add(id(node))
        for src, _ in node.inputs:
            visit(src)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


class Symbol:
    """An immutable handle to one or more output entries of the DAG."""

    __slots__ = ("_heads",)

    def __init__(self, heads):
        self._heads = list(heads)

    # -- composition helpers ---------------------------------------------
    @staticmethod
    def _entry(sym):
        if len(sym._heads) != 1:
            raise MXNetError("expect a single-output symbol here")
        return sym._heads[0]

    # -- introspection ----------------------------------------------------
    @property
    def name(self):
        node, idx = self._heads[0]
        return node.name

    def list_arguments(self):
        return [n.name for n in _topo_order(self._heads) if n.is_variable]

    def list_outputs(self):
        out = []
        for node, idx in self._heads:
            if node.is_variable:
                out.append(node.name)
            else:
                out.append("%s_%s" % (node.name, node.op.list_outputs(node.params)[idx]))
        return out

    def list_auxiliary_states(self):
        out = []
        for node in _topo_order(self._heads):
            if not node.is_variable:
                for aux in node.op.list_aux(node.params):
                    out.append("%s_%s" % (node.name, aux))
        return out

    def get_internals(self):
        """Every visible output of the graph, grouped (`symbolic.h`
        GetInternals)."""
        return Symbol([(node, i) for node in _topo_order(self._heads)
                       for i in range(node.num_visible_outputs())])

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("no output named %r" % index)
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (Symbol([h]) for h in self._heads)

    # -- attributes -------------------------------------------------------
    def attr_dict(self):
        """{node name: its attributes} over every node that has some."""
        return {node.name: dict(node.attrs)
                for node in _topo_order(self._heads) if node.attrs}

    # -- arithmetic (creates registry ops, like ndarray) -------------------
    def _binop(self, other, opname, scalar_opname, rscalar_opname=None,
               reverse=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _create(opname, [lhs, rhs], {})
        if isinstance(other, (int, float, np.generic)):
            op = (rscalar_opname or scalar_opname) if reverse else \
                scalar_opname
            return _create(op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, other):
        return self._binop(other, "_Plus", "_PlusScalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "_Minus", "_MinusScalar", "_RMinusScalar")

    def __rsub__(self, other):
        return self._binop(other, "_Minus", "_MinusScalar", "_RMinusScalar",
                           reverse=True)

    def __mul__(self, other):
        return self._binop(other, "_Mul", "_MulScalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "_Div", "_DivScalar", "_RDivScalar")

    def __rtruediv__(self, other):
        return self._binop(other, "_Div", "_DivScalar", "_RDivScalar",
                           reverse=True)

    def __pow__(self, other):
        return self._binop(other, "_Power", "_PowerScalar", "_RPowerScalar")

    def __neg__(self):
        return self * -1.0

    def __repr__(self):
        return "<Symbol %s>" % self.name

    # -- shape / type inference -------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) or (None, None, None) if
        under-determined (`symbol.py:329` in the reference)."""
        arg_names = self.list_arguments()
        known = {}
        if args:
            if len(args) > len(arg_names):
                raise MXNetError("too many positional shapes")
            for n, s in zip(arg_names, args):
                if s is not None:
                    known[n] = check_shape(s)
        for k, v in kwargs.items():
            if k not in arg_names:
                raise MXNetError("infer_shape: %r is not an argument (args: %s)"
                                 % (k, arg_names))
            known[k] = check_shape(v)

        entry_shape = {}  # (id(node), idx) -> shape or None
        node_aux = {}  # id(node) -> aux shapes
        var_shape = dict(known)

        order = _topo_order(self._heads)
        # iterate to fixpoint: backward-completed input shapes (e.g. weights)
        # feed into earlier nodes only via variables, so 2 passes suffice
        for _ in range(2):
            changed = False
            for node in order:
                if node.is_variable:
                    s = var_shape.get(node.name)
                    if s is None and node.attrs.get("__shape__"):
                        # shape hint given at Variable() creation time
                        s = check_shape(ast.literal_eval(node.attrs["__shape__"]))
                        var_shape[node.name] = s
                    if entry_shape.get((id(node), 0)) != s:
                        entry_shape[(id(node), 0)] = s
                        changed = True
                    continue
                in_shapes = [entry_shape.get((id(s), i)) for s, i in node.inputs]
                try:
                    new_in, outs, auxs = node.op.infer_shape(node.params, in_shapes)
                except MXNetError:
                    raise
                # write back completed input shapes into variables
                for (src, i), s in zip(node.inputs, new_in):
                    if s is not None and entry_shape.get((id(src), i)) is None:
                        entry_shape[(id(src), i)] = tuple(s)
                        if src.is_variable:
                            var_shape[src.name] = tuple(s)
                        changed = True
                for i, s in enumerate(outs):
                    key = (id(node), i)
                    if s is not None and entry_shape.get(key) != tuple(s):
                        entry_shape[key] = tuple(s)
                        changed = True
                node_aux[id(node)] = auxs
            if not changed:
                break

        arg_shapes = [var_shape.get(n) for n in arg_names]
        out_shapes = [entry_shape.get((id(n), i)) for n, i in self._heads]
        aux_shapes = []
        for node in order:
            if not node.is_variable:
                naux = len(node.op.list_aux(node.params))
                got = node_aux.get(id(node)) or [None] * naux
                aux_shapes.extend(got[:naux] + [None] * (naux - len(got)))
        if any(s is None for s in arg_shapes) or any(s is None for s in out_shapes):
            return None, None, None
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types): numpy dtypes propagated
        forward by each op's rule, float32 where nothing is given
        (`symbol.py:440` in the reference)."""
        arg_names = self.list_arguments()
        known = {n: np_dtype(t) for n, t in zip(arg_names, args)
                 if t is not None}
        known.update({k: np_dtype(v) for k, v in kwargs.items()})
        f32 = np.dtype(np.float32)
        entry_t = {}
        for node in _topo_order(self._heads):
            if node.is_variable:
                entry_t[(id(node), 0)] = known.get(node.name, f32)
            else:
                in_t = [entry_t.get((id(s), i)) for s, i in node.inputs]
                _, outs, _ = node.op.infer_type(node.params, in_t)
                for i, t in enumerate(outs):
                    entry_t[(id(node), i)] = t
        arg_types = [known.get(n, f32) for n in arg_names]
        out_types = [entry_t.get((id(n), i)) for n, i in self._heads]
        aux_types = [f32] * len(self.list_auxiliary_states())
        return arg_types, out_types, aux_types

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **kwargs):
        """Allocate the arguments (``type_dict`` dtypes, float32 else),
        gradients (float32) and aux states from the shapes inferred from
        ``kwargs``, on ``ctx`` (`current_context()` if None), and bind
        (`python/mxnet/symbol.py:616`)."""
        from .context import current_context
        from .executor import Executor
        from .ndarray import zeros

        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("simple_bind: cannot infer shapes from %s"
                             % kwargs)
        type_dict = type_dict or {}
        args = [zeros(s, ctx=ctx, dtype=type_dict.get(n, np.float32))
                for n, s in zip(self.list_arguments(), arg_shapes)]
        args_grad = None
        if grad_req != "null":
            args_grad = [zeros(s, ctx=ctx) for s in arg_shapes]
        aux = [zeros(s, ctx=ctx) for s in aux_shapes]
        return Executor(self, ctx, args, args_grad, grad_req, aux,
                        group2ctx=group2ctx)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind the given NDArrays (`python/mxnet/symbol.py:672`)."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    # -- serialization -----------------------------------------------------
    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def tojson(self):
        """Reference-compatible JSON (`nodes`/`arg_nodes`/`heads`)."""
        order = _topo_order(self._heads)
        nid = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            if n.is_variable:
                nodes.append({"op": "null", "param": {}, "name": n.name,
                              "inputs": [], "backward_source_id": -1,
                              **({"attr": n.attrs} if n.attrs else {})})
            else:
                param = {k: _param_str(v) for k, v in n.params.items() if v is not None}
                nodes.append({
                    "op": n.op.name,
                    "param": param,
                    "name": n.name,
                    "inputs": [[nid[id(s)], i] for s, i in n.inputs],
                    "backward_source_id": -1,
                    **({"attr": n.attrs} if n.attrs else {}),
                })
        arg_nodes = [i for i, n in enumerate(order) if n.is_variable]
        heads = [[nid[id(n)], i] for n, i in self._heads]
        return json.dumps(
            {"nodes": nodes, "arg_nodes": arg_nodes, "heads": heads}, indent=2
        )

def _param_str(v):
    if isinstance(v, tuple):
        return "(" + ",".join(str(x) for x in v) + ")"
    return str(v)


def _parse_param_str(s):
    s = s.strip()
    if s.startswith("("):
        inner = s[1:-1].strip().rstrip(",")
        if not inner:
            return ()
        return tuple(int(float(x)) for x in inner.split(","))
    return s


# ---------------------------------------------------------------------------
# Symbol creation
# ---------------------------------------------------------------------------


def Variable(name, attr=None, shape=None, **kwargs):
    """Create a variable symbol (`mx.sym.Variable`); ``lr_mult`` and
    ``wd_mult`` become the optimizers' per-parameter multipliers."""
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    attrs = attribute.current().get(attr)
    if shape is not None:
        # normalize (numpy ints etc.) so ast.literal_eval can parse it back
        attrs["__shape__"] = str(tuple(int(d) for d in shape))
    for k, v in kwargs.items():
        if k not in ("lr_mult", "wd_mult"):
            raise MXNetError("Variable: unknown argument %r" % k)
        attrs["__%s__" % k] = str(v)
    return Symbol([(_Node(None, name, attrs=attrs), 0)])


def Group(symbols):
    """Group symbols into one multi-output symbol (`mx.sym.Group`)."""
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def _resolve_name(op, name):
    return _name_mod.current().get(name, op.name.lower().lstrip("_"))


def _create(op_name, input_syms, params, name=None, attr=None):
    op = _ops.get(op_name)
    parsed = op.parse_params(params)
    attrs = attribute.current().get(attr)
    name = _resolve_name(op, name)
    inputs = [Symbol._entry(s) for s in input_syms]
    node = _Node(op, name, parsed, inputs, attrs)
    return Symbol([(node, i) for i in range(node.num_visible_outputs())])


def _make_factory(op: "_ops.OpDef"):
    def factory(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        # split kwargs into symbol inputs vs op params
        sym_kwargs, params = {}, {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                params[k] = v
        pos_syms = [a for a in args if isinstance(a, Symbol)]
        if len(pos_syms) != len(args):
            raise MXNetError(
                "%s: positional args must be Symbols; pass params by name"
                % op.name
            )
        if op.key_var_num_args and op.key_var_num_args not in params:
            params[op.key_var_num_args] = len(pos_syms) + len(sym_kwargs)
        parsed = op.parse_params(params)
        arg_names = op.list_arguments(parsed)
        inputs = [None] * len(arg_names)
        # positional fill first, then by-name
        for i, s in enumerate(pos_syms):
            if i >= len(arg_names):
                raise MXNetError("%s: too many inputs" % op.name)
            inputs[i] = s
        for k, v in sym_kwargs.items():
            if k not in arg_names:
                raise MXNetError("%s: unknown input %r (expects %s)"
                                 % (op.name, k, arg_names))
            inputs[arg_names.index(k)] = v
        name = _resolve_name(op, name)
        # unbound inputs become implicit variables named <node>_<arg>, like
        # the reference's auto-created weight/bias/label variables
        for i, s in enumerate(inputs):
            if s is None:
                inputs[i] = Variable("%s_%s" % (name, arg_names[i]))
        return _create(op.name, inputs, params, name=name, attr=attr)

    factory.__name__ = op.name
    factory.__doc__ = (op.__doc__ or "") + "\n\nAuto-generated from the op registry."
    return factory


def load(fname):
    """Load a symbol from a JSON file (`Symbol.save`)."""
    with open(fname) as f:
        return loads(f.read())


def loads(json_str):
    """Load a symbol from reference-format JSON."""
    data = json.loads(json_str)
    nodes = []
    for spec in data["nodes"]:
        if spec["op"] == "null":
            node = _Node(None, spec["name"], attrs=spec.get("attr"))
        else:
            op = _ops.get(spec["op"])
            params = {k: _parse_param_str(v) for k, v in spec.get("param", {}).items()}
            parsed = op.parse_params(params)
            inputs = [(nodes[i], idx) for i, idx, *_ in spec["inputs"]]
            node = _Node(op, spec["name"], parsed, inputs, spec.get("attr"))
        nodes.append(node)
    heads = [(nodes[i], idx) for i, idx, *_ in data["heads"]]
    return Symbol(heads)


def populate(namespace):
    """Attach a factory for every registered op (the reference's
    `_init_symbol_module`, `python/mxnet/symbol.py`)."""
    seen = {}
    for opname in _ops.list_ops():
        op = _ops.get(opname)
        if id(op) not in seen:
            seen[id(op)] = _make_factory(op)
        namespace[opname] = seen[id(op)]


populate(globals())
