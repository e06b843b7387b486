"""The port's elementwise, scalar, reduction and product ops, its
imperative `mx.nd.<op>` functions and its Symbol operators against the
JAX package's, on the CPU.

* A parametrized sweep over `mxnet_tpu/ops/elementwise.py`, as
  `tests/test_op_registry_sweep.py` sweeps the registry, holding values
  and gradients (one random cotangent) against the JAX op on the same
  numpy inputs, and every alias to the same op in both packages.
* `mx.nd.<op>` for every op of the sweep and a few layers against the JAX
  package's `mx.nd`, the ``out=`` keyword, and the refusal of ops with
  aux state.
* Symbol arithmetic (``+ - * / **``, unary ``-``, scalars on either
  side), indexing, iteration, `get_internals`, and the variable-arity
  count: the same ops, arguments, outputs and JSON as the JAX package's.

Tolerance: float32 on both sides with the same formulas, 1e-5 absolute
and 1e-6 relative on values of magnitude ~1 (`tests/test_torch_ops.py`);
the matrix products and whole-tensor reductions sum up to 60 terms in
another order, held at rtol 1e-5.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

ATOL, RTOL = 1e-5, 1e-6

BINARY = ["_Plus", "_Minus", "_Mul", "_Div", "_Power", "_Maximum",
          "_Minimum"]
SCALAR = ["_PlusScalar", "_MinusScalar", "_RMinusScalar", "_MulScalar",
          "_DivScalar", "_RDivScalar", "_PowerScalar", "_RPowerScalar",
          "_MaximumScalar", "_MinimumScalar"]
UNARY = ["abs", "sign", "round", "ceil", "floor", "square", "sqrt",
         "rsqrt", "exp", "log", "cos", "sin", "negative", "sigmoid",
         "relu", "tanh"]
# ops whose inputs must be positive (roots, logs, powers, divisors)
POSITIVE = {"_Div", "_Power", "_RDivScalar", "_PowerScalar",
            "_RPowerScalar", "sqrt", "rsqrt", "log", "broadcast_div"}


def _input(name, shape, seed):
    rng = np.random.RandomState(seed)
    if name in POSITIVE:
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return (rng.randn(*shape) * 1.5).astype(np.float32)


# (name, params, input shapes, rtol)
CASES = (
    [(n, {}, [(3, 4), (3, 4)], RTOL) for n in BINARY]
    + [(n, {"scalar": 1.7}, [(3, 4)], RTOL) for n in SCALAR]
    + [(n, {}, [(3, 4)], RTOL) for n in UNARY]
    + [("clip", {"a_min": -0.5, "a_max": 0.8}, [(4, 5)], RTOL),
       ("dot", {}, [(3, 4), (4, 5)], 1e-5),
       ("batch_dot", {}, [(2, 3, 4), (2, 4, 5)], 1e-5),
       ("broadcast_plus", {}, [(2, 3, 4), (1, 3, 1)], RTOL),
       ("broadcast_minus", {}, [(2, 3, 4), (2, 1, 4)], RTOL),
       ("broadcast_mul", {}, [(2, 3, 4), (3, 4)], RTOL),
       ("broadcast_div", {}, [(2, 3, 4), (1, 1, 4)], RTOL),
       ("argmax_channel", {}, [(4, 6)], RTOL),
       ("smooth_l1", {"scalar": 1.5}, [(4, 5)], RTOL),
       ("transpose", {"axes": (1, 2, 0)}, [(2, 3, 4)], RTOL)]
    + [(n, p, [(2, 3, 4)], 1e-5)
       for n in ("sum", "max", "min", "norm")
       for p in ({}, {"axis": (1,)}, {"axis": (0, 2), "keepdims": True},
                 {"axis": (0, 1, 2)})])


def _ids(case):
    return "%s-%s" % (case[0], "-".join("%s=%s" % kv for kv in
                                        sorted(case[1].items())))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_op_matches_jax(case):
    name, params, shapes, rtol = case
    inputs = [_input(name, s, seed=i) for i, s in enumerate(shapes)]
    jop, top = jreg.get(name), treg.get(name)
    jp, tp = jop.parse_params(params), top.parse_params(params)
    assert top.list_arguments(tp) == jop.list_arguments(jp)
    assert top.infer_shape(tp, list(shapes)) == jop.infer_shape(jp,
                                                                list(shapes))

    def jfn(*a):
        return jop.apply(jreg.OpCtx(), jp, list(a), [])[0][0]

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in inputs))
    cot = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    tout = top.apply(treg.OpCtx(), tp, targs, [])[0][0]
    assert tuple(tout.shape) == tuple(jout.shape)
    assert tout.dtype == torch.float32
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=rtol)
    if tout.requires_grad:
        tout.backward(torch.from_numpy(cot))
    for t, g in zip(targs, jgrads):
        got = np.zeros(t.shape, np.float32) if t.grad is None else \
            t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), atol=ATOL, rtol=rtol)


def test_every_alias_names_the_same_op_in_both_packages():
    names = set(treg.list_ops())
    aliases = [n for n in names if treg.get(n).name != n]
    assert {"_plus", "_rminus_scalar", "_rpower_scalar", "broadcast_sub",
            "sum_axis", "max_axis", "min_axis", "Softmax"} <= set(aliases)
    for n in aliases:
        assert treg.get(n).name == jreg.get(n).name
        assert treg.get(n) is treg.get(treg.get(n).name)


def test_reverse_scalar_ops_put_the_scalar_first():
    x = torch.tensor([0.5, 2.0])
    for name, want in (("_RMinusScalar", 3.0 - x), ("_RDivScalar", 3.0 / x),
                       ("_RPowerScalar", 3.0 ** x)):
        op = treg.get(name)
        got = op.apply(treg.OpCtx(), op.parse_params({"scalar": 3.0}), [x],
                       [])[0][0]
        torch.testing.assert_close(got, want)


def test_product_ops_refuse_what_jax_refuses():
    for name, shapes in (("dot", [(3, 4), (5, 6)]),
                         ("batch_dot", [(2, 3, 4), (3, 4, 5)])):
        op = treg.get(name)
        with pytest.raises(MXNetError, match="incompatible"):
            op.infer_shape({}, shapes)
    op = treg.get("_Plus")
    with pytest.raises(MXNetError, match="shape mismatch"):
        op.infer_shape({}, [(2, 3), (3, 2)])


# -- mx.nd.<op> -------------------------------------------------------------

ND_CASES = [c for c in CASES if c[0] not in ("argmax_channel",)] + [
    ("Convolution", {"kernel": (3, 3), "num_filter": 2, "pad": (1, 1)},
     [(1, 3, 5, 5), (2, 3, 3, 3), (2,)], 1e-5),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pool_type": "avg"},
     [(1, 2, 7, 7)], RTOL),
    ("Concat", {"dim": 1}, [(2, 3), (2, 2), (2, 4)], RTOL),
    ("SliceChannel", {"num_outputs": 2}, [(2, 4)], RTOL),
]


@pytest.mark.parametrize("case", ND_CASES, ids=[_ids(c) for c in ND_CASES])
def test_nd_function_matches_jax(case):
    """The imperative form: NDArrays positionally, params by name; a
    variable-arity op counts its inputs; a multi-output op returns a
    list."""
    name, params, shapes, rtol = case
    inputs = [_input(name, s, seed=i) for i, s in enumerate(shapes)]
    want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in inputs],
                                 **params)
    got = getattr(tmx.nd, name)(*[tmx.nd.array(a, ctx=tmx.cpu())
                                  for a in inputs], **params)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tmx.NDArray) and g.context == tmx.cpu()
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), atol=ATOL,
                                   rtol=rtol)


def test_nd_out_keyword_writes_in_place_and_aux_ops_are_refused():
    a = tmx.nd.array(np.ones((2, 3), np.float32), ctx=tmx.cpu())
    b = tmx.nd.array(np.full((2, 3), 2.0, np.float32), ctx=tmx.cpu())
    out = tmx.nd.zeros((2, 3), ctx=tmx.cpu())
    ret = tmx.nd._Plus(a, b, out=out)
    assert ret is out and (out.asnumpy() == 3.0).all()
    with pytest.raises(MXNetError, match="auxiliary state"):
        tmx.nd.BatchNorm(a, a, a)
    with pytest.raises(TypeError, match="positional"):
        tmx.nd.exp(np.ones(2))


# -- Symbol operators and indexing ------------------------------------------


def _structure(sym):
    """(op, params) of every node, and the arguments and outputs."""
    nodes = json.loads(sym.tojson())["nodes"]
    return ([(n["op"], n["param"]) for n in nodes], sym.list_arguments(),
            len(sym.list_outputs()))


EXPRS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b, "neg": lambda a, b: -a,
    "scalar": lambda a, b: 2.0 * a - 1.5 + a / 4 + a ** 2,
    "rscalar": lambda a, b: 3.0 - a + 2.0 / b + 2.0 * a,
}


@pytest.mark.parametrize("expr", sorted(EXPRS))
def test_symbol_arithmetic_builds_the_jax_graph_and_values(expr):
    """The same ops and params as the JAX package's operators build, and
    the same values through each package's `Executor`."""
    res = {}
    rng = np.random.RandomState(3)
    vals = {"a": rng.uniform(0.5, 2, (2, 3)).astype(np.float32),
            "b": rng.uniform(0.5, 2, (2, 3)).astype(np.float32)}
    for k, mx in (("jax", jmx), ("torch", tmx)):
        sym = EXPRS[expr](mx.sym.Variable("a"), mx.sym.Variable("b"))
        exe = sym.simple_bind(mx.cpu(), grad_req="null",
                              **{n: vals[n].shape
                                 for n in sym.list_arguments()})
        for n in sym.list_arguments():
            exe.arg_dict[n][:] = vals[n]
        res[k] = (_structure(sym), exe.forward()[0].asnumpy())
    assert res["torch"][0] == res["jax"][0]
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], atol=ATOL,
                               rtol=RTOL)


def test_symbol_indexing_and_internals_follow_visible_outputs():
    """BatchNorm shows one output of three; SliceChannel all of its own;
    `get_internals` groups every visible output in graph order."""
    for mx in (jmx, tmx):
        x = mx.sym.Variable("x")
        bn = mx.sym.BatchNorm(data=x, name="bn")
        sl = mx.sym.SliceChannel(data=bn, num_outputs=3, name="sl")
        assert len(bn) == 1 and bn.list_outputs() == ["bn_output"]
        assert len(sl) == 3 and [s.list_outputs()[0] for s in sl] == \
            ["sl_output0", "sl_output1", "sl_output2"]
        assert sl[1].list_outputs() == ["sl_output1"]
        assert sl["sl_output2"].list_outputs() == ["sl_output2"]
    jnet = jmx.sym.SliceChannel(data=jmx.sym.BatchNorm(
        data=jmx.sym.Variable("x"), name="bn"), num_outputs=3, name="sl")
    tnet = tmx.sym.SliceChannel(data=tmx.sym.BatchNorm(
        data=tmx.sym.Variable("x"), name="bn"), num_outputs=3, name="sl")
    assert tnet.get_internals().list_outputs() == \
        jnet.get_internals().list_outputs()
    with pytest.raises(MXNetError, match="no output named"):
        tnet["nope"]


def test_variable_arity_counts_inputs_as_jax_does():
    """``Concat(*syms, dim=0)`` and ``Crop(a, b, num_args=2)``: the same
    arguments and JSON ``num_args`` as the JAX package's, and the JSON
    cross-loads."""
    from mxnet_tpu import symbol as jsym
    from mxnet_tpu_torch import symbol as tsym

    out = {}
    for k, mx in (("jax", jmx), ("torch", tmx)):
        v = [mx.sym.Variable("v%d" % i) for i in range(3)]
        cat = mx.sym.Concat(*v, dim=0, name="cat")
        crop = mx.sym.Crop(v[0], v[1], num_args=2, name="crop")
        up = mx.sym.UpSampling(v[0], v[2], scale=2, name="up")
        out[k] = [(s.list_arguments(), s.tojson()) for s in (cat, crop, up)]
    assert out["torch"] == out["jax"]
    params = json.loads(out["torch"][0][1])["nodes"][-1]["param"]
    assert params["num_args"] == "3"
    for _, text in out["jax"]:
        assert tsym.loads(text).tojson() == text
        assert jsym.loads(text).tojson() == text
