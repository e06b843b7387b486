"""The port's Executor (`Symbol.bind`/`simple_bind`) against the JAX
package's, on the CPU.

The same parameters and batch go through both packages' executors: the
MLP at 32-16-16-4 and the transformer LM at V,S,L,H,E = 61,32,2,2,32.
Outputs and gradients are held to `tests/test_torch_train.py`'s bars for
the same graph: rtol 1e-4 / atol 1e-5, float32 on both sides, differing
in the order of the sums of the matrix products and the attention.  The
key-projection biases' true gradient is zero (the softmax cancels them),
so both packages give rounding noise there, held to atol 1e-5 against
the largest gradient of the model.

Also: `grad_req` write, add, null and by dict (a dict ``args_grad`` may
omit names); head gradients (``out_grads``); aux states updated in
training (an op with a running mean, registered in both packages for
that test only); the key order (binding takes one key of `random`, forward n
runs with ``fold_in(key, n)``: a Dropout graph's masks, and the draws
after a bind, follow it); `copy_params_from`, `reshape`, the eager
monitor; the rematerialization pins, read at bind; and the pins that
raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _build_graph_fn
from mxnet_tpu_torch.ops import registry as treg
from test_torch_kernels import _one_thread  # noqa: F401


PK = {"jax": jmx, "torch": tmx}
RTOL, ATOL = 1e-4, 1e-5
B = 8
V, S, L, H, E = 61, 32, 2, 2, 32
LM_B = 4


def mlp(mx, head=True):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, name="fc1", num_hidden=16)
    h = mx.sym.Activation(data=h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=16)
    h = mx.sym.Activation(data=h, name="relu2", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc3", num_hidden=4)
    return mx.sym.SoftmaxOutput(data=h, name="softmax") if head else h


def lm(mx):
    return mx.models.get_transformer_lm(V, S, num_layers=L, num_heads=H,
                                        num_embed=E)


MLP_SHAPES = {"data": (B, 32), "softmax_label": (B,)}
LM_SHAPES = {"data": (LM_B, S), "softmax_label": (LM_B, S)}


def _inputs(shapes, seed=0, classes=4):
    """Labels (and the LM's tokens) as class ids below ``classes``, other
    data from N(0, 1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in shapes.items():
        if n == "softmax_label" or classes == V:
            out[n] = rng.randint(0, classes, s).astype(np.float32)
        else:
            out[n] = rng.randn(*s).astype(np.float32)
    return out


def _bind(which, net_fn, shapes, grad_req="write", seed=0, classes=4):
    """simple_bind in package ``which``, parameters from Xavier after
    seed(seed), inputs from numpy: (executor, numpy inputs)."""
    mx = PK[which]
    mx.random.seed(seed)
    exe = net_fn(mx).simple_bind(mx.cpu(), grad_req=grad_req, **shapes)
    init = mx.init.Xavier()
    for n, a in exe.arg_dict.items():
        if n not in shapes:
            init(n, a)
    data = _inputs(shapes, seed, classes)
    for n, v in data.items():
        exe.arg_dict[n][:] = v
    return exe, data


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _close(got, want, scale=None):
    for k in want:
        atol = ATOL * scale if scale and k.endswith("_k_bias") else ATOL
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol,
                                   err_msg=k)


def _train_step(which, net_fn, shapes, **kw):
    exe, _ = _bind(which, net_fn, shapes, **kw)
    before = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward()
    return exe, before


@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_simple_bind_forward_backward_matches(model):
    net_fn, shapes, classes = (mlp, MLP_SHAPES, 4) if model == "mlp" \
        else (lm, LM_SHAPES, V)
    res = {}
    for which in PK:
        exe, before = _train_step(which, net_fn, shapes, classes=classes)
        res[which] = (exe, before)
    (jexe, jbefore), (texe, tbefore) = res["jax"], res["torch"]
    # Xavier after the same seed and one bind draws the same parameters
    for n in jexe.arg_dict:
        np.testing.assert_array_equal(texe.arg_dict[n].asnumpy(),
                                      jexe.arg_dict[n].asnumpy())
    np.testing.assert_allclose(tbefore[0], jbefore[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(texe.outputs[0].asnumpy(), tbefore[0])
    jg, tg = _np(jexe.grad_dict), _np(texe.grad_dict)
    gmax = max(np.abs(g).max() for g in jg.values())
    assert gmax > 0
    _close(tg, jg, scale=gmax)


def test_bind_given_arrays_and_dict_args_grad():
    res = {}
    for which, mx in PK.items():
        exe0, data = _bind(which, mlp, MLP_SHAPES)
        args = {n: mx.nd.array(a.asnumpy(), ctx=mx.cpu())
                for n, a in exe0.arg_dict.items()}
        grads = {n: mx.nd.zeros(a.shape, mx.cpu())
                 for n, a in args.items() if n.endswith("weight")}
        exe = mlp(mx).bind(mx.cpu(), args, args_grad=grads)
        exe.forward(is_train=True)
        exe.backward()
        assert exe.grad_arrays[mlp(mx).list_arguments().index("fc1_bias")] \
            is None
        res[which] = {n: g.asnumpy() for n, g in grads.items()}
    _close(res["torch"], res["jax"])
    assert all(np.abs(g).max() > 0 for g in res["torch"].values())


@pytest.mark.parametrize("req", ["write", "add", "null", "dict", "list"])
def test_grad_req_matches(req):
    names = mlp(tmx).list_arguments()
    grad_req = {"dict": {"fc1_weight": "add", "fc3_bias": "write"},
                "list": ["null" if n.startswith("fc2") else "add"
                         for n in names]}.get(req, req)
    res = {}
    for which in PK:
        exe, _ = _bind(which, mlp, MLP_SHAPES, grad_req=grad_req)
        if exe.grad_arrays is None:
            res[which] = None
            continue
        for g in exe.grad_arrays:
            if g is not None:
                g[:] = 0.5
        for _ in range(2):
            exe.forward(is_train=True)
            exe.backward()
        res[which] = _np(exe.grad_dict)
    if req == "null":
        assert res["torch"] is None and res["jax"] is None
        return
    _close(res["torch"], res["jax"])


def test_out_grads_are_the_head_gradients():
    res = {}
    cot = np.random.RandomState(5).randn(B, 4).astype(np.float32)
    shapes = {"data": MLP_SHAPES["data"]}
    for which, mx in PK.items():
        exe, _ = _bind(which, lambda m: mlp(m, head=False), shapes)
        exe.forward(is_train=True)
        exe.backward([mx.nd.array(cot, ctx=mx.cpu())])
        res[which] = _np(exe.grad_dict)
    _close(res["torch"], res["jax"])
    # ones, where none are given (a head that is not a loss sees them)
    exe, _ = _bind("torch", lambda m: mlp(m, head=False), shapes)
    exe.forward(is_train=True)
    exe.backward()
    g1 = exe.grad_dict["fc3_bias"].asnumpy()
    np.testing.assert_allclose(g1, np.full(4, B, np.float32))


class _RunningMean:
    """x at inference; in training 2x, and the aux state ``moving_mean``
    becomes 0.9 * itself + 0.1 * the batch mean (a test op, registered in
    both packages)."""

    name = "_TestRunningMean"
    params = {}
    need_rng = False

    def list_aux(self, params):
        return ["moving_mean"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        return in_shapes, [d], [None if d is None else (d[1],)]


class _JaxRunningMean(_RunningMean, jreg.OpDef):
    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        if not octx.is_train:
            return [x], [None]
        return [x * 2.0], [0.9 * aux[0] + 0.1 * jnp.mean(x, axis=0)]


class _TorchRunningMean(_RunningMean, treg.OpDef):
    def apply(self, octx, params, inputs, aux):
        x = inputs[0]
        if not octx.is_train:
            return [x], [None]
        return [x * 2.0], [0.9 * aux[0] + 0.1 * x.mean(dim=0)]


@pytest.fixture
def running_mean_op():
    """The test op in both registries for one test, then taken out, so no
    other test (the JAX package's registry sweep) sees it."""
    jreg.register(_JaxRunningMean)
    treg.register(_TorchRunningMean)
    yield
    jreg._REGISTRY.pop(_RunningMean.name)
    treg._REGISTRY.pop(_RunningMean.name)


def _aux_net(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, name="fc1", num_hidden=16)
    h = mx.symbol._create("_TestRunningMean", [h], {}, name="rm")
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def test_aux_states_update_in_training(running_mean_op):
    res = {}
    for which, mx in PK.items():
        exe, _ = _bind(which, _aux_net, MLP_SHAPES)
        assert list(exe.aux_dict) == ["rm_moving_mean"]
        exe.aux_dict["rm_moving_mean"][:] = 1.0
        exe.forward(is_train=False)
        eval_aux = exe.aux_dict["rm_moving_mean"].asnumpy().copy()
        for _ in range(2):
            exe.forward(is_train=True)
            exe.backward()
        res[which] = (eval_aux, exe.aux_dict["rm_moving_mean"].asnumpy(),
                      _np(exe.grad_dict))
    np.testing.assert_array_equal(res["torch"][0], np.ones(16, np.float32))
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], rtol=RTOL,
                               atol=ATOL)
    assert np.abs(res["torch"][1] - 1.0).max() > 1e-3
    _close(res["torch"][2], res["jax"][2])


def _dropout_net(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, name="fc1", num_hidden=16)
    h = mx.sym.Dropout(data=h, name="drop", p=0.5)
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def test_key_order_of_bind_and_forward():
    """Binding takes one key; forward n runs with fold_in(key, n).  A
    Dropout graph's masks are PyTorch's draws from those keys, and the
    parameters drawn after a bind are the JAX package's."""
    tmx.random.seed(11)
    exe = _dropout_net(tmx).simple_bind(tmx.cpu(), **MLP_SHAPES)
    after = tmx.nd.zeros((3, 5), tmx.cpu())
    tmx.init.Xavier()("w_weight", after)
    jmx.random.seed(11)
    _dropout_net(jmx).simple_bind(jmx.cpu(), **MLP_SHAPES)
    jafter = jmx.nd.zeros((3, 5))
    jmx.init.Xavier()("w_weight", jafter)
    np.testing.assert_array_equal(after.asnumpy(), jafter.asnumpy())

    init = tmx.init.Xavier()
    for n, a in exe.arg_dict.items():
        if n not in MLP_SHAPES:
            init(n, a)
    exe.arg_dict["data"][:] = _inputs(MLP_SHAPES)["data"]
    outs = [exe.forward(is_train=True)[0].asnumpy() for _ in range(2)]
    assert np.abs(outs[0] - outs[1]).max() > 1e-3  # a new mask a step
    tmx.random.seed(11)
    key = trandom.next_key()
    fn = _build_graph_fn(_dropout_net(tmx))
    args = [a.data for a in exe.arg_arrays]
    for n, out in enumerate(outs, 1):
        with torch.no_grad():
            (ref,), _ = fn(args, [], trandom.fold_in(key, n), True)
        np.testing.assert_array_equal(out, ref.numpy())
    evals = [exe.forward(is_train=False)[0].asnumpy() for _ in range(2)]
    np.testing.assert_array_equal(evals[0], evals[1])


def test_a_weight_written_between_forward_and_backward(running_mean_op):
    """An optimizer update between a training forward and its backward
    (the JAX package's fused update, which deletes the buffers its
    pending forward held): backward computes at the updated weights from
    the aux states the forward read, so the running mean takes one
    update, and the outputs, the aux state and the gradients are the JAX
    package's."""
    res = {}
    for which, mx in PK.items():
        exe, _ = _bind(which, _aux_net, MLP_SHAPES)
        exe.aux_dict["rm_moving_mean"][:] = 1.0
        names = [n for n in exe.arg_dict if n not in MLP_SHAPES]
        weights = [exe.arg_dict[n] for n in names]
        grads = [mx.nd.array(np.full(w.shape, 0.25, np.float32),
                             ctx=mx.cpu()) for w in weights]
        update = mx.optimizer.get_fused_updater(
            mx.optimizer.SGD(learning_rate=0.5))
        exe.forward(is_train=True)
        update(list(range(len(names))), grads, weights)
        exe.backward()
        res[which] = ([o.asnumpy() for o in exe.outputs],
                      exe.aux_dict["rm_moving_mean"].asnumpy(),
                      _np(exe.grad_dict))
    (tout, taux, tgrad), (jout, jaux, jgrad) = res["torch"], res["jax"]
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux, jaux, rtol=RTOL, atol=ATOL)
    assert np.abs(taux - 1.0).max() > 1e-3
    _close(tgrad, jgrad)


def test_a_plain_write_between_forward_and_backward_recomputes():
    """A deliberate difference (ROADMAP queue 3): a plain write to a
    bound weight between a training forward and its backward makes the
    port's backward recompute at the written value, where the JAX
    package's pending forward still holds the old buffer and
    differentiates at the forward's values."""
    res = {}
    for which in PK:
        got = {}
        for write in (False, True):
            exe, _ = _bind(which, mlp, MLP_SHAPES)
            w = exe.arg_dict["fc2_weight"].asnumpy() * 2
            if write:
                exe.forward(is_train=True)
                exe.arg_dict["fc2_weight"][:] = w
            else:
                exe.arg_dict["fc2_weight"][:] = w
                exe.forward(is_train=True)
            exe.backward()
            got[write] = _np(exe.grad_dict)
        res[which] = got
    _close(res["torch"][True], res["torch"][False])
    _close(res["torch"][True], res["jax"][False])
    jw, jnw = res["jax"][True]["fc1_weight"], res["jax"][False]["fc1_weight"]
    assert np.abs(jw - jnw).max() > 1e-3


def test_copy_params_from_and_reshape():
    res = {}
    for which, mx in PK.items():
        exe, _ = _bind(which, mlp, MLP_SHAPES)
        params = {n: mx.nd.array(a.asnumpy() * 0.5, ctx=mx.cpu())
                  for n, a in exe.arg_dict.items() if n not in MLP_SHAPES}
        exe.copy_params_from(params)
        with pytest.raises(Exception):
            exe.copy_params_from({"nosuch": params["fc1_bias"]})
        exe.copy_params_from({"nosuch": params["fc1_bias"]},
                             allow_extra_params=True)
        small = exe.reshape(data=(3, 32), softmax_label=(3,))
        assert small.arg_dict["data"].shape == (3, 32)
        small.copy_params_from(params)
        small.arg_dict["data"][:] = _inputs(MLP_SHAPES)["data"][:3]
        res[which] = (exe.forward()[0].asnumpy(),
                      small.forward()[0].asnumpy())
    for t, j in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res["torch"][1], res["torch"][0][:3],
                               rtol=RTOL, atol=ATOL)


def test_eager_monitor_reports_every_entry():
    res = {}
    for which in PK:
        exe, _ = _bind(which, mlp, MLP_SHAPES)
        seen = []
        exe.set_monitor_callback(lambda n, a: seen.append((n, a.asnumpy())))
        exe.forward(is_train=False)
        res[which] = seen
    assert [n for n, _ in res["torch"]] == [n for n, _ in res["jax"]]
    for (_, t), (_, j) in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_infer_type_matches():
    for net_fn in (mlp, lm):
        j = net_fn(jmx).infer_type(data=np.float32)
        t = net_fn(tmx).infer_type(data=np.float32)
        assert t == j


@pytest.mark.parametrize("pin", [("MXNET_BACKWARD_DO_MIRROR", "1"),
                                 ("MXNET_BACKWARD_MIRROR_POLICY", "dots"),
                                 ("MXNET_BACKWARD_MIRROR_STEP", "4")])
def test_mirror_pins_raise(monkeypatch, pin):
    """The rematerialization pins, once refused, are read at bind: under
    each, a training step's outputs and gradients are the unpinned bind's
    bit for bit (`test_torch_remat.py` holds them against the JAX
    package); what raises is an unknown MXNET_BACKWARD_MIRROR_POLICY
    beside it, with the JAX package's message."""
    exe, want = _train_step("torch", mlp, MLP_SHAPES)
    ref = _np(exe.grad_dict)
    monkeypatch.setenv(*pin)
    exe, got = _train_step("torch", mlp, MLP_SHAPES)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for k, g in _np(exe.grad_dict).items():
        assert np.array_equal(g, ref[k]), k
    monkeypatch.setenv("MXNET_BACKWARD_MIRROR_POLICY", "bogus")
    with pytest.raises(MXNetError, match="MXNET_BACKWARD_MIRROR_POLICY must "
                       "be one of none/dots/attn/streams/nothing"):
        mlp(tmx).simple_bind(tmx.cpu(), **MLP_SHAPES)


def test_unported_executor_features_raise():
    with pytest.raises(MXNetError, match="group2ctx"):
        mlp(tmx).simple_bind(tmx.cpu(), group2ctx={"a": tmx.cpu(1)},
                             **MLP_SHAPES)
    exe = mlp(tmx).simple_bind(tmx.cpu(), group2ctx={"a": tmx.cpu()},
                               **MLP_SHAPES)
    # the in-graph monitor and step statistics work: one statistic an
    # entry, as device tensors; a carry of the step's statistics
    seen = []
    stepped = mlp(tmx).simple_bind(tmx.cpu(), **MLP_SHAPES)
    stepped.set_monitor_callback(lambda n, v: seen.append((n, v)),
                                 mode="ingraph")
    with pytest.raises(MXNetError, match="monitor mode"):
        exe.set_monitor_callback(print, mode="lazy")
    stepped.set_step_stat_fn(lambda o, a: o[0].sum().reshape(1), 1)
    stepped.forward(is_train=True)
    stepped.backward()
    assert [n for n, _ in seen][:1] == ["data"]
    assert all(v.dim() == 0 for _, v in seen)
    total = stepped.pop_step_stats()
    assert total.shape == (1,) and stepped.pop_step_stats() is None
    np.testing.assert_allclose(float(total[0]),
                               float(stepped.outputs[0].data.sum()),
                               rtol=1e-6)
    with pytest.raises(MXNetError, match="AotCache"):
        tmx.executor.AotCache("x")
    with pytest.raises(MXNetError):
        exe.backward()
    with pytest.raises(MXNetError):
        mlp(tmx).simple_bind(tmx.cpu(), grad_req="sum", **MLP_SHAPES)
    with pytest.raises(MXNetError):
        exe.forward(nosuch=1)
    with pytest.raises(MXNetError, match="forward"):
        exe.outputs
    with pytest.raises(MXNetError):
        tmx.executor.Executor(mlp(tmx), tmx.cpu(), [])
    with pytest.raises(MXNetError):
        mlp(tmx).bind(tmx.gpu(0), exe.arg_dict)
