"""The port's model zoo and registry against the JAX package's, on the CPU.

* The port's registry holds every op name of the JAX package's except the
  three that wait for later slices, and `models` exports every name.
* Each zoo model at its published (or default) widths: the same
  arguments, outputs and aux states, in order, the same inferred shapes,
  and its JSON cross-loaded both ways (each package re-saves the other's
  JSON byte for byte).  Nothing runs.
* One training forward and backward of the small models (LeNet,
  AlexNet, VGG, the LSTM and RNN LMs) at a tiny size through the port's
  `Executor` against the JAX `Executor`, from the same parameters.
  GoogLeNet and FCN-8s run in `tests/test_torch_zoo_nets.py`,
  Inception-BN in `tests/test_torch_zoo_inception_bn.py`, Inception-v3
  in `tests/test_torch_zoo_inception.py`, ResNet-50 in
  `tests/test_torch_zoo_resnet.py` and ResNet-18's trajectory in
  `tests/test_torch_zoo_resnet_train.py` (one network a file for the
  tier-1 budget: each JAX network compiles for seconds, in float32 and
  float64).
* Two batches of `FeedForward` on LeNet walk the JAX package's
  parameters.

Tolerances: whole networks in float32 on both sides differ in the order
of their sums (convolutions and products over up to a few thousand
terms, through up to 13 layers), ~1e-6 of the largest value; every
output, gradient and aux state is held to 1e-4 of its own largest
magnitude (`_close`), as `chip_smoke.py` holds gradients.  `FeedForward`'s
parameters after two SGD steps: rtol 1e-4 / atol 1e-5, the trajectory
bars of `tests/test_torch_train.py`.  Dropout draws each package's own
random bits, so it is the identity in both packages here (its own test
is in `tests/test_torch_ops.py`).
"""
import json

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.ops  # noqa: F401
import mxnet_tpu_torch as tmx
from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.ops import registry as treg

PK = {"jax": jmx, "torch": tmx}
ZOO = {"jax": jmodels, "torch": tmx.models}
# the JAX package's ops the port does not hold yet, and the queue of
# ROADMAP.md that takes each
WAITING = {"TorchModule": "queue 6 (torch_bridge.py)",
           "TorchCriterion": "queue 6 (torch_bridge.py)"}
BAR = 1e-4


def test_registry_holds_every_jax_op_but_those_that_wait():
    jax_ops, port_ops = set(jreg.list_ops()), set(treg.list_ops())
    assert jax_ops - port_ops == set(WAITING)
    assert port_ops <= jax_ops
    # aliases point at the same op in both
    for n in port_ops:
        assert treg.get(n).name == jreg.get(n).name, n


def test_models_export_every_jax_name():
    want = {n for n, v in vars(jmodels).items()
            if callable(v) and not n.startswith("_")}
    assert want <= set(tmx.models.__all__)
    assert all(callable(getattr(tmx.models, n)) for n in want)


def _lstm_states(batch, hidden, layers=2):
    return {"l%d_init_%s" % (i, t): (batch, hidden)
            for i in range(layers) for t in ("c", "h")}


def _rnn_shapes(batch, seq, hidden, layers=2):
    out = {"l%d_init_h" % i: (batch, hidden) for i in range(layers)}
    for t in range(seq):
        out["t%d_data" % t] = (batch,)
        out["t%d_sm_label" % t] = (batch,)
    return out


# each model at its published or default widths: (build function, data
# shapes)
PUBLISHED = {
    "mlp": (lambda m: m.get_mlp(), {"data": (128, 784)}),
    "lenet": (lambda m: m.get_lenet(), {"data": (128, 1, 28, 28)}),
    "alexnet": (lambda m: m.get_alexnet(), {"data": (256, 3, 224, 224)}),
    "vgg": (lambda m: m.get_vgg(), {"data": (32, 3, 224, 224)}),
    "inception_bn": (lambda m: m.get_inception_bn(),
                     {"data": (64, 3, 28, 28)}),
    "inception_bn_224": (lambda m: m.get_inception_bn(
        num_classes=1000, image_shape=(3, 224, 224)),
        {"data": (32, 3, 224, 224)}),
    "googlenet": (lambda m: m.get_googlenet(), {"data": (32, 3, 224, 224)}),
    "inception_v3": (lambda m: m.get_inception_v3(),
                     {"data": (32, 3, 299, 299)}),
    "resnet_28_small": (lambda m: m.get_resnet(
        num_classes=10, num_layers=28, image_shape=(3, 32, 32)),
        {"data": (128, 3, 32, 32)}),
    "resnet_50_valid_ghost": (lambda m: m.get_resnet(
        num_layers=50, pooling_convention="valid", ghost_batch=32),
        {"data": (128, 3, 224, 224)}),
    "lstm": (lambda m: m.lstm_unroll(2, 20, 10000, 64, 64, 10000),
             dict(data=(32, 20), softmax_label=(32, 20),
                  **_lstm_states(32, 64))),
    "lstm_model_parallel": (lambda m: m.lstm_unroll(
        2, 8, 1000, 64, 64, 1000, ctx_groups=["layer0", "layer1"]),
        dict(data=(32, 8), softmax_label=(32, 8), **_lstm_states(32, 64))),
    "rnn_bn": (lambda m: m.rnn_unroll(2, 6, 1000, 64, 64, 1000,
                                      batch_norm=True),
               _rnn_shapes(32, 6, 64)),
}
PUBLISHED.update({
    "resnet_%d" % d: (lambda m, d=d: m.get_resnet(num_layers=d),
                      {"data": (32, 3, 224, 224)})
    for d in (18, 34, 50, 101, 152)})
PUBLISHED.update({
    v: (lambda m, v=v: m.get_fcn_xs(variant=v),
        {"data": (4, 3, 64, 64), "softmax_label": (4, 64, 64)})
    for v in ("fcn32s", "fcn16s", "fcn8s")})


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_zoo_model_infers_the_jax_shapes_and_cross_loads(name):
    build, shapes = PUBLISHED[name]
    nets = {k: build(m) for k, m in ZOO.items()}
    j, t = nets["jax"], nets["torch"]
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    want = j.infer_shape(**shapes)
    assert want[0] is not None
    assert t.infer_shape(**shapes) == want
    assert t.attr_dict() == j.attr_dict()
    # JSON both ways: each package loads the other's and saves it again
    # byte for byte
    jtext, ttext = j.tojson(), t.tojson()
    assert tsym.loads(jtext).tojson() == jtext
    assert jsym.loads(ttext).tojson() == ttext
    assert [n["op"] for n in json.loads(ttext)["nodes"]] == \
        [n["op"] for n in json.loads(jtext)["nodes"]]


def test_model_parallel_lstm_keeps_its_groups_and_refuses_two_devices():
    """The ``ctx_group`` attributes survive; binding them over two devices
    waits for ROADMAP queue 5, one device runs."""
    net = tmx.models.lstm_unroll(2, 3, 20, 8, 8, 20,
                                 ctx_groups=["layer0", "layer1"])
    groups = {a.get("ctx_group") for a in net.attr_dict().values()}
    assert groups == {"embed", "decode", "layer0", "layer1"}
    shapes = dict(data=(2, 3), softmax_label=(2, 3), **_lstm_states(2, 8))
    with pytest.raises(tmx.MXNetError, match="queue 5"):
        net.simple_bind(ctx=tmx.cpu(0), group2ctx={"layer0": tmx.cpu(0),
                                                   "layer1": tmx.gpu(0)},
                        **shapes)
    exe = net.simple_bind(ctx=tmx.cpu(0), group2ctx={
        g: tmx.cpu(0) for g in groups}, **shapes)
    assert exe.forward()[0].shape == (6, 20)


# -- one training forward and backward against the JAX Executor -------------


def _init_value(name, shape, rng):
    if name.endswith("weight"):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        return rng.randn(*shape) * np.sqrt(2.0 / fan_in)
    if name.endswith("gamma"):
        return 1 + 0.1 * rng.randn(*shape)
    if name.endswith(("bias", "beta")):
        return 0.1 * rng.randn(*shape)
    if name.endswith("moving_var"):
        return 1 + 0.1 * np.abs(rng.randn(*shape))
    if name.endswith("moving_mean"):
        return 0.1 * rng.randn(*shape)
    return rng.randn(*shape)


def _close(got, want, what, bar=None):
    """max |got - want| within ``bar`` (default BAR of max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bar = BAR * max(np.abs(want).max(), 1e-30) if bar is None else bar
    err = np.abs(got - want).max()
    assert err <= bar, "%s: %.3e, bar %.3e" % (what, err, bar)


def _values(net_arg_shapes, ints, classes, seed):
    """{name: float32 numpy value} for every argument and aux state:
    integer ids below ``classes`` for the inputs in ``ints`` and the
    labels, else `_init_value`."""
    rng = np.random.RandomState(seed)
    vals = {}
    for name, shape in net_arg_shapes:
        if name in ints or name.endswith("label"):
            v = rng.randint(0, classes, shape)
        else:
            v = _init_value(name, shape, rng)
        vals[name] = v.astype(np.float32)
    return vals


def _run_both(build, shapes, vals, dtype):
    """One training forward and backward of ``build(models)`` in both
    packages' `Executor` on the CPU from ``vals``, every argument in
    ``dtype`` (float64: the JAX package under ``jax.enable_x64``):
    {package: (outputs, {name: gradient}, {name: aux state})} as
    float64 numpy."""
    res = {}
    for k, mx in PK.items():
        net = build(ZOO[k])
        types = {n: dtype for n in net.list_arguments()}
        with jax.enable_x64(dtype == np.float64):
            exe = net.simple_bind(mx.cpu(), grad_req="write",
                                  type_dict=types, **shapes)
            for name, arr in list(exe.arg_dict.items()) + list(
                    exe.aux_dict.items()):
                arr[:] = vals[name].astype(arr.asnumpy().dtype)
            exe.forward(is_train=True)
            exe.backward()
            res[k] = ([np.asarray(o.asnumpy(), np.float64)
                       for o in exe.outputs],
                      {n: np.asarray(g.asnumpy(), np.float64)
                       for n, g in exe.grad_dict.items() if n not in shapes},
                      {n: np.asarray(a.asnumpy(), np.float64)
                       for n, a in exe.aux_dict.items()})
    return res


def fwd_bwd_against_jax(build, shapes, ints=(), seed=0, classes=None,
                        spread=False):
    """Bind ``build(models)`` in both packages on the CPU, fill arguments
    and aux states from ``seed`` (inputs named in ``ints`` as integer ids
    below ``classes``, labels likewise), run one training forward and
    backward in float32, and hold outputs, every gradient and the aux
    states after against the JAX Executor's: each array within BAR of
    its largest magnitude (a gradient: of the larger of its own and 1e-3
    of the network's largest, since a convolution's bias before a
    BatchNorm has a true gradient of zero and both packages compute
    rounding noise there).

    With ``spread`` the bar is the largest of that, twice the network's
    rounding spread in the same units, and twice the array's own
    rounding spread.  An array's spread is the larger distance between
    either package's float32 run and its own float64 run (the JAX package
    under ``jax.enable_x64``); the network's is the largest relative
    spread over its outputs and aux states, for those, and over its
    gradients, for the gradients.
    Two float32 runs of a large network part where a ReLU input lies
    within rounding of zero, and a deep BatchNorm network at
    initialization amplifies rounding through its backward (the
    statistics' float32 path, in both packages).  An array that rounding
    moves by half its size (a bias before a BatchNorm, whose true
    gradient is zero) is left out of the network's spread.  An op whose
    formula differs between the packages moves the result by far more.
    Returns the network's spreads, and the array of each."""
    nets = {k: build(m) for k, m in ZOO.items()}
    assert nets["torch"].list_arguments() == nets["jax"].list_arguments()
    assert nets["torch"].list_auxiliary_states() == \
        nets["jax"].list_auxiliary_states()
    arg_shapes, _, aux_shapes = nets["jax"].infer_shape(**shapes)
    vals = _values(list(zip(nets["jax"].list_arguments(), arg_shapes))
                   + list(zip(nets["jax"].list_auxiliary_states(),
                              aux_shapes)), ints, classes, seed)
    runs = {np.float32: _run_both(build, shapes, vals, np.float32)}
    if spread:
        runs[np.float64] = _run_both(build, shapes, vals, np.float64)
    top = max(np.abs(g).max() for g in runs[np.float32]["jax"][1].values())
    # (kind, name, pick) of every array compared
    arrays = [("fwd", "output %d" % i, lambda r, i=i: r[0][i])
              for i in range(len(runs[np.float32]["jax"][0]))]
    arrays += [("bwd", "grad " + n, lambda r, n=n: r[1][n])
               for n in runs[np.float32]["jax"][1]]
    arrays += [("fwd", "aux " + n, lambda r, n=n: r[2][n])
               for n in runs[np.float32]["jax"][2]]

    def scale(kind, pick):
        m = np.abs(pick(runs[np.float32]["jax"])).max()
        return max(m, 1e-3 * top if kind == "bwd" else 1e-30)

    spreads, own, where = {"fwd": 0.0, "bwd": 0.0}, {}, {}
    if spread:
        for kind, what, pick in arrays:
            own[what] = max(np.abs(pick(runs[np.float32][k])
                                   - pick(runs[np.float64][k])).max()
                            for k in PK)
            m = np.abs(pick(runs[np.float32]["jax"])).max()
            # an array that rounding alone moves by half its size is
            # noise (a bias before a BatchNorm): held to its own spread
            if own[what] < 0.5 * m and own[what] / m > spreads[kind]:
                spreads[kind], where[kind] = own[what] / m, what
    for kind, what, pick in arrays:
        _close(pick(runs[np.float32]["torch"]),
               pick(runs[np.float32]["jax"]), what,
               max(max(BAR, 2 * spreads[kind]) * scale(kind, pick),
                   2 * own.get(what, 0.0)))
    return spreads, where


def net_matches_jax(name, build, shapes, classes):
    """`fwd_bwd_against_jax` with the rounding spread, printing it (-s)."""
    spreads, where = fwd_bwd_against_jax(build, shapes, classes=classes,
                                         spread=True)
    print("%s: rounding spread %s at %s" % (name, spreads, where))


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout as the identity in both packages (each draws its own
    bits)."""
    for reg in (jreg, treg):
        monkeypatch.setattr(reg.get("Dropout"), "apply",
                            lambda octx, params, inputs, aux: ([inputs[0]],
                                                               []))


TINY = {
    "lenet": (lambda m: m.get_lenet(),
              {"data": (2, 1, 28, 28), "softmax_label": (2,)}, 10),
    # 67 px: the smallest input AlexNet's stride-4 stem and three
    # ceil-mode pools take to 1x1
    "alexnet": (lambda m: m.get_alexnet(num_classes=10),
                {"data": (1, 3, 67, 67), "softmax_label": (1,)}, 10),
    "vgg": (lambda m: m.get_vgg(num_classes=10),
            {"data": (1, 3, 32, 32), "softmax_label": (1,)}, 10),
    "lstm": (lambda m: m.lstm_unroll(2, 4, 20, 8, 8, 20),
             dict(data=(3, 4), softmax_label=(3, 4), **_lstm_states(3, 8)),
             20),
    "rnn": (lambda m: m.rnn_unroll(2, 3, 20, 8, 8, 20),
            _rnn_shapes(3, 3, 8), 20),
    "rnn_bn": (lambda m: m.rnn_unroll(2, 3, 20, 8, 8, 20, batch_norm=True),
               _rnn_shapes(4, 3, 8), 20),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_small_model_forward_backward_matches_the_jax_executor(
        name, no_dropout):
    build, shapes, classes = TINY[name]
    ints = [n for n in shapes if n == "data" and name == "lstm"
            or n.endswith("_data")]
    fwd_bwd_against_jax(build, shapes, ints=ints, classes=classes)


# -- FeedForward on LeNet -----------------------------------------------------


def test_feedforward_lenet_walks_the_jax_parameters():
    """Two batches of 16 through `FeedForward(get_lenet())` (SGD, momentum
    0.9, lr 0.1, `Xavier`, from seed 0) in both packages: the same
    parameters after."""
    rng = np.random.RandomState(0)
    X = rng.rand(32, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 32).astype(np.float32)
    got = {}
    for k, mx in PK.items():
        mx.random.seed(0)
        model = mx.model.FeedForward(
            ZOO[k].get_lenet(), ctx=mx.cpu(), num_epoch=1,
            optimizer="sgd", learning_rate=0.1, momentum=0.9,
            initializer=mx.init.Xavier())
        seen = []
        model.fit(mx.io.NDArrayIter(X, y, batch_size=16),
                  batch_end_callback=lambda p: seen.append(p.nbatch))
        assert len(seen) == 2
        got[k] = {n: v.asnumpy() for n, v in model.arg_params.items()}
    assert sorted(got["torch"]) == sorted(got["jax"])
    for n, want in got["jax"].items():
        np.testing.assert_allclose(got["torch"][n], want, rtol=1e-4,
                                   atol=1e-5, err_msg=n)
