"""The port's Module API against the JAX package's, on the CPU.

The same seeded data, initializer and optimizer go through both
packages' `mx.mod` classes:

* `Module.fit` on the 32-16-4 MLP for 5 batches of 16 (one epoch of 80
  shuffled samples), SGD with momentum 0.9 and Adam, on one CPU context
  and two, with kvstore 'local', 'device' (the store runs the update:
  ``update_on_kvstore``), None and a `KVStore` object (the same);
* `score`, `predict`, `get_params`/`set_params`, ``inputs_need_grad``
  (the data's gradients against the JAX executor's), `save_checkpoint`
  read by the other package's `load_checkpoint`;
* `BucketingModule` over 3 buckets of a token model (every bucket binds
  the default bucket's parameter tensors), `SequentialModule` (one module,
  and a chain of two), `PythonModule`;
* `SPMDModule` on a 2-layer, 32-wide transformer LM with the fused CE
  head (its kernels on their plain versions) against the JAX
  `SPMDModule` on a one-CPU mesh, 5 batches of SGD with momentum and of
  Adam, and its `predict`.

The bar is the parameters within 1e-4 of each parameter's max|w|
(`PERF.md` section 2's gradient bar): float32 on both sides, differing in
the order of the sums of the matrix products.  One exception, as in
`tests/test_torch_train.py`: where an element's gradient is rounding
noise (a key-projection bias, whose true gradient is zero, or an element
whose first gradient cancels to a nonzero value below 1e-5 of its
parameter's largest:
one of 4096 in ``layer1_ffn1_weight`` here, at 4e-7), Adam turns the
noise into steps of up to lr whatever its sign, so under Adam those
elements are held to 5 steps of lr (and must be under 1% of a
parameter's elements).
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.parallel import make_mesh
from mxnet_tpu_torch.base import MXNetError
from test_torch_kernels import _one_thread  # noqa: F401


PK = {"jax": jmx, "torch": tmx}
N, DIM, K, BATCH = 80, 32, 4, 16
TOL = 1e-4


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, K, n)
    X = rng.randn(n, DIM).astype(np.float32) * 0.1
    X[np.arange(n), y * 7] += 3.0
    return X, y.astype(np.float32)


def mlp(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, name="fc1", num_hidden=16)
    h = mx.sym.Activation(data=h, name="relu1", act_type="relu")
    h = mx.sym.FullyConnected(data=h, name="fc2", num_hidden=K)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


def _host(arrays):
    return {k: v.asnumpy() for k, v in arrays.items()}


def _close(got, want, tol=TOL, exempt=None):
    """Each parameter within ``tol`` of its max|w|; ``exempt`` maps a
    name to a bound on |got - want| in its place."""
    assert sorted(got) == sorted(want)
    for k in want:
        gap = float(np.abs(got[k] - want[k]).max())
        if exempt and k in exempt:
            assert gap <= exempt[k], (k, gap)
            continue
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert gap <= tol * scale, (k, gap / scale)


OPT = {"sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
       "adam": ("adam", {"learning_rate": 0.01})}


def _fit(which, opt="sgd", devices=1, kvstore="local", epochs=1, **kw):
    mx = PK[which]
    mx.random.seed(0)
    X, y = _data()
    it = mx.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=True)
    mod = mx.mod.Module(mlp(mx),
                        context=[mx.cpu(i) for i in range(devices)])
    if kvstore == "store":  # an object: the store runs the update
        kvstore = mx.kv.create("local")
    name, params = OPT[opt]
    mod.fit(it, num_epoch=epochs, kvstore=kvstore, optimizer=name,
            optimizer_params=dict(params), initializer=mx.init.Xavier(),
            **kw)
    return mod


@pytest.mark.parametrize("opt,devices,kvstore", [
    ("sgd", 1, "local"), ("adam", 1, "local"), ("sgd", 2, "local"),
    ("adam", 2, "device"), ("sgd", 2, None), ("sgd", 2, "store"),
    ("adam", 1, "store")])
def test_module_fit_matches_jax(opt, devices, kvstore):
    j = _fit("jax", opt, devices, kvstore)
    t = _fit("torch", opt, devices, kvstore)
    assert t._update_on_kvstore == j._update_on_kvstore
    assert t._update_on_kvstore or kvstore != "store"
    _close(_host(t.get_params()[0]), _host(j.get_params()[0]))
    assert t.stats["train.host_blocking_fetches"] == N // BATCH


def test_score_predict_and_params_match_jax():
    j, t = _fit("jax"), _fit("torch")
    Xv, yv = _data(40, seed=1)
    res = {}
    for which, mod in (("jax", j), ("torch", t)):
        mx = PK[which]
        it = mx.io.NDArrayIter(Xv, yv, batch_size=BATCH)  # last batch pads
        res[which] = (mod.score(it, "acc"), mod.predict(it))
    assert res["torch"][0][0][0] == res["jax"][0][0][0]
    np.testing.assert_allclose(res["torch"][0][0][1], res["jax"][0][0][1],
                               atol=1e-6)
    assert res["torch"][1].shape == res["jax"][1].shape == (40, K)
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], atol=1e-5)
    # set_params then get_params gives the values back; the executors
    # predict from them
    arg, aux = j.get_params()
    t.set_params({k: tmx.nd.array(v.asnumpy(), ctx=tmx.cpu())
                  for k, v in arg.items()}, {})
    np.testing.assert_array_equal(_host(t.get_params()[0])["fc1_weight"],
                                  arg["fc1_weight"].asnumpy())
    it = tmx.io.NDArrayIter(Xv, yv, batch_size=BATCH)
    np.testing.assert_allclose(t.predict(it), res["jax"][1], atol=1e-5)


def test_inputs_need_grad_gives_the_data_gradient():
    """The port's data gradients against the JAX executor's (the JAX
    group binds every argument with grad_req 'write')."""
    X, y = _data(BATCH)
    out = {}
    for which in ("jax", "torch"):
        mx = PK[which]
        mx.random.seed(0)
        mod = mx.mod.Module(mlp(mx), context=mx.cpu())
        mod.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))],
                 inputs_need_grad=True)
        mod.init_params(mx.init.Xavier())
        batch = mx.io.DataBatch([mx.nd.array(X, ctx=mx.cpu())],
                                [mx.nd.array(y, ctx=mx.cpu())])
        mod.forward(batch, is_train=True)
        mod.backward()
        if which == "torch":
            out[which] = mod.get_input_grads()[0].asnumpy()
        else:
            exe = mod._exec_group.train_execs[0]
            out[which] = exe.grad_dict["data"].asnumpy()
    scale = np.abs(out["jax"]).max()
    assert scale > 0
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0,
                               atol=TOL * scale)
    plain = tmx.mod.Module(mlp(tmx), context=tmx.cpu())
    plain.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    with pytest.raises(MXNetError, match="inputs_need_grad"):
        plain.get_input_grads()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_save_checkpoint_loads_in_the_other_package(tmp_path, writer):
    reader = "jax" if writer == "torch" else "torch"
    mod = _fit(writer)
    prefix = str(tmp_path / "mod")
    mod.save_checkpoint(prefix, 1)
    sym, arg, aux = PK[reader].model.load_checkpoint(prefix, 1)
    assert sym.list_arguments() == mlp(PK[reader]).list_arguments()
    want = _host(mod.get_params()[0])
    for k in want:
        np.testing.assert_array_equal(arg[k].asnumpy(), want[k])


# -- BucketingModule ------------------------------------------------------

VOCAB, EMBED, BUCKETS = 11, 8, (4, 6, 8)


def _token_sym(mx, seq_len):
    data = mx.sym.Variable("data")
    label = mx.sym.Reshape(data=mx.sym.Variable("softmax_label"),
                           shape=(-1,))
    emb = mx.sym.Embedding(data=data, input_dim=VOCAB, output_dim=EMBED,
                           name="embed")
    h = mx.sym.Reshape(data=emb, shape=(-1, EMBED))
    h = mx.sym.FullyConnected(data=h, num_hidden=VOCAB, name="pred")
    sym = mx.sym.SoftmaxOutput(data=h, label=label, name="softmax")
    return sym, ("data",), ("softmax_label",)


def _bucket_batches(mx, seed=0):
    """Two batches of 4 a bucket, in a seeded order."""
    rng = np.random.RandomState(seed)
    out = []
    for b in BUCKETS:
        for _ in range(2):
            tokens = rng.randint(0, VOCAB, (4, b)).astype(np.float32)
            out.append((b, tokens, np.roll(tokens, -1, axis=1)))
    return [out[i] for i in rng.permutation(len(out))]


class _BucketIter:
    """A minimal bucketed iterator over `_bucket_batches`."""

    def __init__(self, mx):
        self.mx = mx
        self.batches = _bucket_batches(mx)
        self.batch_size = 4
        self.default_bucket_key = max(BUCKETS)
        self.i = 0

    provide_data = property(lambda self: [("data", (4, max(BUCKETS)))])
    provide_label = property(
        lambda self: [("softmax_label", (4, max(BUCKETS)))])

    def reset(self):
        self.i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == len(self.batches):
            raise StopIteration
        b, x, y = self.batches[self.i]
        self.i += 1
        mx = self.mx
        return mx.io.DataBatch(
            [mx.nd.array(x, ctx=mx.cpu())], [mx.nd.array(y, ctx=mx.cpu())],
            bucket_key=b, provide_data=[("data", (4, b))],
            provide_label=[("softmax_label", (4, b))])

    next = __next__


def _bucketing(which):
    mx = PK[which]
    mx.random.seed(0)
    mod = mx.mod.BucketingModule(lambda b: _token_sym(mx, b),
                                 default_bucket_key=max(BUCKETS),
                                 context=mx.cpu())
    mod.fit(_BucketIter(mx), num_epoch=1, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=mx.init.Xavier())
    return mod


def test_bucketing_module_matches_jax_and_shares_parameters():
    j, t = _bucketing("jax"), _bucketing("torch")
    assert sorted(t._buckets) == sorted(j._buckets) == sorted(BUCKETS)
    _close(_host(t.get_params()[0]), _host(j.get_params()[0]))
    default = t._buckets[max(BUCKETS)]._exec_group.train_execs[0]
    for b in BUCKETS:
        exe = t._buckets[b]._exec_group.train_execs[0]
        for n in ("embed_weight", "pred_weight", "pred_bias"):
            assert exe.arg_dict[n].data.data_ptr() == \
                default.arg_dict[n].data.data_ptr()
            assert exe.grad_dict[n].data.data_ptr() == \
                default.grad_dict[n].data.data_ptr()


# -- SequentialModule and PythonModule ------------------------------------------


def _features(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, name="f1", num_hidden=16)
    return mx.sym.Activation(data=h, name="r1", act_type="tanh")


def _head(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, name="f2", num_hidden=K)
    return mx.sym.SoftmaxOutput(data=h, name="softmax")


@pytest.mark.parametrize("chain", ["one", "two"])
def test_sequential_module_matches_jax(chain):
    """A chain of one `Module`, and of two (the first's output is the
    second's data; the first's backward takes no head gradient, as in
    the JAX package): 5 SGD batches, then predict."""
    out = {}
    for which in ("jax", "torch"):
        mx = PK[which]
        mx.random.seed(0)
        X, y = _data()
        seq = mx.mod.SequentialModule()
        if chain == "one":
            seq.add(mx.mod.Module(mlp(mx), context=mx.cpu()))
        else:
            seq.add(mx.mod.Module(_features(mx), label_names=None,
                                  context=mx.cpu()))
            seq.add(mx.mod.Module(_head(mx), context=mx.cpu()),
                    take_labels=True)
        it = mx.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=True)
        seq.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1,
                                                   "momentum": 0.9},
                initializer=mx.init.Xavier())
        out[which] = (_host(seq.get_params()[0]),
                      seq.predict(mx.io.NDArrayIter(X, y, batch_size=BATCH)))
    _close(out["torch"][0], out["jax"][0])
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=1e-5)


def _scaler(mx):
    class Scale(mx.mod.PythonModule):
        """Outputs twice its data."""

        def _compute_output_shapes(self):
            return [("scale_output", self._data_shapes[0][1])]

        def forward(self, data_batch, is_train=None):
            self._outputs = [data_batch.data[0] * 2]

    return Scale(["data"], ["softmax_label"], ["scale_output"])


def test_python_module_matches_jax():
    X, y = _data(40)
    out = {}
    for which in ("jax", "torch"):
        mx = PK[which]
        mod = _scaler(mx)
        mod.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
        mod.init_params()
        mod.init_optimizer()
        assert mod.get_params() == ({}, {})
        assert mod.output_names == ["scale_output"]
        it = mx.io.NDArrayIter(X, y, batch_size=BATCH)
        out[which] = mod.predict(it)
    np.testing.assert_array_equal(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["torch"], X * 2)


# -- SPMDModule ----------------------------------------------------------------

V, S, L, H, E, B = 61, 32, 2, 2, 32, 4
LM_OPT = {"sgd": {"learning_rate": 1e-2, "momentum": 0.9},
          "adam": {"learning_rate": 1e-3}}
# an element whose first gradient is this far below its parameter's
# largest is rounding noise of a cancelling sum (below)
NOISE = 1e-5


def _lm(mx):
    models = jmodels if mx is jmx else tmx.models
    return models.get_transformer_lm(V, S, num_layers=L, num_heads=H,
                                     num_embed=E, fused_head=True)


def _lm_data(n=5 * B, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, V, (n, S)).astype(np.int32)
    return x, rng.randint(0, V, (n, S)).astype(np.float32)


def _spmd(which, opt):
    """An SPMDModule after 5 batches, its predictions on the first, and
    (the port's) its parameters' gradients on the first batch before
    training."""
    mx = PK[which]
    mx.random.seed(0)
    x, y = _lm_data()
    it = mx.io.NDArrayIter(x, y, batch_size=B)
    if which == "jax":
        mod = mx.mod.SPMDModule(_lm(mx), mesh=make_mesh((1,), ("data",)),
                                logger=logging)
    else:
        mod = mx.mod.SPMDModule(_lm(mx), ctx="cpu")
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Uniform(0.07))
    mod.init_optimizer(optimizer=opt, optimizer_params=LM_OPT[opt])
    first = None
    if which == "torch":
        first = mod._trainer.gradients({"data": x[:B],
                                        "softmax_label": y[:B]})
    mod.fit(it, num_epoch=1, eval_metric="torch")
    preds = mod.predict(mx.io.NDArrayIter(x[:B], y[:B], batch_size=B))
    return mod, preds, first


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_spmd_module_matches_jax(opt):
    """An element whose gradient is rounding noise (a key bias, whose
    true gradient is 0; or one whose first gradient is below NOISE of its
    parameter's largest, a sum that cancels to the rounding of its terms)
    is held apart: under Adam, which takes steps of up to lr whatever the
    noise, to 5 steps of lr; under SGD to 1e-5."""
    (j, jpred, _), (t, tpred, first) = _spmd("jax", opt), \
        _spmd("torch", opt)
    want, got = _host(j.get_params()[0]), _host(t.get_params()[0])
    # SGD moves a noise element by lr times the noise: the trajectory
    # tests' atol holds it
    bound = 5 * LM_OPT["adam"]["learning_rate"] * 1.01 if opt == "adam" \
        else 1e-5
    for k in sorted(want):
        g = first[k].abs()
        # exact zeros (embedding rows no token of the batch picks) are
        # no noise
        noisy = ((g > 0) & (g <= NOISE * g.max())).numpy() | \
            k.endswith("_k_bias")
        assert np.abs(got[k] - want[k])[noisy].max(initial=0) <= bound, k
        assert noisy.mean() < 0.01 or k.endswith("_k_bias"), k
        want[k], got[k] = want[k][~noisy], got[k][~noisy]
    want = {k: v for k, v in want.items() if v.size}
    got = {k: v for k, v in got.items() if k in want}
    _close(got, want)
    assert tpred.shape == jpred.shape == (B * S,)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-4, atol=1e-5)
    assert t.stats["train.host_blocking_fetches"] == 5


def test_spmd_module_refusals():
    with pytest.raises(MXNetError, match="one device"):
        tmx.mod.SPMDModule(_lm(tmx), mesh=(2,), ctx="cpu")
    mod = tmx.mod.SPMDModule(_lm(tmx), mesh={"data": 1}, ctx="cpu")
    mod.bind([("data", (B, S))], [("softmax_label", (B, S))])
    mod.init_params()
    with pytest.raises(MXNetError, match="sgd and adam"):
        mod.init_optimizer(optimizer="rmsprop")
    with pytest.raises(MXNetError, match="init_optimizer"):
        x, y = _lm_data(B)
        mod.forward(tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())],
                                     [tmx.nd.array(y, ctx=tmx.cpu())]),
                    is_train=True)


def test_module_defaults_to_the_card():
    mod = tmx.mod.Module(mlp(tmx))
    assert mod._context == [tmx.gpu(0)]
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            mod.bind([("data", (BATCH, DIM))],
                     [("softmax_label", (BATCH,))])
