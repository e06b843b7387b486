"""Out-of-range indices in the port against the JAX package, on the CPU.

The JAX package gathers in fill mode (`jnp.take`, `take_along_axis`): an
index in [-n, 0) wraps by n, one outside [-n, n) reads NaN and takes no
gradient, and `jax.nn.one_hot` gives it a zero row.  The port gives the
same results, where a torch gather would raise (and, on the card, trip a
device-side assert):

* `Embedding` at ``input_dim`` 8 with indices ``[[0, 3, 7, 9],
  [-1, 2, 8, 1]]``, int and float (truncated toward zero), forward and
  the weight's gradient;
* `softmax_cross_entropy` on (3, 5) logits with labels 5 (NaN loss) and
  -1 (wrapped), forward and the data's gradient;
* the serving engines (V = 61, `tests/test_torch_serving.py`'s size): a
  prompt with a token >= V decodes from NaN logits to the JAX engine's
  tokens, greedy and sampled, paged and slot; the scheduler lives, and a
  normal prompt after it, or beside it in one batch, gives the tokens of
  a fresh engine.

Bars: NaN at exactly the JAX positions; every other value within 1e-6
(float32 on both sides, the same formulas on a handful of terms).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving import TransformerKVModel as JModel
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.indexing import pick, take_rows
from mxnet_tpu_torch.serving import ServingEngine, TransformerKVModel
from test_torch_kernels import _one_thread  # noqa: F401


ATOL = 1e-6
IDX = np.array([[0, 3, 7, 9], [-1, 2, 8, 1]])


def _same(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=ATOL, rtol=0)


def _both(name, params, inputs, cot, grad_of):
    """(JAX out, JAX grads, port out, port grads) of op ``name``; the
    gradients of the inputs whose positions are in ``grad_of``."""
    jop, top = jreg.get(name), treg.get(name)
    jp, tp = jop.parse_params(params), top.parse_params(params)

    def jfn(*diff):
        args = [jnp.asarray(a) for a in inputs]
        for i, d in zip(grad_of, diff):
            args[i] = d
        return jop.apply(jreg.OpCtx(), jp, args, [])[0][0]

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(inputs[i]) for i in grad_of))
    jgrads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in grad_of:
        targs[i].requires_grad_()
    tout = top.apply(treg.OpCtx(), tp, targs, [])[0][0]
    tout.backward(torch.from_numpy(cot))
    return jout, jgrads, tout.detach(), [targs[i].grad for i in grad_of]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_embedding_matches_jax(dtype):
    idx = IDX.astype(dtype)
    if dtype == np.float32:
        idx = idx + np.float32(0.7) * np.sign(idx)  # truncates to IDX
    w = np.random.RandomState(0).randn(8, 5).astype(np.float32)
    cot = np.random.RandomState(1).randn(2, 4, 5).astype(np.float32)
    jout, jg, tout, tg = _both("Embedding", {"input_dim": 8,
                                             "output_dim": 5},
                               [idx, w], cot, grad_of=[1])
    _same(tout, jout)
    out = tout.numpy()
    assert np.isnan(out[0, 3]).all() and np.isnan(out[1, 2]).all()
    np.testing.assert_array_equal(out[1, 0], w[7])  # -1 wraps
    _same(tg[0], jg[0])
    # the rows of 9 and 8 take no gradient; row 7 takes those of 7 and -1
    np.testing.assert_allclose(tg[0].numpy()[7], cot[0, 2] + cot[1, 0],
                               atol=ATOL)


@pytest.mark.parametrize("labels", [[5, 1, 2], [-1, 1, 2], [0, 4, 3]],
                         ids=["label5", "label-1", "in_range"])
def test_softmax_cross_entropy_matches_jax(labels):
    x = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    lab = np.array(labels, np.float32)
    cot = np.array([1.5], np.float32)
    jout, jg, tout, tg = _both("softmax_cross_entropy", {}, [x, lab], cot,
                               grad_of=[0])
    _same(tout, jout)
    _same(tg[0], jg[0])
    grad = tg[0].numpy()
    if labels[0] == 5:
        assert np.isnan(tout.numpy()).all()
    if labels[0] == -1:
        logp = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
        want = -(logp[0, 4] + logp[1, 1] + logp[2, 2])  # -1 picks class 4
        np.testing.assert_allclose(tout.numpy(), [want], atol=1e-5)
    if labels[0] in (5, -1):
        # a zero one-hot row: the softmax alone, scaled
        p = np.exp(x[0]) / np.exp(x[0]).sum()
        np.testing.assert_allclose(grad[0], 1.5 * p, atol=ATOL)
    assert np.isfinite(grad).all()


def test_helpers_wrap_and_fill():
    t = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    got = take_rows(t, torch.tensor([-5, -4, -1, 0, 3, 4]))
    assert torch.isnan(got[0]).all() and torch.isnan(got[5]).all()
    torch.testing.assert_close(got[1:5], t[[0, 3, 0, 3]])
    got = pick(t, torch.tensor([2.9, -1.0, 3.0, -4.5]))
    assert got[:2].tolist() == [2.0, 5.0]
    assert torch.isnan(got[2:]).all()  # 3, and -4 (truncated from -4.5)


# -- serving ------------------------------------------------------------------

V, S, L, H, E = 61, 32, 2, 2, 32
BAD, GOOD = [3, 5, V + 9, 2], [4, 9, 11, 2, 8]


@pytest.fixture(scope="module")
def setup():
    jm = JModel(V, S, num_layers=L, num_heads=H, num_embed=E)
    tm = TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E)
    return jm, tm, jm.init_params(np.random.RandomState(7), scale=0.5)


def _kw(paged):
    return dict(max_batch=3, prefill_buckets=[8, 16], max_new_tokens=4,
                paged=paged)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "T0.8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_engine_decodes_a_token_past_the_vocab_as_jax(setup, paged,
                                                      sampled):
    jm, tm, p = setup
    req = dict(temperature=0.8, seed=5) if sampled else {}
    jeng = JServingEngine(jm, p, sampling=sampled, prefix=False,
                          **_kw(paged))
    teng = ServingEngine(tm, p, ctx="cpu", **_kw(paged))
    fresh = ServingEngine(tm, p, ctx="cpu", **_kw(paged))
    outs = []
    for eng in (jeng, teng):
        bad = eng.submit(BAD, **req)
        eng.run_until_idle(timeout=60)
        good = eng.submit(GOOD, **req)
        eng.run_until_idle(timeout=60)
        outs.append((bad.result(1), good.result(1)))
    assert outs[1] == outs[0]
    assert outs[1][0] == [0, 0, 0, 0]
    ref = fresh.submit(GOOD, **req)
    fresh.run_until_idle(timeout=60)
    assert outs[1][1] == ref.result(1)
    # the scheduler lived, and one batch holding both rows keeps them
    # apart
    together = [teng.submit(BAD, **req), teng.submit(GOOD, **req)]
    teng.run_until_idle(timeout=60)
    assert [r.result(1) for r in together] == list(outs[0])
    assert teng.stats["completed"] == 4
