"""The port's registered ops of the LM training path against the JAX
package's, on the CPU.

Each op's ``apply`` runs in both packages on the same numpy inputs (made
from a seed): the JAX op under `jax.vjp`, the port's under torch
autograd, with the same random cotangent.  Forward outputs, input
gradients and ``infer_shape`` must agree.

Tolerances: float32 on both sides with the same formulas, so outputs and
gradients differ only in the order of the sums (a matrix product over at
most 60 terms, a softmax over 7 classes, attention over 24 keys): 1e-5
absolute on values of magnitude ~1.  The ops that reach a kernel take its
plain version here; `test_torch_kernels.py` holds those against the
Pallas bodies.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import mxnet_tpu.ops  # noqa: F401  (registers the JAX package's ops)
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from test_torch_kernels import _one_thread  # noqa: F401


ATOL = 1e-5


def _run(name, params, inputs, diff, *, is_train=False, seed=0):
    """(JAX out, port out, JAX grads, port grads) of op ``name`` on the
    numpy ``inputs``, differentiating the inputs at positions ``diff``
    with one random cotangent.  Also checks that both packages infer the
    same shapes from the first input's."""
    jop, top = jreg.get(name), treg.get(name)
    jp, tp = jop.parse_params(params), top.parse_params(params)
    shapes = [tuple(inputs[0].shape)] + [None] * (len(inputs) - 1)
    assert top.infer_shape(tp, shapes) == jop.infer_shape(jp, shapes)

    def jfn(*d):
        args = [jnp.asarray(a) for a in inputs]
        for i, a in zip(diff, d):
            args[i] = a
        outs, _ = jop.apply(jreg.OpCtx(is_train=is_train), jp, args, [])
        return outs[0]

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(inputs[i]) for i in diff))
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))

    targs = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in diff:
        targs[i].requires_grad_()
    touts, aux = top.apply(treg.OpCtx(is_train=is_train), tp, targs, [])
    assert aux == []
    touts[0].backward(torch.from_numpy(cot))
    return (np.asarray(jout), touts[0].detach().numpy(),
            [np.asarray(g) for g in jgrads],
            [targs[i].grad.numpy() for i in diff])


def _assert_same(name, params, inputs, diff, **kw):
    jout, tout, jgrads, tgrads = _run(name, params, inputs, diff, **kw)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=1e-6)
    for i, a, b in zip(diff, tgrads, jgrads):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-6,
                                   err_msg="grad of input %d" % i)


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "gelu"])
def test_activation_matches_jax(act):
    _assert_same("Activation", {"act_type": act}, [_randn(4, 9, scale=2)],
                 [0])


def test_gelu_is_the_tanh_form():
    """`jax.nn.gelu` defaults to the tanh approximation; torch's `F.gelu` to
    the erf form, which differs from it by up to 5e-4, 50x the
    tolerance."""
    x = torch.linspace(-4, 4, 801)
    got = treg.get("Activation").apply(
        treg.OpCtx(), {"act_type": "gelu"}, [x], [])[0][0]
    torch.testing.assert_close(got, F.gelu(x, approximate="tanh"))
    assert (got - F.gelu(x)).abs().max() > 10 * ATOL


def test_activation_refuses_unknown_type():
    with pytest.raises(MXNetError, match="act_type"):
        treg.get("Activation").apply(treg.OpCtx(), {"act_type": "swish"},
                                     [torch.zeros(2)], [])


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected_matches_jax(no_bias):
    """Weight (num_hidden, in); data (4, 3, 5) flattens to (4, 15)."""
    ins = [_randn(4, 3, 5, seed=1), _randn(6, 15, seed=2)]
    if not no_bias:
        ins.append(_randn(6, seed=3))
    _assert_same("FullyConnected", {"num_hidden": 6, "no_bias": no_bias},
                 ins, list(range(len(ins))))


def test_embedding_matches_jax():
    """Repeated ids: the table's gradient sums their rows (scatter-add)."""
    ids = np.array([[0, 3, 3], [7, 0, 3]], np.float32)
    _assert_same("Embedding", {"input_dim": 8, "output_dim": 5},
                 [ids, _randn(8, 5, seed=4)], [1])


@pytest.mark.parametrize("shape,x_shape", [
    ((-1, 6), (2, 3, 6)),
    ((0, -1), (2, 3, 6)),
    ((0, 0, 2, -1), (4, 3, 6)),
    ((-1,), (5, 2)),
])
def test_reshape_matches_jax(shape, x_shape):
    _assert_same("Reshape", {"shape": shape},
                 [_randn(*x_shape, seed=5)], [0])


def test_reshape_refuses_a_size_mismatch():
    op = treg.get("Reshape")
    with pytest.raises(MXNetError, match="size mismatch"):
        op.infer_shape(op.parse_params({"shape": (5, -1)}), [(2, 3)])


def test_plus_and_broadcast_plus_match_jax():
    a, b = _randn(2, 3, 4, seed=6), _randn(2, 3, 4, seed=7)
    _assert_same("_Plus", {}, [a, b], [0, 1])
    _assert_same("broadcast_plus", {}, [a, _randn(1, 3, 4, seed=8)], [0, 1])


@pytest.mark.parametrize("axes", [(0, 2, 1, 3), None])
def test_transpose_matches_jax(axes):
    params = {} if axes is None else {"axes": axes}
    _assert_same("transpose", params, [_randn(2, 3, 4, 5, seed=9)], [0])


def test_transpose_is_a_view():
    """The attention kernels read the transposed operands through their
    strides: the op copies nothing."""
    x = torch.zeros(2, 3, 4, 5)
    op = treg.get("transpose")
    y = op.apply(treg.OpCtx(), op.parse_params({"axes": (0, 2, 1, 3)}),
                 [x], [])[0][0]
    assert y.data_ptr() == x.data_ptr() and not y.is_contiguous()


def test_dropout_at_inference_is_the_identity_as_in_jax():
    _assert_same("Dropout", {"p": 0.5}, [_randn(3, 4, seed=10)], [0])


def test_dropout_draws_an_inverted_mask_from_the_op_generator():
    """Training: each element is kept with probability 1 - p and scaled by
    1/(1 - p), its gradient alike; the same generator seed gives the same
    mask.  The draws are PyTorch's, not JAX's bits."""
    op = treg.get("Dropout")
    params = op.parse_params({"p": 0.25})
    x = torch.ones(200, 100, requires_grad=True)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return op.apply(treg.OpCtx(is_train=True, rng=gen), params, [x],
                        [])[0][0]

    y = run(3)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.equal(run(3), y) and not torch.equal(run(4), y)
    y.sum().backward()
    torch.testing.assert_close(x.grad, kept.float() / 0.75)
    with pytest.raises(MXNetError, match="random generator"):
        op.apply(treg.OpCtx(is_train=True), params, [x], [])


@pytest.mark.parametrize("layout,causal", [("bhsd", True), ("bhsd", False),
                                           ("bsd", True)])
def test_dot_product_attention_matches_jax(layout, causal):
    if layout == "bsd":
        params = {"causal": causal, "layout": "bsd", "num_heads": 2}
        ins = [_randn(2, 24, 32, seed=s, scale=0.5) for s in (11, 12, 13)]
    else:
        params = {"causal": causal}
        ins = [_randn(2, 2, 24, 16, seed=s, scale=0.5) for s in (11, 12, 13)]
    _assert_same("DotProductAttention", params, ins, [0, 1, 2])


def test_layer_norm_op_matches_jax():
    _assert_same("LayerNorm", {"eps": 1e-5},
                 [_randn(2, 5, 16, seed=14, scale=2),
                  1 + _randn(16, seed=15, scale=0.1),
                  _randn(16, seed=16, scale=0.1)], [0, 1, 2])


@pytest.mark.parametrize("grad_scale,use_ignore", [(1.0, False), (0.5, True)])
def test_softmax_output_matches_jax(grad_scale, use_ignore):
    """Forward: softmax over axis 1.  Backward, in both packages: the
    incoming cotangent is ignored; (softmax - onehot(label)) * grad_scale,
    rows whose label is ``ignore_label`` zeroed under ``use_ignore``.  A
    label outside [0, classes) subtracts nothing (`jax.nn.one_hot`)."""
    data = _randn(6, 7, seed=17, scale=2)
    label = np.array([0, 6, 3, -1, 3, 9], np.float32)
    params = {"grad_scale": grad_scale, "use_ignore": use_ignore,
              "ignore_label": 3}
    jout, tout, _, (tgrad,) = _run("SoftmaxOutput", params, [data, label],
                                   [0])
    _assert_same("SoftmaxOutput", params, [data, label], [0])
    sm = torch.softmax(torch.from_numpy(data), dim=1).numpy()
    want = sm.copy()
    for i, lbl in enumerate(label.astype(int)):
        if 0 <= lbl < 7:
            want[i, lbl] -= 1
        if use_ignore and lbl == 3:
            want[i] = 0
    np.testing.assert_allclose(tgrad, want * grad_scale, atol=ATOL, rtol=0)


def test_softmax_output_never_builds_a_one_hot():
    """The backward subtracts 1 at [row, label] of a copy of the softmax:
    nothing of size rows x classes besides that copy (at the parity shape a
    float32 one-hot would be 4.3 GB)."""
    op = treg.get("SoftmaxOutput")
    data = torch.randn(4, 5, requires_grad=True)
    out = op.apply(treg.OpCtx(), op.parse_params({}),
                   [data, torch.tensor([1.0, 0, 4, 2])], [])[0][0]
    out.backward(torch.full_like(out, 7.0))  # ignored
    want = torch.softmax(data.detach(), 1)
    want[torch.arange(4), torch.tensor([1, 0, 4, 2])] -= 1
    torch.testing.assert_close(data.grad, want)
