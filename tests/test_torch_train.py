"""The port's training path against the JAX package's, on the CPU.

* `random`: after `seed(s)` both packages hand out the same keys, and
  `fold_in`, `split`, `bits` and `uniform` give `jax.random`'s values bit
  for bit; `initializer.Uniform` therefore draws the JAX parameters.
* `parallel.SPMDTrainer(ctx="cpu")` walks the JAX `SPMDTrainer`'s
  parameter trajectory (one-device CPU mesh) for 5 SGD and 5 Adam steps
  in both attention layouts, from the same seed, in float32; and with the
  fused CE head for 5 Adam steps in both of its backward structures,
  with the second moment stored in float32 or in bfloat16.
* `optimizer.stochastic_round_bf16` rounds as the JAX package's does, bit
  for bit, and the bfloat16 second-moment table after 5 steps is the JAX
  trainer's.

Tolerance of the trajectories: rtol 1e-4 / atol 1e-5, as
`tests/test_fused_ce.py` holds two trainers' trajectories: float32 on
both sides, differing in the order of the sums of the matrix products
and the attention.  One exception, with its reason: the gradient of a
key-projection bias (``*_k_bias``) is exactly zero in exact arithmetic
(it adds q·b to every score of a query, which the softmax cancels), so
both packages compute rounding noise of ~1e-10 there, and Adam divides
it by a square root of the same size: each step moves such an element by
up to ``lr * g / (sqrt(v) + eps)``, whatever the noise's sign.  Under
Adam those elements are held to that bound (5 steps of lr), not to each
other; SGD moves them by ~lr * noise and keeps the common tolerance.

The bfloat16 second moment: both packages round the same float32 v with
the same 16 random bits, so the stored tables are equal except where the
two float32 v (equal to ~1e-6 relative) fall on either side of a
rounding step, which moves that element by one bfloat16 ulp (2**-8 to
2**-7 of it).  `_assert_same_v` holds the tables to that: at most 1% of
the elements one ulp apart, none further (the key biases' v, the square
of noise, left out).  Keys in another parameter order leave about half
the elements apart.  The parameters move by lr * m / sqrt(v32) from the
float32 v, so they keep the common tolerance.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer, make_mesh
from mxnet_tpu_torch.base import MXNetError

V, S, L, H, E = 61, 32, 2, 2, 32
B = 4
SHAPES = {"data": (B, S), "softmax_label": (B, S)}
STEPS = 5
OPTIMIZERS = {
    "sgd": dict(optimizer="sgd", lr=1e-2, momentum=0.9, wd=1e-4),
    "adam": dict(optimizer="adam", lr=1e-3, wd=1e-4),
}


# -- random and initializer ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_keys_and_bits_equal_jax(seed):
    jmx.random.seed(seed)
    tmx.random.seed(seed)
    for _ in range(3):
        jkey, tkey = jmx.random.next_key(), tmx.random.next_key()
        assert tuple(int(w) for w in np.asarray(jkey)) == tkey
    assert tuple(int(w) for w in np.asarray(jax.random.fold_in(
        jkey, 12345))) == tmx.random.fold_in(tkey, 12345)
    for jk, tk in zip(jax.random.split(jkey, 3), tmx.random.split(tkey, 3)):
        assert tuple(int(w) for w in np.asarray(jk)) == tk
    bits = tmx.random.random_bits(tkey, (5, 7), "cpu")
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jax.random.bits(jkey, (5, 7))))


def test_uniform_and_normal_draws_equal_jax():
    """`uniform` bit for bit; `normal` to float32 rounding (torch's
    `erfinv` is not XLA's: a few ulp apart)."""
    jmx.random.seed(3)
    tmx.random.seed(3)
    want = jmx.random.uniform(-2.0, 3.0, (4000,)).asnumpy()
    got = tmx.random.uniform(-2.0, 3.0, (4000,), ctx="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    want = jmx.random.normal(1.0, 2.0, (4000,)).asnumpy()
    got = tmx.random.normal(1.0, 2.0, (4000,), ctx="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_uniform_initializer_draws_the_jax_parameters():
    """One key per weight in call order; fixed values by suffix.  The port
    fills numpy arrays and tensors alike."""
    names = [("fc_weight", (6, 5)), ("fc_bias", (6,)), ("ln_gamma", (5,)),
             ("ln_beta", (5,)), ("bn_moving_var", (3,)),
             ("embed_weight", (11, 4))]
    jmx.random.seed(9)
    jinit = jmx.init.Uniform(0.07)
    want = {}
    for n, shape in names:
        arr = jmx.nd.zeros(shape)
        jinit(n, arr)
        want[n] = arr.asnumpy()
    for as_tensor in (False, True):
        tmx.random.seed(9)
        tinit = tmx.init.Uniform(0.07)
        for n, shape in names:
            arr = torch.zeros(shape) if as_tensor else np.zeros(shape,
                                                                np.float32)
            tinit(n, arr)
            np.testing.assert_array_equal(np.asarray(arr), want[n],
                                          err_msg=n)
    with pytest.raises(MXNetError, match="unknown parameter name"):
        tinit("mystery", np.zeros(2, np.float32))


# -- the trainer ---------------------------------------------------------------


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, V, (B, S)).astype(np.int32),
            "softmax_label": rng.randint(0, V, (B, S)).astype(np.float32)}


def _jax_trainer(layout, opt, seed=0, net_kw=None, **kw):
    jmx.random.seed(seed)
    net = jmodels.get_transformer_lm(vocab_size=V, seq_len=S, num_layers=L,
                                     num_heads=H, num_embed=E,
                                     attn_layout=layout, **(net_kw or {}))
    return JaxTrainer(net, make_mesh(shape=(1,), axis_names=("data",)),
                      data_shapes=SHAPES, **OPTIMIZERS[opt], **kw)


def _port_trainer(layout, opt, seed=0, net_kw=None, **kw):
    tmx.random.seed(seed)
    net = tmx.models.get_transformer_lm(vocab_size=V, seq_len=S,
                                        num_layers=L, num_heads=H,
                                        num_embed=E, attn_layout=layout,
                                        **(net_kw or {}))
    return tmx.SPMDTrainer(net, data_shapes=SHAPES, ctx="cpu",
                           **OPTIMIZERS[opt], **kw)


def _assert_same_params(got, want, opt, what=""):
    assert sorted(got) == sorted(want)
    for n in want:
        a, b = got[n], np.asarray(want[n].asnumpy() if hasattr(
            want[n], "asnumpy") else want[n])
        if opt == "adam" and n.endswith("_k_bias"):
            bound = STEPS * OPTIMIZERS["adam"]["lr"]
            assert np.abs(a).max() <= bound and np.abs(b).max() <= bound, n
            continue
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=what + n)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("layout", ["bhsd", "bsd"])
def test_trainer_walks_the_jax_trajectory(layout, opt):
    jt, tt = _jax_trainer(layout, opt), _port_trainer(layout, opt)
    assert tt.param_names == list(jt.params)
    # the same seed draws the same initial parameters, bit for bit
    for n, v in jt.get_params()[0].items():
        np.testing.assert_array_equal(tt.get_params()[0][n], v.asnumpy())
    batch = _batch()
    for i in range(STEPS):
        jout = jt.step(batch)
        tout = tt.step(batch)
        if i == 0:
            np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                       rtol=1e-4, atol=1e-6)
    _assert_same_params(tt.get_params()[0], jt.get_params()[0], opt)


def test_load_params_carries_the_jax_weights_across():
    """A port trainer seeded elsewhere, given the JAX trainer's
    `get_params()`, walks the JAX trajectory from there; the optimizer
    state restarts."""
    jt = _jax_trainer("bhsd", "adam", seed=0)
    batch = _batch(1)
    jt.step(batch)
    tt = _port_trainer("bhsd", "adam", seed=5)
    tt.step(batch)
    arg, aux = jt.get_params()
    tmx.load_params(tt, arg, aux)
    assert tt._t == 0 and all(not m.any() for m in tt.momenta)
    jt2 = _jax_trainer("bhsd", "adam", seed=5)
    jt2_params = {n: v.asnumpy() for n, v in arg.items()}
    # a fresh JAX trainer from the same weights is the reference
    for n, v in jt2_params.items():
        jt2.params[n] = jax.numpy.asarray(v)
    for _ in range(3):
        jt2.step(batch)
        tt.step(batch)
    _assert_same_params(tt.get_params()[0], jt2.get_params()[0], "adam")


def test_load_params_checks_names_and_shapes_first():
    tt = _port_trainer("bhsd", "sgd")
    arg, _ = tt.get_params()
    before = {n: v.copy() for n, v in arg.items()}
    bad = dict(arg, embed_weight=np.zeros((V + 1, E), np.float32))
    with pytest.raises(MXNetError, match="embed_weight has shape"):
        tmx.load_params(tt, {n: v + 1 for n, v in bad.items()})
    with pytest.raises(MXNetError, match="missing"):
        tmx.load_params(tt, {n: v for n, v in arg.items()
                             if n != "pred_bias"})
    with pytest.raises(MXNetError, match="unexpected"):
        tmx.load_params(tt, dict(arg, extra_weight=np.zeros(1)))
    for n, v in tt.get_params()[0].items():
        np.testing.assert_array_equal(v, before[n])


def test_run_steps_forward_and_set_lr_follow_jax():
    jt, tt = _jax_trainer("bsd", "sgd"), _port_trainer("bsd", "sgd")
    batch = _batch(2)
    jt.run_steps(batch, 2)
    tt.run_steps(batch, 2)
    jt.set_lr(3e-2)
    tt.set_lr(3e-2)
    jt.step(batch)
    tt.step(batch)
    _assert_same_params(tt.get_params()[0], jt.get_params()[0], "sgd")
    data = {"data": batch["data"]}
    np.testing.assert_allclose(tt.forward(data)[0].numpy(),
                               np.asarray(jt.forward(data)[0]), rtol=1e-4,
                               atol=1e-6)


def test_bf16_compute_keeps_float32_masters():
    """``dtype=bfloat16`` casts every floating argument but the labels;
    masters, gradients and optimizer state stay float32."""
    tt = _port_trainer("bhsd", "adam", dtype="bfloat16")
    batch = _batch(3)
    out = tt.step(batch)[0]
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tt.params.values())
    assert all(m.dtype == torch.float32 for m in tt.momenta + tt._adam_v)
    grads = tt.gradients(batch)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(torch.isfinite(p).all() for p in tt.params.values())


def test_trainer_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    net = tmx.models.get_transformer_lm(V, S, num_layers=1, num_heads=H,
                                        num_embed=E)
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.SPMDTrainer(net, data_shapes=SHAPES)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=(2,)), "one device"),
    (dict(mesh={"data": 2, "model": 1}), "one device"),
    (dict(param_sharding={"pred_weight": None}), "param_sharding"),
    (dict(abstract=True), "abstract"),
    (dict(optimizer="adam", adam_v_dtype="float16"), "adam_v_dtype"),
    (dict(optimizer="rmsprop"), "sgd and adam"),
    (dict(dtype="int8"), "compute dtype"),
])
def test_refused_keywords_raise(kw, match):
    net = tmx.models.get_transformer_lm(V, S, num_layers=1, num_heads=H,
                                        num_embed=E)
    with pytest.raises(MXNetError, match=match):
        tmx.SPMDTrainer(net, data_shapes=SHAPES, ctx="cpu", **kw)


def test_vocab_sharded_head_is_refused(monkeypatch):
    monkeypatch.setenv("MXNET_CE_SHARD", "1")
    net = tmx.models.get_transformer_lm(V, S, num_layers=1, num_heads=H,
                                        num_embed=E)
    with pytest.raises(MXNetError, match="CE_SHARD"):
        tmx.SPMDTrainer(net, data_shapes=SHAPES, ctx="cpu")


# -- the fused CE head and the bfloat16 second moment --------------------------


def _assert_same_v(tt, jt):
    """The port's stored second moments against the JAX trainer's: equal,
    or one bfloat16 ulp (at most 2**-7 of the value) apart on at most 1%
    of the elements.  The key biases' v is the square of rounding noise
    in both packages (see the module's note), so it is left out."""
    apart = total = 0
    for pos, n in enumerate(tt.param_names):
        assert tt._adam_v[pos].dtype == torch.bfloat16
        if n.endswith("_k_bias"):
            continue
        got = tt._adam_v[pos].float().numpy()
        want = np.asarray(jt.momenta[n][1]).astype(np.float32)
        diff = np.abs(got - want)
        assert (diff <= 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
                ).all(), n
        apart += int((diff > 0).sum())
        total += got.size
    assert apart <= 0.01 * total, (apart, total)


@pytest.mark.parametrize("v_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("single_pass", ["1", "0"])
def test_fused_head_trainer_walks_the_jax_trajectory(monkeypatch,
                                                     single_pass, v_dtype):
    """``fused_head=True`` under Adam, in the single-pass ('1') and 5-pass
    ('0') structures, with v stored in float32 (None) or bfloat16."""
    monkeypatch.setenv("MXNET_CE_SINGLE_PASS", single_pass)
    kw = dict(net_kw=dict(fused_head=True), adam_v_dtype=v_dtype)
    jt = _jax_trainer("bhsd", "adam", **kw)
    tt = _port_trainer("bhsd", "adam", **kw)
    batch = _batch()
    for i in range(STEPS):
        jout = jt.step(batch)
        tout = tt.step(batch)
        if i == 0:
            # the head's output is the per-token NLL
            assert tout[0].shape == (B * S,)
            np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                       rtol=1e-4, atol=1e-5)
    _assert_same_params(tt.get_params()[0], jt.get_params()[0], "adam")
    if v_dtype:
        _assert_same_v(tt, jt)
    data = {"data": batch["data"]}
    np.testing.assert_allclose(tt.forward(data)[0].numpy(),
                               np.asarray(jt.forward(data)[0]), rtol=1e-4,
                               atol=1e-5)


def test_stochastic_round_bf16_equals_jax_bit_for_bit():
    """The same float32 input and key give the same bfloat16 bits: values
    on and between bfloat16 steps, of both signs, tiny and huge, zeros;
    and the batched form (one key a row) equals the row-by-row calls."""
    from mxnet_tpu.optimizer import stochastic_round_bf16 as jround
    from mxnet_tpu_torch.optimizer import stochastic_round_bf16 as tround
    rng = np.random.RandomState(11)
    x = (rng.randn(3, 257) * np.exp(rng.randn(3, 257) * 8)).astype(
        np.float32)
    x[0, :4] = [0.0, -0.0, 1.0, -3.0]
    x[1, :2] = [np.float32(1 + 2 ** -8), np.float32(2 ** -126)]
    for seed in (7, 0x51CA57):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        tkey = tmx.random.fold_in(tmx.random.prng_key(seed), 3)
        want = np.asarray(jround(jax.numpy.asarray(x), jkey)).view(np.uint16)
        got = tround(torch.from_numpy(x), tkey)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16), want)
        keys = [tmx.random.fold_in(tkey, i) for i in range(3)]
        k1 = torch.tensor([[k[0]] for k in keys])
        k2 = torch.tensor([[k[1]] for k in keys])
        batched = tround(torch.from_numpy(x), (k1, k2))
        for i, k in enumerate(keys):
            assert torch.equal(batched[i].view(torch.int16),
                               tround(torch.from_numpy(x[i]), k).view(
                                   torch.int16))
    # rounding is unbiased: the mean of many draws is the value
    y = torch.full((20000,), 1.0 + 2 ** -10)
    drawn = tround(y, tmx.random.prng_key(5)).float()
    assert set(np.unique(drawn.numpy())) == {1.0, np.float32(1 + 2 ** -7)}
    assert abs(float(drawn.mean()) - (1 + 2 ** -10)) < 2e-4
