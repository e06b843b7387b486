"""The port's MoE serving against the JAX package's, on the CPU.

A `TransformerKVModel` with ``moe_experts=4`` at the size of
`tests/test_torch_serving_prefix.py` (V, S, L, H, E = 61, 32, 2, 2, 32,
seed 7, scale 0.5):

* the parameter set: `init_params` draws the JAX arrays from the same
  `RandomState`, `params_from_jax` carries them, and weight quant leaves
  the router and the (E, ., .) expert banks in full precision in both
  packages;
* every program (`prefill`, `decode`, `prefill_paged`, `decode_paged`,
  `verify_paged`, `decode_megastep`) in float32 and under int8 weights
  (with int8 K/V on the paged ones): logits within 2e-5 of the JAX
  program's largest logit, and the routing tapes equal count for count,
  padding rows included, after checking that every routed row's top-1
  probability beats its top-2 by more than 1e-5 (so no near tie decides);
* both engines (slot, paged, megastep m=4, n-gram speculation) on the
  same requests: tokens equal where every position's top-1/top-2 logit
  margin exceeds 1e-3, `expert_load()` equal to the JAX engine's, the
  ``serve.<name>.expert_load.<i>`` gauges equal to it, and a dense
  engine's `expert_load()` None.

The JAX programs are jitted, their tapes returned as outputs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.executor import AotCache
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving import TransformerKVModel as JModel
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.serving import ServingEngine, TransformerKVModel

from test_torch_serving_prefix import margins
from test_torch_kernels import _one_thread  # noqa: F401

V, S, L, H, E, NE = 61, 32, 2, 2, 32, 4
BS = 4
PROGRAM_RTOL = 2e-5
ROUTE_MARGIN = 1e-5


def _models(ne=NE):
    return (JModel(V, S, num_layers=L, num_heads=H, num_embed=E,
                   moe_experts=ne),
            TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E,
                               moe_experts=ne))


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def wparams(models):
    return models[0].init_params(np.random.RandomState(7), scale=0.5)


@pytest.fixture(autouse=True)
def _fresh():
    telemetry.reset()
    jtelemetry.reset()
    yield
    telemetry.reset()
    jtelemetry.reset()


# -- parameters ---------------------------------------------------------------


def test_moe_parameters_follow_jax(models, wparams):
    jm, tm = models
    assert tm.param_shapes() == jm.param_shapes()
    assert "layer0_ffn1_weight" not in tm.param_shapes()
    assert tm.param_shapes()["layer1_moe_w1"] == (NE, E, 4 * E)
    assert tm.param_shapes()["layer1_moe_w2"] == (NE, 4 * E, E)
    assert tm.param_shapes()["layer1_moe_router_weight"] == (E, NE)
    mine = tm.init_params(np.random.RandomState(7), scale=0.5)
    assert sorted(mine) == sorted(wparams)
    for k in wparams:
        np.testing.assert_array_equal(mine[k], wparams[k])
    tp = tm.params_from_jax(wparams, "cpu")
    assert tp["layer0_moe_w2"].shape == (NE, 4 * E, E)
    bad = dict(wparams, layer0_moe_w1=np.zeros((NE + 1, E, 4 * E),
                                               np.float32))
    with pytest.raises(Exception, match="layer0_moe_w1"):
        tm.params_from_jax(bad, "cpu")
    # weight quant leaves the router and the expert banks unquantized in
    # both packages; the projections, embedding and head are quantized
    jq = jm.with_quant("int8", None).quantize_params(wparams)
    tq = tm.with_quant("int8", None).quantize_params(tp)
    assert sorted(jq) == sorted(tq)
    for q in (jq, tq):
        for name in ("layer0_moe_w1", "layer1_moe_w2",
                     "layer0_moe_router_weight"):
            assert name + "_qscale" not in q
            assert str(q[name].dtype).endswith("float32")
        assert "layer0_q_weight_qscale" in q and \
            str(q["layer0_q_weight"].dtype).endswith("int8")


# -- the programs -------------------------------------------------------------


def _route_probe(tm):
    """Patch the port model's `_ffn` to record each call's smallest
    top-1 minus top-2 router probability; returns the list."""
    out = []
    orig = tm._ffn

    def ffn(params, h2, p, tape=None):
        probs = torch.softmax(
            h2.float() @ params[p + "moe_router_weight"].float(), dim=-1)
        top = probs.topk(2, dim=-1).values
        out.append(float((top[:, 0] - top[:, 1]).min()))
        return orig(params, h2, p, tape)
    tm._ffn = ffn
    return out


def _jit_taped(fn, *static):
    """``fn`` jitted with its ``moe_tape`` returned as a second output."""
    def prog(*args):
        tape = []
        return fn(*args, *static, moe_tape=tape), tape
    return jax.jit(prog)


def _close(t, j):
    j = np.asarray(j)
    err = np.abs(t.detach().numpy() - j).max()
    assert err <= PROGRAM_RTOL * np.abs(j).max(), (err, np.abs(j).max())


def _same_tapes(ttape, jtape):
    assert len(ttape) == len(jtape) > 0
    for a, b in zip(ttape, jtape):
        assert a.tolist() == np.asarray(b).tolist()


QMODES = [("0", "0"), ("int8", "int8")]


@pytest.mark.parametrize("quant,kv", QMODES, ids=["f32", "int8"])
def test_moe_programs_match_jax(models, wparams, quant, kv):
    """Slot prefill and decode, then the paged chunk prefill, decode,
    verify and a 4-step megastep (a row finishing on its budget and a
    padding row), each from the same cache in both packages: logits
    within 2e-5 relative and the tapes equal, padding rows included."""
    jm0 = models[0]
    tm = TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E,
                            moe_experts=NE).with_quant(quant, kv)
    jm = jm0.with_quant(quant, kv)
    jms, tms = jm0.with_quant(quant, "0"), tm.with_quant(quant, "0")
    jp = jm.quantize_params(wparams)
    pj = {k: jnp.asarray(v) for k, v in jp.items()}
    tp = tm.params_from_jax(jp, "cpu")
    probe = _route_probe(tm)
    tms._ffn = tm._ffn
    rng = np.random.RandomState(5)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    # slot cache: a 3-row prefill (one padded past its length), a decode
    toks = rng.randint(0, V, (3, 16)).astype(np.int32)
    length = np.array([16, 5, 9], np.int32)
    (jl, jkv), jt = _jit_taped(jms.prefill)(pj, toks, length)
    tt = []
    tl, tkv = tms.prefill(tp, t(toks), t(length), moe_tape=tt)
    _close(tl, jl)
    _same_tapes(tt, jt)
    slots = np.array([0, 1, 2], np.int32)
    jcache = jms.write_prefill(jms.init_cache(4), jkv, length, slots)
    tcache = tms.write_prefill(tms.init_cache(4, "cpu"), tkv, t(length),
                               t(slots))
    dec = (rng.randint(0, V, 3).astype(np.int32), length, slots)
    (jl, _), jt = _jit_taped(jms.decode)(pj, jcache, *dec)
    tt = []
    tl, _ = tms.decode(tp, tcache, *map(t, dec), moe_tape=tt)
    _close(tl, jl)
    _same_tapes(tt, jt)

    # paged pool
    tables = np.zeros((3, S // BS), np.int32)
    tables[0, :5] = [1, 2, 3, 4, 5]
    tables[1, :5] = [6, 7, 8, 9, 10]
    jpool = jm.init_block_pool(16, BS)
    tpool = tm.init_block_pool(16, BS, "cpu")
    pre = (rng.randint(0, V, (3, 8)).astype(np.int32),
           np.zeros(3, np.int32), np.array([7, 8, 1], np.int32), tables)
    (jl, jpool), jt = _jit_taped(jm.prefill_paged)(pj, jpool, *pre)
    tt = []
    tl, tpool = tm.prefill_paged(tp, tpool, *map(t, pre), moe_tape=tt)
    _close(tl, jl)
    _same_tapes(tt, jt)
    dec = (rng.randint(0, V, 3).astype(np.int32),
           np.array([7, 8, 0], np.int32), tables)
    (jl, jpool), jt = _jit_taped(jm.decode_paged)(pj, jpool, *dec)
    tt = []
    tl, tpool = tm.decode_paged(tp, tpool, *map(t, dec), moe_tape=tt)
    _close(tl, jl)
    _same_tapes(tt, jt)
    ver = (rng.randint(0, V, (3, 3)).astype(np.int32),
           np.array([8, 9, 0], np.int32), np.array([3, 2, 1], np.int32),
           tables)
    (jl, jpool), jt = _jit_taped(jm.verify_paged)(pj, jpool, *ver)
    tt = []
    tl, tpool = tm.verify_paged(tp, tpool, *map(t, ver), moe_tape=tt)
    _close(tl, jl)
    _same_tapes(tt, jt)
    mega = (np.array([3, 4, 0], np.int32), np.array([11, 11, 0], np.int32),
            np.array([4, 2, 0], np.int32), np.array([-1, -1, -1], np.int32),
            tables)
    (jgrid, jpool), jt = _jit_taped(
        jm.decode_megastep, 4,
        lambda lg, np_: jnp.argmax(lg, axis=-1).astype(jnp.int32))(
            pj, jpool, *mega)
    tt = []
    tgrid, tpool = tm.decode_megastep(tp, tpool, *map(t, mega), 4,
                                      lambda lg, np_: lg.argmax(dim=-1),
                                      moe_tape=tt)
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    # one count for the whole run: 4 steps x 3 rows x L layers
    assert len(tt) == 1 and int(tt[0].sum()) == 4 * 3 * L
    _same_tapes(tt, jt)
    assert min(probe) > ROUTE_MARGIN, min(probe)


def megastep_tapes():
    """A 2-expert model's 3-step megastep over two rows and a padding row
    in both packages: (JAX tape, port tape), each one (2,) count."""
    jm, tm = _models(2)
    params = jm.init_params(np.random.RandomState(3), scale=0.5)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tm.params_from_jax(params, "cpu")
    tables = np.zeros((3, S // BS), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :2] = [3, 4]
    args = (np.array([5, 6, 0], np.int32), np.array([2, 3, 0], np.int32),
            np.array([3, 1, 0], np.int32), np.array([-1, -1, -1], np.int32),
            tables)
    (_, _), jt = _jit_taped(
        jm.decode_megastep, 3,
        lambda lg, np_: jnp.argmax(lg, axis=-1).astype(jnp.int32))(
            pj, jm.init_block_pool(6, BS), *args)
    tt = []
    tm.decode_megastep(tp, tm.init_block_pool(6, BS, "cpu"),
                       *(torch.from_numpy(a) for a in args), 3,
                       lambda lg, np_: lg.argmax(dim=-1), moe_tape=tt)
    return jt, tt


def verify_tapes():
    """A 2-expert model's 3-token verify over two rows in both packages:
    (JAX tape, port tape), a (2,) count a layer."""
    jm, tm = _models(2)
    params = jm.init_params(np.random.RandomState(3), scale=0.5)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tm.params_from_jax(params, "cpu")
    tables = np.zeros((2, S // BS), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :2] = [3, 4]
    args = (np.array([[5, 6, 7], [8, 9, 1]], np.int32),
            np.array([2, 3], np.int32), np.array([3, 2], np.int32), tables)
    (_, _), jt = _jit_taped(jm.verify_paged)(pj, jm.init_block_pool(6, BS),
                                            *args)
    tt = []
    tm.verify_paged(tp, tm.init_block_pool(6, BS, "cpu"),
                    *(torch.from_numpy(a) for a in args), moe_tape=tt)
    return jt, tt


# -- the engines --------------------------------------------------------------


KW = dict(max_batch=4, decode_buckets=[2, 4], prefill_buckets=[8, 16],
          max_new_tokens=6)
_AOT = {}


def _prompts(seed=1, sizes=(3, 9, 14, 6, 5)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=n).tolist() for n in sizes]


def _serve(eng, prompts):
    eng.warmup()
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_idle(timeout=120)
    return [r.result(1) for r in reqs]


def _gauges(reg, name):
    return [reg.gauge("serve.%s.expert_load.%d" % (name, i)).value
            for i in range(NE)]


MODES = {"slot": dict(paged=False), "paged": {},
         "megastep": dict(megastep=True, megastep_steps=4),
         "ngram": dict(spec=True, spec_drafter="ngram", spec_k=4)}


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_matches_jax(models, wparams, mode):
    """The same requests through both engines: the tokens (under the
    margin rule), `expert_load()` count for count, and each package's
    gauges equal to its `expert_load()`."""
    jm, tm = models
    kw = dict(KW, **MODES[mode])
    key = (mode,)
    if key not in _AOT:
        _AOT[key] = AotCache("serve.aot")
    jeng = JServingEngine(jm, wparams, sampling=False, aot=_AOT[key],
                          name="moe_" + mode, **kw)
    teng = ServingEngine(tm, wparams, ctx="cpu", name="moe_" + mode, **kw)
    prompts = _prompts()
    # a repeated prompt gives the n-gram drafter a confident round
    prompts = prompts + [prompts[1]]
    want = _serve(jeng, prompts)
    m = margins(jm, wparams, list(zip(prompts, want)))
    assert m.min() > 1e-3, m.min()
    got = _serve(teng, prompts)
    assert got == want
    jload, tload = jeng.expert_load(), teng.expert_load()
    assert tload.tolist() == jload.tolist() and tload.sum() > 0
    assert _gauges(telemetry.registry(), teng.name) == tload.tolist()
    assert _gauges(jtelemetry.registry(), jeng.name) == jload.tolist()
    assert teng.leaked_blocks() == 0
    if mode == "megastep":
        assert teng.stats["megasteps"] > 0
    if mode == "ngram":
        assert teng.stats["verify_steps"] > 0


def test_moe_counts_padding_rows(models, wparams):
    """A decode bucket of 4 over one live row counts 4 rows a layer: the
    padding rows route too, as in the JAX engine."""
    tm = models[1]
    teng = ServingEngine(tm, wparams, ctx="cpu",
                         **dict(KW, decode_buckets=[4], prefill_buckets=[16]))
    teng.warmup()
    assert teng.expert_load().tolist() == [0] * NE   # warmup counts none
    teng.submit([3, 4, 5], max_new_tokens=3)
    teng.run_until_idle(timeout=60)
    st = teng.stats
    rows = 16 * st["prefill_chunks"] + 4 * st["decode_steps"]
    assert int(teng.expert_load().sum()) == L * rows


def test_dense_engine_has_no_expert_load():
    tm = TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E)
    params = tm.init_params(np.random.RandomState(7))
    eng = ServingEngine(tm, params, ctx="cpu", **KW)
    assert eng.expert_load() is None
    assert eng._moe_pending == []
