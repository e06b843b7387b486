"""The port's quantization against the JAX package's, on the CPU.

* The codec (`mxnet_tpu_torch.quant.codec`): `quantize` at every channel
  axis, `quantize_rows`, `dequantize` and the wire format, int8 and fp8,
  on numpy arrays and on tensors, bit-equal to the JAX codec on the same
  numpy inputs (fp8 compared as the bits of ``float8_e4m3fn``; the JAX
  codec stores them through ``ml_dtypes``, the port through
  ``torch.float8_e4m3fn``); `quantize_params`' names and every
  ``_qscale`` bit-equal too; `gather_paged_scales` equal.
* The paged programs under int8 KV and int8/fp8 weights
  (`prefill_paged`, `decode_paged`, `verify_paged`, `decode_megastep`,
  `copy_block`, `write_block`) against the JAX ones from the same pool:
  logits within 2e-5 (the bound `tests/test_torch_serving.py` holds the
  programs to), the int8 pools equal and their scales within 1e-5
  relative (a row's scale is its largest |value| / 127, and the two
  packages compute that value in another summation order: a few ulps).
* `parity_report` against the JAX one: the same token streams, and
  ``logit_err_max`` / ``logit_err_rel`` within 2e-5 of the JAX values.
* Both engines on the same traffic with weights int8, weights fp8, KV
  int8, and both; with speculation (n-gram and model drafter); with the
  host tier spilling int8 pairs; under ``scale_corrupt``: greedy tokens
  equal where every generated position's top-1/top-2 logit margin,
  from the JAX model's own quantized paged programs, exceeds 1e-3 (the
  rule of the other `tests/test_torch_serving*.py`), `stats` equal key
  for key, the same requests failing with the same error types, and no
  block leaked after the run.

The models are the JAX test file's (V, S, L, H, E = 61, 64, 2, 2, 32,
block size 4) with weights at scale 0.5, as the port's other serving
tests draw them, so that logit margins clear the rule.  The port runs
with ``ctx="cpu"``, the plain LayerNorm.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.executor import AotCache
from mxnet_tpu.ops.attention import gather_paged_scales as jgather_scales
from mxnet_tpu.quant import codec as jcodec
from mxnet_tpu.quant import parity_report as jparity_report
from mxnet_tpu.serving import ServeQuantError as JServeQuantError
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving import TransformerKVModel as JModel
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.attention import gather_paged_scales
from mxnet_tpu_torch.quant import codec
from mxnet_tpu_torch.quant import parity_report
from mxnet_tpu_torch.serving import (ServeQuantError, ServingEngine,
                                     TransformerKVModel)
from test_torch_kernels import _one_thread  # noqa: F401


V, S, L, H, E = 61, 64, 2, 2, 32
BS = 4
MARGIN = 1e-3
PROGRAM_ATOL = 2e-5
TELEMETRY = ("shed", "expired", "cancelled", "degraded", "block_waits",
             "preempted", "stalled", "drained")
CLOCKS = ("wall_s", "host_s", "hidden_s", "fetch_wait_s")
# the JAX engine's stats the port has no counterpart for (disaggregated
# serving's)
JAX_ONLY = ("handoffs", "handoffs_in", "handoff_fails")
_AOT = {}


@pytest.fixture(scope="module")
def models():
    return (JModel(V, S, num_layers=L, num_heads=H, num_embed=E),
            TransformerKVModel(V, S, num_layers=L, num_heads=H, num_embed=E))


@pytest.fixture(scope="module")
def wparams(models):
    return models[0].init_params(np.random.RandomState(7), scale=0.5)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("MXNET_CHAOS", "MXNET_SERVE_QUANT", "MXNET_SERVE_KV_QUANT"):
        monkeypatch.delenv(name, raising=False)
    for mod in (jtelemetry, telemetry):
        mod.reset()
    for mod in (jchaos, chaos):
        mod.reset()
    yield
    for mod in (jtelemetry, telemetry):
        mod.reset()
    for mod in (jchaos, chaos):
        mod.reset()


def _bits(q):
    """The raw bits of a quantized array or tensor, as numpy uint8/int8."""
    if isinstance(q, torch.Tensor):
        if q.dtype == torch.float8_e4m3fn:
            return q.view(torch.uint8).numpy()
        return q.numpy()
    q = np.asarray(q)
    if q.dtype.name == "float8_e4m3fn":
        return q.view(np.uint8)
    return q


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the codec ----------------------------------------------------------------


def _inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(6, 5, 40) * 3).astype(np.float32)
    w[1] = 0.0                       # a dead channel: scale 1
    w[2, :, 3] = 1e3                 # an outlier sets its channel's amax
    # values on rounding's half-way points, after the scale
    w[3, 0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5,
                            127], np.float32)
    return w


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_is_bit_equal_to_jax(fmt, axis):
    w = _inputs()
    jq, js = jcodec.quantize(w, fmt, axis=axis)
    for x in (w, torch.from_numpy(w)):
        q, s = codec.quantize(x, fmt, axis=axis)
        assert np.array_equal(_bits(q), _bits(jq))
        assert np.array_equal(_np(s), np.asarray(js))
        assert _np(s).dtype == np.float32
        got = codec.dequantize(q, s, axis=axis)
        assert np.array_equal(_np(got), np.asarray(
            jcodec.dequantize(jq, js, axis=axis)))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_rows_and_dequantize_are_bit_equal_to_jax(fmt):
    w = _inputs()
    jq, js = jcodec.quantize_rows(w, fmt)
    for x in (w, torch.from_numpy(w)):
        q, s = codec.quantize_rows(x, fmt)
        assert np.array_equal(_bits(q), _bits(jq))
        assert np.array_equal(_np(s), np.asarray(js))
        assert np.array_equal(_np(codec.dequantize(q, s)),
                              np.asarray(jcodec.dequantize(jq, js)))
    # the dead channel round-trips to exact zeros
    assert not codec.dequantize(*codec.quantize_rows(w, fmt))[1].any()


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(10, 100), (3,), (700,), ()])
def test_wire_round_trip_is_bit_equal_to_jax(fmt, shape):
    arr = np.asarray(np.random.RandomState(2).randn(*shape) * 5, np.float32)
    msg, jmsg = codec.encode_wire(arr, fmt), jcodec.encode_wire(arr, fmt)
    assert np.array_equal(_bits(msg["q"]), _bits(jmsg["q"]))
    assert np.array_equal(msg["scale"], jmsg["scale"])
    assert {k: msg[k] for k in ("shape", "dtype", "format", "group")} == \
        {k: jmsg[k] for k in ("shape", "dtype", "format", "group")}
    out = codec.decode_wire(msg)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    assert np.array_equal(out, jcodec.decode_wire(jmsg))
    assert codec.wire_nbytes(msg) == jcodec.wire_nbytes(jmsg)


def test_resolve_and_specs_follow_jax():
    for off in (None, "", "0", "none", "off", "false", "no", "bf16", "fp32"):
        assert codec.resolve(off) is None and jcodec.resolve(off) is None
    assert codec.resolve("INT8") == codec.QuantSpec("int8")
    assert codec.resolve("fp8").qmax == jcodec.resolve("fp8").qmax == 448.0
    assert codec.QuantSpec("int8").qmax == 127.0
    assert codec.fp8_supported()
    with pytest.raises(MXNetError):
        codec.resolve("int4")
    with pytest.raises(MXNetError):
        codec.quantize(np.ones((2, 2), np.float32), None)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_params_matches_jax(models, wparams, fmt):
    jm, tm = models
    jqm, tqm = jm.with_quant(fmt, "int8"), tm.with_quant(fmt, "int8")
    assert tqm._quant_weight_names() == jqm._quant_weight_names()
    jp = jqm.quantize_params(wparams)
    for src in (wparams, {k: torch.from_numpy(v)
                          for k, v in wparams.items()}):
        tp = tqm.quantize_params(src)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            assert np.array_equal(_bits(tp[k]), _bits(jp[k])), k
        assert tqm.quantize_params(tp) is tp   # idempotent
    # only the matmul weights quantize; the model itself stays a view
    assert tp["final_ln_gamma"].dtype == torch.float32
    assert "layer0_ln1_gamma_qscale" not in tp
    assert tm.quant is None and tm.quantize_params(wparams) is wparams
    # the engine's carry-over of an already quantized JAX dict
    carried = tqm.params_from_jax(jp, "cpu")
    for k in jp:
        assert np.array_equal(_bits(carried[k]), _bits(jp[k])), k


def test_gather_paged_scales_matches_jax():
    rng = np.random.RandomState(3)
    scales = rng.rand(9, BS).astype(np.float32)
    tables = rng.randint(0, 9, (3, 5)).astype(np.int32)
    got = gather_paged_scales(torch.from_numpy(scales),
                              torch.from_numpy(tables))
    assert np.array_equal(got.numpy(), np.asarray(jgather_scales(
        jnp.asarray(scales), jnp.asarray(tables))))


# -- the paged programs under quantization ------------------------------------

QMODES = [("int8", "int8"), ("int8", "0"), ("fp8", "0"), ("0", "int8"),
          ("fp8", "int8")]
QIDS = ["w8-kv8", "w8", "fp8", "kv8", "fp8-kv8"]


def _qmodels(models, params, quant, kv):
    """The JAX and port views of the geometry under ``quant`` / ``kv``,
    the JAX parameters quantized by the JAX model and the port's carried
    across from them."""
    jm, tm = models[0].with_quant(quant, kv), models[1].with_quant(quant, kv)
    jp = jm.quantize_params(params)
    return jm, tm, jp, tm.params_from_jax(jp, "cpu")


def _pool_close(tpool, jpool):
    """Pools equal past the trash block: f32 within the program bound; an
    int8 pool equal, its scales within 1e-5 relative."""
    if isinstance(jpool, tuple):
        assert isinstance(tpool, tuple)
        np.testing.assert_array_equal(tpool[0][:, :, 1:].numpy(),
                                      np.asarray(jpool[0])[:, :, 1:])
        np.testing.assert_allclose(tpool[1][:, :, 1:].numpy(),
                                   np.asarray(jpool[1])[:, :, 1:],
                                   rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(tpool[:, :, 1:].numpy(),
                                   np.asarray(jpool)[:, :, 1:],
                                   atol=PROGRAM_ATOL, rtol=0)


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=PROGRAM_ATOL,
                               rtol=0)


@pytest.mark.parametrize("quant,kv", QMODES, ids=QIDS)
def test_paged_programs_match_jax_under_quant(models, wparams, quant, kv):
    """A 2-row chunk prefill, a decode step, a 3-token verify, a 3-step
    megastep, a copy-on-write and a restore scatter, the port and the
    JAX programs from the same pool each time: logits within 2e-5, the
    pools as `_pool_close` holds them, the scales copied and scattered
    with their rows."""
    jm, tm, jp, tp = _qmodels(models, wparams, quant, kv)
    pj = {k: jnp.asarray(v) for k, v in jp.items()}
    assert isinstance(tm.init_block_pool(3, BS, "cpu"), tuple) == (kv != "0")
    rng = np.random.RandomState(5)
    tables = np.zeros((2, S // BS), np.int32)
    tables[0, :5] = [1, 2, 3, 4, 5]
    tables[1, :5] = [6, 7, 8, 9, 10]
    jpool = jm.init_block_pool(12, BS)
    tpool = tm.init_block_pool(12, BS, "cpu")

    def t(a):
        return torch.from_numpy(np.asarray(a))

    def j(a):
        return jnp.asarray(a)

    pre = (rng.randint(0, V, (2, 8)).astype(np.int32),
           np.zeros(2, np.int32), np.array([7, 8], np.int32), tables)
    jl, jpool = jax.jit(jm.prefill_paged)(pj, jpool, *map(j, pre))
    tl, tpool = tm.prefill_paged(tp, tpool, *map(t, pre))
    _logits_close(tl, jl)
    _pool_close(tpool, jpool)
    dec = (rng.randint(0, V, 2).astype(np.int32), np.array([7, 8], np.int32),
           tables)
    jl, jpool = jax.jit(jm.decode_paged)(pj, jpool, *map(j, dec))
    tl, tpool = tm.decode_paged(tp, tpool, *map(t, dec))
    _logits_close(tl, jl)
    _pool_close(tpool, jpool)
    ver = (rng.randint(0, V, (2, 3)).astype(np.int32),
           np.array([8, 9], np.int32), np.array([3, 2], np.int32), tables)
    jl, jpool = jax.jit(jm.verify_paged)(pj, jpool, *map(j, ver))
    tl, tpool = tm.verify_paged(tp, tpool, *map(t, ver))
    _logits_close(tl, jl)
    _pool_close(tpool, jpool)
    mega = (np.array([3, 4], np.int32), np.array([11, 11], np.int32),
            np.array([3, 2], np.int32), np.array([-1, -1], np.int32), tables)
    jgrid, jpool = jax.jit(
        lambda p, pool, *a: jm.decode_megastep(
            p, pool, *a, 3, lambda lg, np_: jnp.argmax(
                lg, axis=-1).astype(jnp.int32)))(pj, jpool, *map(j, mega))
    tgrid, tpool = tm.decode_megastep(
        tp, tpool, *map(t, mega), 3, lambda lg, np_: lg.argmax(dim=-1))
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    _pool_close(tpool, jpool)
    src, dst = np.array([2], np.int32), np.array([11], np.int32)
    jpool = jax.jit(jm.copy_block)(jpool, j(src), j(dst))
    tpool = tm.copy_block(tpool, t(src), t(dst))
    _pool_close(tpool, jpool)
    # the restore scatter: blocks 1 and 2 into 11 and the trash block
    dsts = np.array([11, 0], np.int32)
    data = tm.slice_block(tpool, torch.tensor([1, 2]))
    jdata = jm.slice_block(jpool, j(np.array([1, 2], np.int32)))
    tpool = tm.write_block(tpool, t(dsts), data)
    jpool = jax.jit(jm.write_block)(jpool, j(dsts), jdata)
    _pool_close(tpool, jpool)
    assert not tm.cache_lost(tpool)


def _jitted(jm):
    """A view of JAX model ``jm`` whose paged programs are jitted (the
    same functions, compiled once a shape instead of dispatched op by
    op)."""
    view = copy.copy(jm)
    view.prefill_paged = jax.jit(jm.prefill_paged)
    view.decode_paged = jax.jit(jm.decode_paged)
    return view


def test_parity_report_matches_jax(models, wparams):
    """`parity_report` of int8 weights and KV against the f32 oracle, in
    both packages: the same streams, the logit errors within 2e-5, the
    gauge set to ``logit_err_rel``, and the JAX gate met."""
    jm, tm, jp, tp = _qmodels(models, wparams, "int8", "int8")
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, V, size=int(rng.randint(3, 20))))
               for _ in range(4)]
    jrep = jparity_report(_jitted(models[0]), wparams, _jitted(jm), jp,
                          prompts, max_new=6, block_size=BS)
    trep = parity_report(models[1], models[1].params_from_jax(wparams,
                                                              "cpu"),
                         tm, tp, prompts, max_new=6, block_size=BS)
    assert trep["streams"] == jrep["streams"]
    assert trep["token_match_rate"] == jrep["token_match_rate"]
    for key in ("logit_err_max", "logit_err_rel"):
        assert abs(trep[key] - jrep[key]) <= PROGRAM_ATOL, (key, trep, jrep)
    assert trep["logit_err_rel"] <= 0.05 and trep["token_match_rate"] >= 0.75
    assert telemetry.registry().gauge("serve.quant_logit_err").value == \
        trep["logit_err_rel"]


# -- the engines ----------------------------------------------------------------


def _pair(models, params, **kw):
    """A port engine and a JAX engine of the same configuration, both
    warmed (the JAX one greedy-only: its sampler programs are not under
    test; its compiled programs shared by engines of one configuration)."""
    jm, tm = models
    kw.setdefault("max_batch", 2)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("block_size", BS)
    kw.setdefault("n_blocks", 33)
    teng = ServingEngine(tm, params, ctx="cpu", **kw)
    key = tuple(sorted((k, repr(v)) for k, v in kw.items()
                       if k not in ("name", "queue_max", "overload",
                                    "max_new_tokens", "host_blocks")))
    aot = _AOT.setdefault(key, AotCache("serve.aot"))
    jeng = JServingEngine(jm, params, sampling=False, aot=aot, **kw)
    jeng.warmup()
    teng.warmup()
    return teng, jeng


def same_stats(teng, jeng):
    reg = jtelemetry.registry()
    for key, got in teng.stats.items():
        if key in CLOCKS:
            continue
        want = reg.counter("serve.%s.%s" % (jeng.name, key)).value \
            if key in TELEMETRY else jeng.stats[key]
        assert got == want, (key, got, want)
    assert set(jeng.stats) - set(teng.stats) <= set(JAX_ONLY)


_PROGRAMS = {}


def qmargins(jeng, reqs):
    """Top-1 minus top-2 logit at every generated position, teacher-forced
    through the JAX engine's own (quantized) paged programs: the prompt
    in one chunk, then a decode step per generated token; also checks
    each greedy token is that argmax."""
    jm = jeng.model
    key = (repr(jm.quant), repr(jm.kv_quant))
    if key not in _PROGRAMS:
        _PROGRAMS[key] = (jax.jit(jm.prefill_paged),
                          jax.jit(jm.decode_paged))
    pre, dec = _PROGRAMS[key]
    pj = jeng._params
    n_table = S // BS
    table = jnp.asarray(np.arange(1, n_table + 1, dtype=np.int32)[None])
    out = []
    for prompt, gen in reqs:
        pool = jm.init_block_pool(n_table + 1, BS)
        c = 16 * -(-len(prompt) // 16)
        toks = np.zeros((1, c), np.int32)
        toks[0, :len(prompt)] = prompt
        logits, pool = pre(pj, pool, jnp.asarray(toks),
                           jnp.zeros((1,), jnp.int32),
                           jnp.asarray([len(prompt)], jnp.int32), table)
        rows = [np.asarray(logits)[0]]
        for j, tok in enumerate(gen[:-1]):
            logits, pool = dec(pj, pool, jnp.asarray([tok], jnp.int32),
                               jnp.asarray([len(prompt) + j], jnp.int32),
                               table)
            rows.append(np.asarray(logits)[0])
        rows = np.stack(rows)
        assert rows.argmax(axis=-1).tolist() == list(gen)
        top = np.sort(rows, axis=-1)
        out.append(top[:, -1] - top[:, -2])
    return np.concatenate(out)


def run_both(teng, jeng, drive, errors=None):
    """Run ``drive(engine) -> [requests]`` on the JAX engine, then on the
    port's: the same requests fail with the same error types (``errors``
    maps the JAX type to the port's), the others give the same tokens
    (each position's margin over 1e-3), `stats` agree and nothing
    leaks.  Returns (port results, JAX results)."""
    out = []
    for eng in (jeng, teng):
        reqs = drive(eng)
        eng.run_until_idle(timeout=120)
        res = []
        for r in reqs:
            try:
                res.append(r.result(1))
            except Exception as e:  # noqa: BLE001 -- compared by type
                res.append(type(e))
        out.append((reqs, res))
    (jreqs, jres), (treqs, tres) = out
    errors = errors or {}
    ok = [(r.prompt, t) for r, t in zip(jreqs, jres) if isinstance(t, list)]
    if ok:
        assert qmargins(jeng, ok).min() > MARGIN
    assert [t if isinstance(t, list) else errors.get(t, t)
            for t in jres] == tres
    same_stats(teng, jeng)
    assert teng.leaked_blocks() == 0 and jeng.leaked_blocks() == 0
    return tres, jres


def _prompts(n=4, seed=3, lo=3, hi=20):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, V, size=int(rng.randint(lo, hi))))
            for _ in range(n)]


def _submit_all(prompts, max_new=6, **kw):
    def drive(eng):
        return [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    return drive


@pytest.mark.parametrize("quant,kv", QMODES[:4], ids=QIDS[:4])
def test_engine_matches_jax_under_quant(models, wparams, quant, kv):
    """Mixed-length traffic (a prompt past one prefill bucket included)
    through both engines."""
    teng, jeng = _pair(models, wparams, quant=quant, kv_quant=kv)
    assert isinstance(teng._cache, tuple) == isinstance(jeng._cache, tuple)
    assert teng.warmup()["quant"] == jeng.warmup()["quant"]
    run_both(teng, jeng, _submit_all(_prompts(5) + [_prompts(1, 9, 20,
                                                             30)[0]]))


def test_prefix_and_cow_carry_the_scales(models, wparams):
    """A shared prompt twice under int8 weights and KV: the second
    bootstraps over the cached blocks and copies the block it writes, in
    both engines alike."""
    teng, jeng = _pair(models, wparams, quant="int8")
    shared = list(np.random.RandomState(11).randint(0, V, size=3 * BS))
    for _ in range(2):
        run_both(teng, jeng, _submit_all([shared], max_new=5))
    assert teng.stats["prefix_bootstraps"] >= 1
    assert teng.stats["cow_copies"] >= 1


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_speculation_under_quant_matches_jax(models, wparams, drafter):
    """Speculation over int8 weights and KV: a template served twice (the
    second drafts off the first), the model drafter's pool the int8 pair
    as the target's."""
    teng, jeng = _pair(models, wparams, quant="int8", spec=True, spec_k=3,
                       spec_drafter=drafter, max_new_tokens=8)
    if drafter == "model":
        assert isinstance(teng._drafter._pool, tuple)
        assert teng._drafter.model.kv_quant == codec.resolve("int8")
    tmpl = list(np.random.RandomState(12).randint(0, V, size=8))
    for _ in range(2):
        run_both(teng, jeng, _submit_all([tmpl], max_new=8))
    assert teng.stats["spec_accepted"] > 0


def test_scale_corrupt_fails_the_same_requests_typed(models, wparams,
                                                      monkeypatch):
    """``scale_corrupt:1`` (every step NaNs a held block's scales): the
    same requests end in `ServeQuantError` in both engines, the rest
    with the same tokens, and the trip and corruption counts agree."""
    monkeypatch.setenv("MXNET_CHAOS", "scale_corrupt:1")
    teng, jeng = _pair(models, wparams, quant="int8")
    tres, _ = run_both(teng, jeng,
                       _submit_all(_prompts(3, seed=15), max_new=4),
                       errors={JServeQuantError: ServeQuantError})
    assert ServeQuantError in tres
    assert teng.stats["quant_trips"] > 0 and teng.stats["scale_corrupts"] > 0
    for r in tres:
        assert r is ServeQuantError or all(t >= 0 for t in r)


def test_scale_corrupt_scrubs_the_prefix(models, wparams, monkeypatch):
    """After a trip the tripped row's blocks leave the prefix index in
    both engines: a fresh lookup of the prompt misses."""
    teng, jeng = _pair(models, wparams, quant="int8")
    shared = list(np.random.RandomState(17).randint(0, V, size=3 * BS))
    run_both(teng, jeng, _submit_all([shared], max_new=4))
    assert teng._prefix.cached_blocks > 0
    monkeypatch.setenv("MXNET_CHAOS", "scale_corrupt:1")
    run_both(teng, jeng, _submit_all([shared], max_new=4),
             errors={JServeQuantError: ServeQuantError})
    assert teng._prefix.lookup(shared) == [] == jeng._prefix.lookup(shared)


def test_scale_corrupt_is_a_noop_without_kv_quant(models, wparams,
                                                  monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS", "scale_corrupt:1")
    teng, jeng = _pair(models, wparams, quant="0")
    tres, _ = run_both(teng, jeng, _submit_all(_prompts(2, seed=16),
                                               max_new=4))
    assert all(len(t) == 4 for t in tres)
    assert teng.stats["scale_corrupts"] == 0 == teng.stats["quant_trips"]


def test_tier_spills_int8_pairs(models, wparams):
    """Int8 KV through the host tier: the spilled blocks are the pool's
    (int8 rows, f32 scales) pairs, under half the bytes of f32 blocks,
    and the restore gives the same tokens and counts in both engines."""
    teng, jeng = _pair(models, wparams, quant="int8", tier=True,
                       host_blocks=32, n_blocks=9)
    p = list(np.random.RandomState(14).randint(0, V, size=3 * BS))
    run_both(teng, jeng, _submit_all([p], max_new=4))
    for eng in (teng, jeng):
        eng._alloc.reclaim(eng._prefix.evict(eng._alloc.capacity))
    assert teng.stats["spilled"] == jeng.stats["spilled"] > 0
    per_block = teng._tier.bytes / teng._tier.used
    assert per_block == jeng._tier.bytes / jeng._tier.used
    assert per_block <= 0.5 * L * 2 * BS * E * 4
    run_both(teng, jeng, _submit_all([p], max_new=4))
    assert teng.stats["restored"] > 0
    assert teng.leaked_host_blocks() == 0 == jeng.leaked_host_blocks()


def test_stale_nan_scales_in_free_blocks_are_harmless(models, wparams):
    """Every free block's scales NaN (as if corrupted victims had cycled
    the whole pool): rows a sequence never wrote are masked out, so the
    tokens are the clean engine's and the gate never trips."""
    teng, _ = _pair(models, wparams, quant="int8")
    clean = [teng.submit(p, max_new_tokens=6) for p in _prompts(2, seed=20)]
    teng.run_until_idle(timeout=60)
    teng2 = ServingEngine(models[1], wparams, ctx="cpu", max_batch=2,
                          prefill_buckets=[8, 16], block_size=BS,
                          n_blocks=33, quant="int8")
    teng2._cache[1].fill_(float("nan"))
    got = [teng2.submit(p, max_new_tokens=6) for p in _prompts(2, seed=20)]
    teng2.run_until_idle(timeout=60)
    assert [r.result(1) for r in got] == [r.result(1) for r in clean]
    assert teng2.stats["quant_trips"] == 0 and teng2.leaked_blocks() == 0


def test_quant_settings_and_kill_switch(models, wparams, monkeypatch):
    """Weight-only quant keeps a plain pool; an explicit int8 KV needs the
    paged cache, while the implicit one steps aside for a slot cache;
    ``MXNET_SERVE_QUANT=0`` builds no gate, scales or pair."""
    tm = models[1]
    kw = dict(ctx="cpu", max_batch=2, prefill_buckets=[8, 16])
    eng = ServingEngine(tm, wparams, quant="int8", kv_quant="0", **kw)
    assert not isinstance(eng._cache, tuple) and eng._quant_gate
    with pytest.raises(MXNetError, match="paged"):
        ServingEngine(tm, wparams, paged=False, quant="int8",
                      kv_quant="int8", **kw)
    eng = ServingEngine(tm, wparams, paged=False, quant="int8", **kw)
    assert eng._quant is not None and eng._kv_quant is None
    monkeypatch.setenv("MXNET_SERVE_QUANT", "0")
    eng = ServingEngine(tm, wparams, **kw)
    assert eng._quant is None and eng._kv_quant is None
    assert not eng._quant_gate and eng.warmup()["quant"] is None
    assert not isinstance(eng._cache, tuple)
    assert not any(k.endswith("_qscale") for k in eng._params)
    monkeypatch.setenv("MXNET_SERVE_QUANT", "fp8")
    eng = ServingEngine(tm, wparams, **kw)
    assert eng.warmup()["quant"] == {"weights": "fp8", "kv": "int8"}
    assert eng._params["pred_weight"].dtype == torch.float8_e4m3fn
