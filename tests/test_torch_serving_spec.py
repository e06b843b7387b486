"""The port's speculative decoding against the JAX package's, on the CPU.

The counterparts of `tests/test_serve_spec.py`, at its size (V, S, L, H,
E = 61, 32, 2, 2, 32) with the weights of
`tests/test_torch_serving_prefix.py` (seed 7, scale 0.5):

* `verify_attention` against `chunk_attention` at full length and
  against the JAX `verify_attention` with a masked tail, the
  `DecodeAttention` op against the JAX op, and
  `TransformerKVModel.verify_paged` against the JAX one on the same pool
  and tables (logits and pool) and against sequential `decode_paged`:
  each within 1e-5 absolute plus 1e-5 relative in float32;
* the engine with either drafter: its tokens equal the port's plain
  engine's bit for bit and the JAX engine's (greedy where every
  position's top-1/top-2 margin exceeds 1e-3, sampled under the same
  seeds), accept counts the same in two runs, then the scenarios of the
  JAX file but its zero-retrace one (the port compiles nothing):
  batch-composition invariance, the generation store, preemption
  mid-speculation, the rewind of a shared tail, the kill switch and the
  pins, the refusals, respawn, ``draft_junk`` (its draws the JAX
  package's), ``block_exhaust`` and ``prefix_evict``, a failing draft,
  the n-gram lookup and its cap, a vocabulary mismatch.

The JAX engine is built once, in a module fixture; the port runs with
``ctx="cpu"``, the kernels' plain versions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import chaos as jchaos
from mxnet_tpu.executor import AotCache
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.attention import verify_attention as jverify_attention
from mxnet_tpu.serving import NgramDrafter as JNgramDrafter
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.attention import chunk_attention, verify_attention
from mxnet_tpu_torch.ops.pallas_kernels._build import KernelBuildError
from mxnet_tpu_torch.serving import (TRASH_BLOCK, ServingEngine,
                                     TransformerKVModel)
from mxnet_tpu_torch.serving.spec import (ModelDrafter, NgramDrafter,
                                          make_drafter)

from test_torch_serving_moe import verify_tapes
from test_torch_serving_prefix import margins, models, wparams  # noqa: F401
from test_torch_kernels import _one_thread  # noqa: F401

V, S, L, H, E = 61, 32, 2, 2, 32
TOL = 1e-5
KW = dict(max_batch=4, decode_buckets=[4], prefill_buckets=[16],
          max_new_tokens=8)
SAMPLED = [(0.9, 8, 1.0, 11), (0.0, 0, 1.0, 5), (1.2, 0, 0.9, 3),
           (0.7, 5, 0.8, 9)]
# the JAX function compiled once per shape (eagerly, every primitive
# compiles on its own)
jverify = jax.jit(jverify_attention, static_argnums=5)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for pin in ("MXNET_CHAOS", "MXNET_SERVE_SPEC", "MXNET_SERVE_SPEC_K",
                "MXNET_SERVE_SPEC_DRAFTER", "MXNET_SERVE_MEGASTEP"):
        monkeypatch.delenv(pin, raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    telemetry.reset()
    chaos.reset()
    yield
    telemetry.reset()
    chaos.reset()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _prompts(seed=0, sizes=(3, 9, 14, 6)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=n).tolist() for n in sizes]


def _engine(models, params, **kw):
    return ServingEngine(models[1], params, ctx="cpu", **dict(KW, **kw))


def _spec(models, params, drafter="ngram", **kw):
    kw.setdefault("spec_k", 3)
    return _engine(models, params, spec=True, spec_drafter=drafter, **kw)


def _run(eng, reqs_kw, warm=True):
    if warm:
        eng.warmup()
    reqs = [eng.submit(**kw) for kw in reqs_kw]
    eng.run_until_idle(timeout=120)
    return [r.result(1) for r in reqs]


@pytest.fixture(scope="module")
def jax_run(models, wparams):
    """The JAX engine (built once, sampling on) serving a list of request
    keyword dicts to the end: its tokens."""
    jm = models[0]
    probe = ServingEngine(models[1], wparams, ctx="cpu", **KW)
    eng = JServingEngine(jm, wparams, aot=AotCache("serve.aot"), **KW)
    assert (eng.n_blocks, eng.block_size) == (probe.n_blocks,
                                              probe.block_size)
    eng.warmup()

    def run(reqs_kw):
        reqs = [eng.submit(**kw) for kw in reqs_kw]
        eng.run_until_idle(timeout=120)
        return [r.result(1) for r in reqs]
    return run


def _greedy_vs_jax(models, params, jax_run, reqs_kw, got):
    want = jax_run(reqs_kw)
    m = margins(models[0], params, [(kw["prompt"], t)
                                    for kw, t in zip(reqs_kw, want)])
    assert m.min() > 1e-3, m.min()
    assert got == want


# -- the verify numerics -------------------------------------------------------


def test_verify_attention_full_length_matches_chunk_attention():
    rng = np.random.RandomState(0)
    b, c, s = 3, 4, 16
    q, k, v = (rng.randn(b, n, E).astype(np.float32) for n in (c, s, s))
    start = np.array([0, 3, 9], np.int32)
    full = np.full((b,), c, np.int32)
    out = verify_attention(*(torch.from_numpy(a) for a in (q, k, v, start,
                                                           full)), H)
    ref = chunk_attention(*(torch.from_numpy(a) for a in (q, k, v, start)),
                          H)
    _close(out, ref, 1e-6)
    _close(out, jverify(*(jnp.asarray(a) for a in (q, k, v, start, full)),
                        H))


def test_verify_attention_masks_the_chunk_tail_like_jax():
    """Garbage in the chunk rows past ``length`` changes no real query's
    output; padded queries stay finite; every output is the JAX one's."""
    rng = np.random.RandomState(1)
    b, c, s = 2, 4, 12
    start = np.array([2, 5], np.int32)
    length = np.array([2, 3], np.int32)
    q, k, v = (rng.randn(b, n, E).astype(np.float32) for n in (c, s, s))
    k2, v2 = k.copy(), v.copy()
    for r in range(b):
        k2[r, start[r] + length[r]:start[r] + c] = 1e3
        v2[r, start[r] + length[r]:start[r] + c] = -1e3
    outs = []
    for kk, vv in ((k, v), (k2, v2)):
        got = verify_attention(*(torch.from_numpy(a) for a in (
            q, kk, vv, start, length)), H)
        _close(got, jverify(*(jnp.asarray(a) for a in (
            q, kk, vv, start, length)), H))
        outs.append(got.numpy())
    for r in range(b):
        _close(outs[1][r, :length[r]], outs[0][r, :length[r]])
    assert np.isfinite(outs[1]).all()


def test_decode_attention_op_matches_jax():
    """The registry's `DecodeAttention`: shapes inferred and refused as
    the JAX op's, and its forward within 1e-5 of it."""
    rng = np.random.RandomState(2)
    q = rng.randn(3, E).astype(np.float32)
    kc, vc = (rng.randn(3, 10, E).astype(np.float32) for _ in range(2))
    pos = np.array([0, 4, 9], np.int32)
    outs = {}
    for reg, put in ((treg, torch.from_numpy), (jreg, jnp.asarray)):
        op = reg.get("DecodeAttention")
        params = op.parse_params({"num_heads": H})
        assert op.list_arguments(params) == ["query", "key_cache",
                                             "value_cache", "pos"]
        assert op.infer_shape(params, [(3, E), None, (3, 10, E), None]) == (
            [(3, E), (3, 10, E), (3, 10, E), (3,)], [(3, E)], [])
        with pytest.raises(Exception, match="rank 3"):
            op.infer_shape(params, [(3, E), (3, E), None, None])

        def forward(*a, op=op, params=params):
            return op.apply(None, params, list(a), [])[0][0]
        if reg is jreg:
            forward = jax.jit(forward)
        outs[reg] = np.asarray(forward(*(put(a) for a in (q, kc, vc, pos))))
    _close(outs[treg], outs[jreg])
    with pytest.raises(MXNetError, match="num_heads"):
        treg.get("DecodeAttention").parse_params({})


def _pool_and_tables(models, params, prompt):
    """A prompt prefilled by the port into 4-row blocks 1..4, in one chunk
    of 8; the JAX pool is a copy of it, so the two verifies start from
    the same cache."""
    tm = models[1]
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tm.params_from_jax(params, "cpu")
    tables = np.array([[1, 2, 3, 4] + [TRASH_BLOCK] * 4], np.int32)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :len(prompt)] = prompt
    args = (toks, np.zeros(1, np.int32), np.array([len(prompt)], np.int32),
            tables)
    _, tpool = tm.prefill_paged(tp, tm.init_block_pool(9, 4, "cpu"),
                                *(torch.from_numpy(a) for a in args))
    return pj, tp, jnp.asarray(tpool.numpy()), tpool, tables


def test_verify_paged_matches_jax_and_sequential_decode(models, wparams):
    """One verify of a 4-token span at position 6 (crossing a block
    boundary), beside a row clipped to 2 real tokens, on the same pool:
    logits and the pool's real blocks within 1e-5 of the JAX
    `verify_paged`; the full row's logits within 1e-5 of four sequential
    `decode_paged` steps."""
    jm, tm = models
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, V, size=6).tolist()
    fed = rng.randint(0, V, size=(2, 4)).astype(np.int32)
    pj, tp, jpool, tpool, tables = _pool_and_tables(models, wparams, prompt)
    # the second row's blocks hold no prompt: a row of its own
    tables = np.concatenate([tables, tables])
    tables[1, :4] = [5, 6, 7, 8]
    seq_pool = tpool.clone()
    pos = np.array([6, 6], np.int32)
    length = np.array([4, 2], np.int32)
    args = (fed, pos, length, tables)
    jl, jpool = jax.jit(jm.verify_paged)(pj, jpool,
                                         *(jnp.asarray(a) for a in args))
    tl, tpool = tm.verify_paged(tp, tpool,
                                *(torch.from_numpy(a) for a in args))
    _close(tl, jl)
    _close(tpool[:, :, 1:], np.asarray(jpool)[:, :, 1:])
    for j in range(4):
        lg, seq_pool = tm.decode_paged(
            tp, seq_pool, torch.tensor([int(fed[0, j])]),
            torch.tensor([6 + j]), torch.from_numpy(tables[:1]))
        _close(tl[0, j], lg[0])
    assert not tm.cache_lost(tpool)
    # MoE is ported: a verify's tape is a count a layer, the JAX one's
    jt, tt = verify_tapes()
    assert len(tt) == len(jt) == L
    assert [a.tolist() for a in tt] == [np.asarray(a).tolist() for a in jt]


# -- parity, determinism, batch composition -------------------------------------


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_token_parity_t0(models, wparams, jax_run, drafter):
    reqs_kw = [dict(prompt=p, max_new_tokens=8) for p in _prompts()]
    base = _run(_engine(models, wparams), reqs_kw)
    eng = _spec(models, wparams, drafter)
    outs = _run(eng, reqs_kw)
    assert outs == base
    _greedy_vs_jax(models, wparams, jax_run, reqs_kw, outs)
    assert eng.leaked_blocks() == 0
    st = eng.stats
    assert st["verify_steps"] > 0 or st["decode_steps"] > 0
    if drafter == "model":
        d = eng._drafter
        # every round k+1 draft steps; the warmup's one round a bucket and
        # one prefill a bucket; one draft prefill per target chunk
        assert d.launches > 0
        assert d.steps == (st["verify_steps"] + 1) * (eng._spec_k + 1)
        assert d.prefill_chunks == st["prefill_chunks"] + 1
        assert st["spec_accepted"] >= 0.9 * st["spec_proposed"]


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_sampled_parity_and_deterministic_accept(models, wparams,
                                                      jax_run, drafter):
    reqs_kw = [dict(prompt=p, max_new_tokens=8, temperature=t, top_k=tk,
                    top_p=tp, seed=s)
               for p, (t, tk, tp, s) in zip(_prompts(1), SAMPLED)]
    base = _run(_engine(models, wparams), reqs_kw)
    assert base == jax_run(reqs_kw)
    accepts = []
    for _ in range(2):
        eng = _spec(models, wparams, drafter)
        assert _run(eng, reqs_kw) == base
        assert eng.leaked_blocks() == 0
        accepts.append((eng.stats["spec_accepted"],
                        eng.stats["spec_proposed"]))
    assert accepts[0] == accepts[1]


def test_spec_batch_composition_invariance(models, wparams):
    prompts = _prompts(2, sizes=(4, 11, 7, 16, 5))
    kws = [dict(prompt=p, max_new_tokens=6,
                temperature=(0.8 if i % 2 else 0.0), seed=100 + i)
           for i, p in enumerate(prompts)]
    solo = []
    for kw in kws:
        solo.extend(_run(_spec(models, wparams), [kw]))
    eng = _spec(models, wparams)
    eng.warmup()
    reqs = [eng.submit(**kw) for kw in kws[:3]]
    for _ in range(2):
        eng.step()
    reqs += [eng.submit(**kw) for kw in kws[3:]]
    eng.run_until_idle(timeout=120)
    assert [r.result(1) for r in reqs] == solo
    assert eng.leaked_blocks() == 0


def test_spec_repeat_requests_accept_from_generation_store(models, wparams):
    eng = _spec(models, wparams)
    prompt = _prompts(4, sizes=(8,))[0]
    first = _run(eng, [dict(prompt=prompt, max_new_tokens=8)])
    s0 = (eng.stats["spec_accepted"], eng.stats["verify_steps"])
    assert _run(eng, [dict(prompt=prompt, max_new_tokens=8)]) == first
    # the repeat drafts off the finished stream
    assert eng.stats["spec_accepted"] - s0[0] >= 5
    assert eng.stats["verify_steps"] - s0[1] <= 4


# -- preemption and the rewind --------------------------------------------------


def test_spec_preemption_mid_speculation(models, wparams, jax_run):
    kw = dict(block_size=4, n_blocks=17)   # growth preempts
    reqs_kw = [dict(prompt=p, max_new_tokens=10)
               for p in _prompts(5, sizes=(9, 12, 7, 10))]
    base = _run(_engine(models, wparams, **kw), reqs_kw)
    eng = _spec(models, wparams, "model", **kw)
    outs = _run(eng, reqs_kw)
    assert outs == base
    _greedy_vs_jax(models, wparams, jax_run, reqs_kw, outs)
    assert eng.stats["preemptions"] > 0
    assert eng.leaked_blocks() == 0


def test_rewind_drops_exactly_one_ref_on_shared_tail(models, wparams):
    """A speculative tail block another request holds and the prefix
    index registered rewinds through `_drop_refs`: this row's one
    reference goes, the block is neither freed nor taken from the other
    holder."""
    eng = _spec(models, wparams, block_size=4)
    eng.warmup()
    req = eng.submit(list(range(1, 9)), max_new_tokens=6)
    eng.step()
    row, seq = next(iter(eng._active.items()))
    tail = eng._alloc.alloc(1)[0]
    seq.blocks.append(tail)
    eng._alloc.acquire([tail])          # the other request's reference
    eng._prefix._by_block[tail] = object()
    assert eng._alloc.refcount(tail) == 2
    eng._rewind_blocks(seq)
    assert tail not in seq.blocks
    assert eng._alloc.refcount(tail) == 1
    assert tail not in eng._alloc._free_set
    assert eng.stats["spec_rollbacks"] >= 1
    assert telemetry.registry().counter("serve.spec.rollbacks").value >= 1
    eng._prefix._by_block.pop(tail, None)
    eng._drop_refs([tail])
    req.cancel()
    eng.run_until_idle(timeout=60)
    assert eng.leaked_blocks() == 0


# -- the kill switch, the pins, the refusals, respawn ---------------------------


def test_spec_kill_switch_restores_plain_decode(models, wparams):
    reqs_kw = [dict(prompt=p, max_new_tokens=8) for p in _prompts(7)]
    off = _engine(models, wparams, spec=False)
    outs = _run(off, reqs_kw)
    assert off._drafter is None and off.warmup()["spec"] is None
    assert off.stats["verify_steps"] == off.stats["spec_proposed"] == 0
    assert _run(_spec(models, wparams), reqs_kw) == outs


@pytest.mark.parametrize("env,want", [
    ({}, (False, 4, None)),
    ({"MXNET_SERVE_SPEC": "1"}, (True, 4, "ngram")),
    ({"MXNET_SERVE_SPEC": "1", "MXNET_SERVE_SPEC_K": "2",
      "MXNET_SERVE_SPEC_DRAFTER": "model"}, (True, 2, "model"))])
def test_spec_pins_read_from_the_environment(models, wparams, monkeypatch,
                                             env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = _engine(models, wparams)
    got = (eng._spec, eng._spec_k,
           None if eng._drafter is None else eng._drafter.name)
    assert got == want
    if eng._spec:
        assert eng.warmup()["spec"] == {"k": want[1], "drafter": want[2]}


def test_spec_refusals(models, wparams):
    with pytest.raises(MXNetError, match="paged"):
        _engine(models, wparams, paged=False, spec=True)
    with pytest.raises(MXNetError, match="SPEC_K"):
        _spec(models, wparams, spec_k=0)
    with pytest.raises(MXNetError, match="unknown drafter"):
        _spec(models, wparams, drafter="oracle")


def test_spec_respawn_carries_config(models, wparams):
    eng = _spec(models, wparams, "model")
    eng.warmup()
    fresh = eng.respawn()
    assert fresh._spec and fresh._spec_k == eng._spec_k
    assert fresh._drafter.name == "model" and fresh._drafter is not \
        eng._drafter
    outs = _run(fresh, [dict(prompt=_prompts(8, sizes=(6,))[0],
                             max_new_tokens=6)])
    assert len(outs[0]) == 6 and fresh._drafter.launches > 0


# -- chaos and a failing draft --------------------------------------------------


def test_chaos_draft_junk_parity_at_lower_accept(models, wparams,
                                                 monkeypatch):
    reqs_kw = [dict(prompt=p, max_new_tokens=8) for p in _prompts(9)]
    base = _run(_engine(models, wparams), reqs_kw)
    monkeypatch.setenv("MXNET_CHAOS", "draft_junk:1.0")
    chaos.reset()
    eng = _spec(models, wparams, "model")
    assert _run(eng, reqs_kw) == base
    assert eng.stats["spec_junk_rounds"] > 0
    assert eng.stats["spec_accepted"] <= eng.stats["spec_proposed"] // 4
    assert telemetry.registry().counter(
        "serve.chaos_draft_junk").value == eng.stats["spec_junk_rounds"]
    assert eng.leaked_blocks() == 0


def test_draft_junk_draws_the_jax_stream(monkeypatch):
    """One spec and seed draw the same ``draft_junk`` rounds in both
    packages, whatever other clause the spec holds."""
    draws = []
    for spec in ("draft_junk:0.5", "launch_error:0.3,draft_junk:0.5"):
        monkeypatch.setenv("MXNET_CHAOS", spec)
        for mod in (chaos, jchaos):
            mod.reset()
            draws.append([mod.serve_draft_junk() for _ in range(64)])
    assert draws[0] == draws[1] == draws[2] == draws[3]
    assert 16 < sum(draws[0]) < 48
    jchaos.reset()


def test_chaos_block_exhaust_and_prefix_evict_with_spec(models, wparams,
                                                        monkeypatch):
    reqs_kw = [dict(prompt=p, max_new_tokens=8) for p in _prompts(10)]
    base = _run(_engine(models, wparams), reqs_kw)
    monkeypatch.setenv("MXNET_CHAOS",
                       "block_exhaust:0.15,prefix_evict:0.2,draft_junk:0.3")
    chaos.reset()
    eng = _spec(models, wparams)
    assert _run(eng, reqs_kw) == base
    assert eng.leaked_blocks() == 0


def test_model_drafter_failure_degrades_never_corrupts(models, wparams,
                                                       monkeypatch):
    """A draft launch that raises after writing the draft pool costs the
    accept rate: the tokens stay, the pool is rebuilt, the failure is
    counted in ``serve.draft_degraded``."""
    reqs_kw = [dict(prompt=p, max_new_tokens=8) for p in _prompts(11)]
    base = _run(_engine(models, wparams), reqs_kw)
    eng = _spec(models, wparams, "model")
    eng.warmup()
    d = eng._drafter
    before = d._pool

    def boom(*a):
        d.model._mark(d._pool)
        raise RuntimeError("draft device hiccup")

    monkeypatch.setattr(d, "_draft", boom)
    assert _run(eng, reqs_kw, warm=False) == base
    assert telemetry.registry().counter("serve.draft_degraded").value > 0
    assert d._pool is not before and not d._pool_lost()
    # the junk (the last token repeated) is accepted only by coincidence
    assert eng.stats["spec_accepted"] <= eng.stats["spec_proposed"] // 4
    assert eng.leaked_blocks() == 0


@pytest.mark.parametrize("exc", [
    chaos.ChaosEngineCrash("chaos: engine_crash killed replica replica0"),
    KernelBuildError("nvcc failed for ['layer_norm']"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_model_drafter_escalates_what_is_not_a_draft_fault(
        models, wparams, monkeypatch, exc):
    """A dead device and a kernel that did not build are not absorbed
    as junk proposals: the scheduler sees them."""
    eng = _spec(models, wparams, "model")
    eng.warmup()

    def boom(*a):
        raise exc

    monkeypatch.setattr(eng._drafter, "_draft", boom)
    eng.submit(_prompts(12, sizes=(5,))[0])
    with pytest.raises(type(exc)):
        eng.run_until_idle(timeout=60)
    assert telemetry.registry().counter("serve.draft_degraded").value == 0


# -- the drafters ---------------------------------------------------------------


def test_ngram_drafter_lookup_and_confidence_match_jax():
    port, ref = NgramDrafter(max_n=3, min_n=1), JNgramDrafter(max_n=3,
                                                              min_n=1)
    cases = [[1, 5, 6, 7, 2, 5, 6], [1, 2, 3, 4, 5], [9, 9, 3, 4, 5],
             [9, 9, 5]]
    want = [([7, 2, 5], True), ([5, 5, 5], False), ([6, 7, 8], True),
            ([6, 7, 8], False)]
    for i, hist in enumerate(cases):
        if i == 2:
            for d in (port, ref):
                d.on_retire([1, 2, 3, 4, 5, 6, 7, 8])
        got = port._lookup(hist, 3)
        assert (list(got[0]), got[1]) == want[i]
        assert got == ref._lookup(hist, 3)
    port.observe([4, 4, 2, 9, 1], 2)
    ref.observe([4, 4, 2, 9, 1], 2)
    assert port._store == ref._store


def test_ngram_store_cap_bounds_memory():
    d = NgramDrafter(max_n=2, min_n=1, store_cap=8)
    for i in range(20):
        d.on_retire([i, i + 1, i + 2, i + 3])
    assert len(d._store) <= 8
    with pytest.raises(MXNetError, match="max_n"):
        NgramDrafter(max_n=1, min_n=2)
    assert make_drafter(d) is d


def test_model_drafter_rejects_vocab_mismatch(models, wparams):
    other = TransformerKVModel(V + 1, S, num_layers=1, num_heads=H,
                               num_embed=E)
    with pytest.raises(MXNetError, match="vocab"):
        _spec(models, wparams, ModelDrafter(other, other.init_params()))
