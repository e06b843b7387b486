"""The port's megastep decode and token streaming against the JAX
package's, on the CPU.

The counterparts of `tests/test_serve_megastep.py`, at its size (V, S,
L, H, E = 61, 32, 2, 2, 32) with the weights of
`tests/test_torch_serving_prefix.py` (seed 7, scale 0.5):

* `TransformerKVModel.decode_megastep` against the JAX one on the same
  pool and tables at m 2 and 4 (greedy) and 4 (sampled, each package's
  sampler), with a row that hits its EOS mid-run, one that runs out of
  budget, and a padding row: the token grids equal, the pool's real
  blocks within 1e-5 absolute plus relative in float32;
* the engine: tokens equal the port's single-step engine's bit for bit
  and the JAX engine's (greedy where every position's top-1/top-2 margin
  exceeds 1e-3, sampled under the same seeds) across the budget, EOS and
  cache-depth edges; speculation with megastep (the megastep as the
  round without a real draft), the kill switch and the pins, the
  refusals, respawn, the accounting, then `stream()` and ``on_token``:
  order, a live consumer, a broken callback, the per-wait timeout, the
  typed error, a `ReplicaRouter` crash mid-stream that neither repeats
  nor skips a token, and chaos's ``block_exhaust`` and ``prefix_evict``.

The JAX engine is built once, in a module fixture.  The JAX test of
zero retraces has no counterpart (the port compiles nothing); its
accounting half does.  The port runs with ``ctx="cpu"``, the kernels'
plain versions.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.executor import AotCache
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu.serving.sampling import sample_tokens as jsample_tokens
from mxnet_tpu_torch import chaos, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (ReplicaRouter, ServeCancelled,
                                     ServeTimeout, ServingEngine)
from mxnet_tpu_torch.serving.sampling import argmax, sample_tokens

from test_torch_serving_prefix import margins, models, wparams  # noqa: F401

V, S, L, H, E = 61, 32, 2, 2, 32
TOL = 1e-5
KW = dict(max_batch=4, decode_buckets=[4], prefill_buckets=[16],
          max_new_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The engines run many tiny torch ops: one intra-op thread keeps
    them off the OpenMP team, whose spinning costs most when the suite's
    workers share the machine.  Restored for the worker's next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for pin in ("MXNET_CHAOS", "MXNET_SERVE_MEGASTEP",
                "MXNET_SERVE_MEGASTEP_STEPS", "MXNET_SERVE_SPEC"):
        monkeypatch.delenv(pin, raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    telemetry.reset()
    chaos.reset()
    yield
    telemetry.reset()
    chaos.reset()


def _prompts(seed=0, sizes=(3, 9, 14, 6)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=n).tolist() for n in sizes]


def _engine(models, params, **kw):
    return ServingEngine(models[1], params, ctx="cpu", **dict(KW, **kw))


def _mega(models, params, m=4, **kw):
    return _engine(models, params, megastep=True, megastep_steps=m, **kw)


def _run(eng, reqs_kw):
    eng.warmup()
    reqs = [eng.submit(**kw) for kw in reqs_kw]
    eng.run_until_idle(timeout=120)
    return [r.result(1) for r in reqs]


@pytest.fixture(scope="module")
def jax_run(models, wparams):
    """The JAX engine (built once, sampling on, up to 40 new tokens)
    serving request keyword dicts to the end: its tokens."""
    eng = JServingEngine(models[0], wparams, aot=AotCache("serve.aot"),
                         **dict(KW, max_new_tokens=40))
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


# -- the program ------------------------------------------------------------------


def _megastep_pair(models, params, m, samp, eos, left, jax_side=True):
    """`decode_megastep` over three prompts prefilled into 4-row blocks,
    and a padding row: the port's token grid and pool, then (with
    ``jax_side``) the JAX package's on the same pool and inputs."""
    jm, tm = models
    tp = tm.params_from_jax(params, "cpu")
    prompts = _prompts(3, sizes=(5, 9, 7))
    tables = np.zeros((4, S // 4), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :5] = [5, 6, 7, 8, 9]
    tables[2, :4] = [10, 11, 12, 13]
    toks = np.zeros((3, 16), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    length = np.array([len(p) for p in prompts], np.int32)
    pre = (toks, np.zeros(3, np.int32), length, tables[:3])
    tl, tpool = tm.prefill_paged(tp, tm.init_block_pool(16, 4, "cpu"),
                                 *(torch.from_numpy(a) for a in pre))
    token = np.append(tl.numpy().argmax(-1), 0).astype(np.int32)
    pos = np.append(length, 0).astype(np.int32)
    args = (token, pos, np.asarray(left, np.int32),
            np.asarray(eos, np.int32), tables)
    temp, top_k, top_p, seed = samp

    def tpick(logits, newpos):
        if not temp.any():
            return argmax(logits)
        return sample_tokens(logits, *(torch.from_numpy(a) for a in (
            temp, top_k, top_p, seed)), newpos)

    tgrid, tpool = tm.decode_megastep(tp, tpool, *(torch.from_numpy(a)
                                                   for a in args), m, tpick)
    if not jax_side:
        return tgrid.numpy(), tpool.numpy(), None, None

    def jpick(logits, newpos):
        if not temp.any():
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return jsample_tokens(logits, jnp.asarray(temp), jnp.asarray(top_k),
                              jnp.asarray(top_p), jnp.asarray(seed), newpos)

    def run(p, pool, *a):
        _, pool = jm.prefill_paged(p, pool, *pre)
        return jm.decode_megastep(p, pool, *a, m, jpick)

    pj = {k: jnp.asarray(v) for k, v in params.items()}
    jgrid, jpool = jax.jit(run)(pj, jm.init_block_pool(16, 4),
                                *(jnp.asarray(a) for a in args))
    return tgrid.numpy(), tpool.numpy(), np.asarray(jgrid), np.asarray(jpool)


GREEDY = tuple(np.array(a) for a in ([0.0] * 4, [0] * 4, [1.0] * 4,
                                     [0] * 4))
SAMPLED = (np.array([0.9, 0.0, 1.2, 0.0], np.float32),
           np.array([8, 0, 0, 0], np.int32),
           np.array([1.0, 1.0, 0.9, 1.0], np.float32),
           np.array([11, 5, 3, 0], np.uint32))


@pytest.mark.parametrize("m,samp", [(2, GREEDY), (4, GREEDY), (4, SAMPLED)],
                         ids=["m2", "m4", "m4-sampled"])
def test_decode_megastep_matches_jax(models, wparams, m, samp):
    """Row 0 stops at its EOS (its own second token, first emitted at
    step 0 or 1), row 1 after one token of budget, row 2 runs all m
    steps, row 3 is padding."""
    free = _megastep_pair(models, wparams, m, samp, [-1] * 4, [9, 9, 9, 0],
                          jax_side=False)[0]
    eos = [int(free[0, 1]), -1, -1, -1]
    tgrid, tpool, jgrid, jpool = _megastep_pair(models, wparams, m, samp,
                                                eos, [9, 1, 9, 0])
    np.testing.assert_array_equal(tgrid, jgrid)
    stop = list(free[0]).index(eos[0])     # 0 or 1: before the run ends
    np.testing.assert_array_equal(tgrid[0, :stop + 1], free[0, :stop + 1])
    assert (tgrid[0, stop + 1:] == -2).all()
    assert tgrid[1, 0] >= 0 and (tgrid[1, 1:] == -2).all()
    assert (tgrid[2] >= 0).all() and (tgrid[3] == -2).all()
    np.testing.assert_allclose(tpool[:, :, 1:], jpool[:, :, 1:], atol=TOL,
                               rtol=TOL)


# -- parity --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4])
def test_megastep_token_parity_t0(models, wparams, jax_run, m):
    """The budget edge at every alignment (5, 7, 8 new tokens) and the
    cache-depth edge (prompt 14 and 40 new tokens in seq_len 32)."""
    reqs_kw = [dict(prompt=p, max_new_tokens=n)
               for p, n in zip(_prompts(0), (5, 7, 40, 8))]
    base = _run(_engine(models, wparams, max_new_tokens=40), reqs_kw)
    eng = _mega(models, wparams, m=m, max_new_tokens=40)
    outs = _run(eng, reqs_kw)
    assert outs == base and len(base[2]) < 40
    _greedy_vs_jax(models, wparams, jax_run, reqs_kw, outs)
    assert eng.stats["decode_steps"] == 0 and eng.stats["megasteps"] > 0
    assert eng.leaked_blocks() == 0


def test_megastep_eos_edge_parity(models, wparams, jax_run):
    prompts = _prompts(3)
    base0 = _run(_engine(models, wparams),
                 [dict(prompt=prompts[0], max_new_tokens=8)])[0]
    eos = int(base0[2])
    reqs_kw = [dict(prompt=p, max_new_tokens=8, eos_id=eos)
               for p in prompts]
    base = _run(_engine(models, wparams), reqs_kw)
    assert len(base[0]) <= 3 and base[0][-1] == eos
    eng = _mega(models, wparams)
    outs = _run(eng, reqs_kw)
    assert outs == base
    _greedy_vs_jax(models, wparams, jax_run, reqs_kw, outs)
    assert eng.stats["ingraph_retired"] > 0
    assert eng.leaked_blocks() == 0


def test_megastep_sampled_parity(models, wparams, jax_run):
    reqs_kw = [dict(prompt=p, max_new_tokens=8, temperature=t, top_k=tk,
                    top_p=tp, seed=s)
               for p, t, tk, tp, s in zip(
                   _prompts(5), (0.0, 0.9, 1.3, 0.7), (0, 8, 0, 5),
                   (1.0, 1.0, 0.9, 1.0), (11, 12, 13, 14))]
    base = _run(_engine(models, wparams), reqs_kw)
    assert base == jax_run(reqs_kw)
    eng = _mega(models, wparams)
    assert _run(eng, reqs_kw) == base
    assert eng.leaked_blocks() == 0


def test_megastep_with_spec_is_the_fallback_program(models, wparams):
    """Speculation keeps its draft and verify rounds; a round with no
    real n-gram draft runs the megastep instead of a single step."""
    reqs_kw = [dict(prompt=p, max_new_tokens=8) for p in _prompts(7)]
    base = _run(_engine(models, wparams), reqs_kw)
    eng = _engine(models, wparams, spec=True, spec_k=3, megastep=True,
                  megastep_steps=4)
    assert _run(eng, reqs_kw) == base
    st = eng.stats
    assert st["megasteps"] > 0 and st["decode_steps"] == 0
    assert eng.warmup()["megastep"] == {"m": 4}
    assert eng.leaked_blocks() == 0


# -- kill switch, pins, refusals, respawn, accounting ---------------------------------


@pytest.mark.parametrize("env,want", [
    ({}, 0), ({"MXNET_SERVE_MEGASTEP": "0"}, 0),
    ({"MXNET_SERVE_MEGASTEP": "1"}, 4),
    ({"MXNET_SERVE_MEGASTEP": "1", "MXNET_SERVE_MEGASTEP_STEPS": "3"}, 3)])
def test_megastep_kill_switch_and_pins(models, wparams, monkeypatch, env,
                                       want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = _engine(models, wparams)
    assert eng._mega_m == want
    assert eng.warmup()["megastep"] == (None if not want else {"m": want})
    _run(eng, [dict(prompt=_prompts(4, sizes=(5,))[0])])
    assert (eng.stats["megasteps"] > 0) == bool(want)
    assert (eng.stats["decode_steps"] > 0) == (not want)
    assert _engine(models, wparams, megastep=False)._mega_m == 0


def test_megastep_refusals(models, wparams):
    with pytest.raises(MXNetError, match="paged"):
        _engine(models, wparams, megastep=True, paged=False)
    with pytest.raises(MXNetError, match="MEGASTEP_STEPS"):
        _mega(models, wparams, m=0)
    with pytest.raises(MXNetError, match="MoE"):
        models[1].decode_megastep(None, None, None, None, None, None, None,
                                  1, None, moe_tape=[])


def test_megastep_respawn_carries_config(models, wparams):
    eng = _mega(models, wparams, m=3)
    eng.warmup()
    fresh = eng.respawn()
    assert fresh._mega_m == 3
    outs = _run(fresh, [dict(prompt=_prompts(8, sizes=(6,))[0],
                             max_new_tokens=6)])
    assert len(outs[0]) == 6 and fresh.stats["megasteps"] > 0


def test_megastep_accounting(models, wparams):
    eng = _mega(models, wparams, sampling=True)
    _run(eng, [dict(prompt=p, max_new_tokens=8, temperature=t, seed=4)
               for p, t in zip(_prompts(6), (0.0, 0.9, 0.0, 1.1))])
    st = eng.stats
    reg = telemetry.registry()
    assert st["megasteps"] > 0 and st["decode_steps"] == 0
    # every token past each prefill's first came from a megastep
    assert st["megastep_tokens"] == st["tokens"] - st["prefills"] == 28
    assert st["megastep_tokens"] <= st["megasteps"] * 4 * eng.max_batch
    assert st["ingraph_retired"] > 0
    assert reg.counter("serve.megastep_tokens").value == \
        st["megastep_tokens"]
    assert reg.counter("serve.ingraph_retired").value == \
        st["ingraph_retired"]
    assert reg.counter("serve.megasteps").value == st["megasteps"]
    assert 0 < st["hidden_s"] <= st["wall_s"]
    assert st["fetch_wait_s"] <= st["hidden_s"]
    assert abs(st["host_s"] + st["hidden_s"] - st["wall_s"]) < 1e-6
    assert reg.gauge("serve.replica0.host_frac").value is not None
    assert eng.leaked_blocks() == 0


# -- streaming -------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"megastep": True},
                                {"spec": True, "spec_drafter": "model"}],
                         ids=["plain", "megastep", "spec"])
def test_stream_yields_each_token_once_in_order(models, wparams, kw):
    eng = _engine(models, wparams, **kw)
    eng.warmup()
    seen = []
    req = eng.submit(_prompts(9, sizes=(5,))[0], max_new_tokens=8,
                     on_token=seen.append)
    eng.run_until_idle(timeout=120)
    streamed = list(req.stream(timeout=5))
    assert streamed == req.result(1) == seen and len(streamed) == 8
    assert list(req.stream(timeout=5)) == streamed   # a second iterator


def test_stream_live_consumer_and_on_token_callback(models, wparams):
    """The stream is consumed while the scheduler generates; another
    request's broken callback disturbs neither."""
    eng = _mega(models, wparams)
    eng.warmup()
    seen = []

    def boom(t):
        raise RuntimeError("consumer bug")

    eng.start()
    try:
        req = eng.submit(_prompts(9, sizes=(5,))[0], max_new_tokens=8,
                         on_token=seen.append)
        bad = eng.submit(_prompts(9, sizes=(4,))[0], max_new_tokens=6,
                         on_token=boom)
        streamed = list(req.stream(timeout=60))
        # the broken consumer's request still finishes normally
        assert len(bad.result(60)) == 6
    finally:
        eng.stop()
    assert streamed == req.tokens == seen
    assert eng.leaked_blocks() == 0


def test_stream_timeout_and_typed_error(models, wparams):
    eng = _mega(models, wparams)
    req = eng.submit(_prompts(9, sizes=(4,))[0], max_new_tokens=6)
    with pytest.raises(ServeTimeout):
        next(req.stream(timeout=0.05))   # nothing is serving
    req.cancel()
    eng.run_until_idle(timeout=120)
    with pytest.raises(ServeCancelled):
        list(req.stream(timeout=5))


def test_stream_survives_crash_without_restream(models, wparams,
                                                monkeypatch):
    """``engine_crash`` kills replica0 with a megastep in flight and a
    live consumer attached: the journal migrates the request, and the
    stream and the callback see each position once, the undisturbed
    run's tokens."""
    prompt = [3, 4, 5]
    oracle = _run(_engine(models, wparams, max_new_tokens=12),
                  [dict(prompt=prompt, max_new_tokens=12)])[0]
    engines = [_mega(models, wparams, max_batch=2, decode_buckets=[2],
                     max_new_tokens=12, name="replica%d" % i)
               for i in range(2)]
    router = ReplicaRouter(engines, respawn=False)
    router.warmup()
    monkeypatch.setenv("MXNET_CHAOS", "engine_crash:2:replica0")
    chaos.reset()
    seen = []
    req = engines[0].submit(prompt, deadline_ms=60000, on_token=seen.append)
    streamed = []

    def consume():
        for t in req.stream(timeout=120):
            streamed.append(t)

    consumer = threading.Thread(target=consume)
    consumer.start()
    router.start()
    try:
        assert req.result(timeout=120) == oracle
    finally:
        router.stop()
    consumer.join(timeout=30)
    assert not consumer.is_alive()
    assert engines[0]._dead is not None
    assert telemetry.registry().counter("serve.migrated").value == 1
    assert 0 < engines[1].stats["replays"] and streamed == seen == oracle
    assert engines[1].leaked_blocks() == 0


def test_chaos_block_exhaust_and_prefix_evict_with_megastep(
        models, wparams, monkeypatch):
    reqs_kw = [dict(prompt=p, max_new_tokens=8) for p in _prompts(10)]
    base = _run(_engine(models, wparams), reqs_kw)
    monkeypatch.setenv("MXNET_CHAOS", "block_exhaust:0.15,prefix_evict:0.2")
    chaos.reset()
    eng = _mega(models, wparams)
    assert _run(eng, reqs_kw) == base
    assert eng.leaked_blocks() == 0
