"""The port's serving failure scoping against the JAX engine's, on the CPU.

The counterparts of `tests/test_serving.py`'s quarantine and cache-rebuild
tests and of `tests/test_serve_chaos.py`'s clauses, run through both
engines at that file's size (V, S, L, H, E = 61, 32, 2, 2, 32, prefill
buckets [8, 16]) with the weights and helpers of
`tests/test_torch_serving_prefix.py`:

* `_classify_failure` on a table of failures: chaos's engine crash, a lost
  cache (the port's write mark; the JAX engine's deleted donated buffer),
  out of memory (``torch.cuda.OutOfMemoryError`` too), a deadline, a dead
  device, and the port's own rule for ``CUDA error:`` (device, where the
  JAX engine's message rules say scoped);
* a quarantined prefill and a write-then-raise decode (the port's
  program writes the cache in place and raises; the JAX one deletes its
  donated buffer and raises), in slot and paged modes;
* ``MXNET_SERVE_LAUNCH_RETRIES``: scoped decode failures below it retry,
  at it the engine dies;
* each chaos clause the port injects (``launch_error``,
  ``block_exhaust``, ``prefix_evict``, ``queue_flood``, ``decode_slow``,
  ``engine_crash``) under the same ``MXNET_CHAOS`` and
  ``MXNET_CHAOS_SEED`` in both packages.

In every scenario the same requests end the same way (the error's class,
or the tokens under the 1e-3 margin rule), `stats` agree key for key,
the telemetry counters ``serve.*`` agree name for name (the JAX engine's
``serve.aot.*`` compile counters aside: the port compiles nothing), and
`leaked_blocks()` is 0 on both.
"""
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import chaos as jchaos
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.executor import AotCache
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.serving import (ServeCacheInvalidated, ServeEngineDead,
                                     ServeQuarantined, ServingEngine,
                                     TransformerKVModel)

from test_torch_serving_prefix import (_AOT, _fresh_telemetry,  # noqa: F401
                                       margins, models, same_stats,
                                       wparams)
from test_torch_kernels import _one_thread  # noqa: F401


V = 61


def _pair(models, params, **kw):
    """A port engine and a JAX engine of one configuration, as
    `test_torch_serving_prefix._pair` makes them, the JAX one's compiled
    programs shared per cache geometry (a slot cache's is its
    max_batch)."""
    jm, tm = models
    kw.setdefault("max_batch", 4)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("max_new_tokens", 6)
    teng = ServingEngine(tm, params, ctx="cpu", **kw)
    key = (teng.n_blocks, teng.block_size) if teng._paged \
        else ("slot", teng.max_batch)
    aot = _AOT.setdefault(key, AotCache("serve.aot"))
    jeng = JServingEngine(jm, params, sampling=False, aot=aot, **kw)
    return teng, jeng


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' telemetry and chaos state fresh; no chaos spec."""
    monkeypatch.delenv("MXNET_CHAOS", raising=False)
    monkeypatch.setenv("MXNET_CHAOS_SEED", "0")
    monkeypatch.delenv("MXNET_SERVE_LAUNCH_RETRIES", raising=False)
    for mod in (ttelemetry, jchaos, tchaos):
        mod.reset()
    yield
    for mod in (ttelemetry, jchaos, tchaos):
        mod.reset()


def outcome(r):
    assert r.done
    return (None if r.error is None else type(r.error).__name__,
            list(r.tokens))


def counters():
    """The ``serve.*`` telemetry counters of each package: (JAX, port)."""
    out = []
    for mod in (jtelemetry, ttelemetry):
        got = {k: v for k, v in mod.registry()._counters.items()
               if k.startswith("serve.") and not k.startswith("serve.aot.")}
        out.append(got)
    return out


def both(models, params, teng, jeng, drive, check_margins=True):
    """Run ``drive(engine) -> [requests]`` on each engine to idle, each
    package's chaos stream fresh; the outcomes, the stats and the
    counters must agree and no block may leak.  Returns the port's
    requests."""
    out = []
    for eng, mod in ((jeng, jchaos), (teng, tchaos)):
        mod.reset()
        reqs = drive(eng)
        eng.run_until_idle(timeout=120)
        out.append(reqs)
    jreqs, treqs = out
    ran = [(r.prompt, list(r.tokens)) for r in jreqs
           if r.tokens and r.error is None]
    if ran and check_margins:
        m = margins(models[0], params, ran)
        assert m.min() > 1e-3, m.min()
    assert [outcome(r) for r in treqs] == [outcome(r) for r in jreqs]
    same_stats(teng, jeng)
    jc, tc = counters()
    assert tc == jc
    assert teng.leaked_blocks() == 0 and jeng.leaked_blocks() == 0
    return treqs


def _prompt(rng, n):
    return rng.randint(0, V, size=n).tolist()


# -- the classification --------------------------------------------------------


@pytest.mark.parametrize("case,want", [
    ("chaos_crash", ("device", "device")),
    ("lost_cache", ("cache", "cache")),
    ("RESOURCE_EXHAUSTED: out of memory while allocating", ("scoped",) * 2),
    ("torch_oom", ("scoped", "scoped")),
    ("request deadline exceeded", ("scoped", "scoped")),
    ("dead device: the backend is gone", ("device", "device")),
    ("CUDA error: an illegal memory access was encountered",
     ("scoped", "device")),
    ("CUDA error: out of memory", ("scoped", "scoped")),
    ("CUDA error: device-side assert triggered", ("device", "device")),
    ("launch blew up", ("scoped", "scoped")),
])
def test_classify_failure_table(models, wparams, case, want):
    """Each failure's scope in (JAX, port): the same everywhere but for
    the port's ``CUDA error:`` rule (the CUDA context is unusable after
    one, so the port calls it a dead device)."""
    teng, jeng = _pair(models, wparams, max_batch=2)
    got = []
    for eng, chaos in ((jeng, jchaos), (teng, tchaos)):
        if case == "chaos_crash":
            exc = chaos.ChaosEngineCrash("chaos: engine_crash")
        elif case == "lost_cache":
            if eng is jeng:
                eng._cache.delete()  # a failed launch consumed it
            else:
                eng.model._mark(eng._cache)  # a program raised mid-write
            exc = RuntimeError("launch exploded mid-write")
        elif case == "torch_oom":
            exc = torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        else:
            exc = RuntimeError(case)
        got.append(eng._classify_failure(exc))
    assert tuple(got) == want


def test_write_mark_reads_a_half_written_cache(models, wparams,
                                               monkeypatch):
    """Every program that writes the cache in place clears its write mark
    when it returns; one that raises after its first write leaves it set,
    which `cache_lost` reads; one that raises before it does not."""
    _, tm = models
    params = tm.params_from_jax(wparams, "cpu")
    pool = tm.init_block_pool(8, 4, device="cpu")
    table = torch.tensor([[1, 2, 0, 0, 0, 0, 0, 0]])
    tm.prefill_paged(params, pool, torch.tensor([[3, 4, 5, 6, 7, 0, 0, 0]]),
                     torch.tensor([0]), torch.tensor([5]), table)
    tm.decode_paged(params, pool, torch.tensor([7]), torch.tensor([5]), table)
    tm.copy_block(pool, 1, 3)
    assert not tm.cache_lost(pool)

    def exploding(*a):
        raise RuntimeError("raised after the write")
    with monkeypatch.context() as m:
        m.setattr(tm, "_head", exploding)
        with pytest.raises(RuntimeError):
            tm.decode_paged(params, pool, torch.tensor([7]),
                            torch.tensor([6]), table)
    assert tm.cache_lost(pool)
    cache = tm.init_cache(2, device="cpu")

    def early(*a):
        raise RuntimeError("raised before any write")
    with monkeypatch.context() as m:
        m.setattr(tm, "_ln", early)
        with pytest.raises(RuntimeError):
            tm.decode(params, cache, torch.tensor([1]), torch.tensor([0]),
                      torch.tensor([0]))
    assert not tm.cache_lost(cache)
    logits, kv = tm.prefill(params, torch.tensor([[3, 4, 5, 0]]),
                            torch.tensor([3]))
    tm.write_prefill(cache, kv, torch.tensor([3]), torch.tensor([1]))
    assert not tm.cache_lost(cache) and isinstance(tm, TransformerKVModel)


# -- quarantine and the cache rebuild -----------------------------------------


def _arm(eng, what, action, n=1):
    """Replace engine ``eng``'s program ``what`` ('prefill' or 'decode',
    in either package) by one whose next ``n`` launches run ``action``
    (which raises) instead."""
    left = [n]
    if hasattr(eng, "_compiled_decode"):  # the JAX engine
        name = "_compiled_%s" % what
        real = getattr(eng, name)

        def compiled(bucket):
            prog = real(bucket)

            def call(*a, **k):
                if left[0] > 0:
                    left[0] -= 1
                    action(eng, a)
                return prog(*a, **k)
            return call
        setattr(eng, name, compiled)
        return
    name = {"prefill": "_prefill_chunk" if eng._paged else "_prefill_slot",
            "decode": "_decode"}[what]
    real = getattr(eng, name)

    def launch(*a):
        if left[0] > 0:
            left[0] -= 1
            action(eng, a)
        return real(*a)
    setattr(eng, name, launch)


def _poison(eng, args):
    raise RuntimeError("launch blew up")


def _write_then_raise(eng, args):
    """The program wrote part of the cache and raised: the port's program
    writes NaN over the pool's first usable rows in place (its write
    mark set); the JAX launch consumed its donated buffer."""
    if hasattr(eng, "_compiled_decode"):
        args[1].delete()
    else:
        eng.model._mark(eng._cache)
        eng._cache[:, :, 1] = float("nan")
    raise RuntimeError("launch exploded mid-write")


@pytest.mark.parametrize("paged", [True, False])
def test_quarantined_prefill_leaves_the_batch_alone(models, wparams, paged):
    """A prefill that poisons its own launch (no cache write) fails only
    its request with `ServeQuarantined`; the batch decoding beside it and
    a later request get the fault-free tokens."""
    teng, jeng = _pair(models, wparams, max_batch=3, paged=paged)
    rng = np.random.RandomState(11)
    prompts = [_prompt(rng, n) for n in (4, 6, 3, 5)]

    def drive(eng):
        good = [eng.submit(p, max_new_tokens=5) for p in prompts[:2]]
        for _ in range(2):
            eng.step()
        _arm(eng, "prefill", _poison)
        bad = eng.submit(prompts[2], max_new_tokens=5)
        late = eng.submit(prompts[3], max_new_tokens=3)
        return good + [bad, late]
    treqs = both(models, wparams, teng, jeng, drive)
    assert [outcome(r)[0] for r in treqs] == [None, None,
                                              "ServeQuarantined", None]
    with pytest.raises(ServeQuarantined, match="launch blew up"):
        treqs[2].result(timeout=1)
    assert ttelemetry.registry().counter("serve.quarantined").value == 1
    assert teng._dead is None


@pytest.mark.parametrize("paged", [True, False])
def test_write_then_raise_rebuilds_the_cache(models, wparams, paged):
    """A decode that raises after writing the cache fails every admitted
    sequence with `ServeCacheInvalidated`, rebuilds the cache once, and
    serves the queue: the queued request, and (paged) the one that was
    mid-prefill, requeued once, get the fault-free tokens."""
    teng, jeng = _pair(models, wparams, max_batch=2, paged=paged)
    long = 20 if paged else 12

    def drive(eng):
        _arm(eng, "decode", _write_then_raise)
        return [eng.submit(_prompt(np.random.RandomState(13 + i), n),
                           max_new_tokens=4)
                for i, n in enumerate((3, long, 5))]
    treqs = both(models, wparams, teng, jeng, drive)
    errs = [outcome(r)[0] for r in treqs]
    assert errs.count("ServeCacheInvalidated") >= 1 and errs[2] is None
    if paged:
        assert errs == ["ServeCacheInvalidated", None, None]
    with pytest.raises(ServeCacheInvalidated, match="invalidated"):
        treqs[0].result(timeout=1)
    assert ttelemetry.registry().counter("serve.cache_rebuilds").value == 1
    assert teng._dead is None
    assert not teng.model.cache_lost(teng._cache)
    assert [e["kind"] for e in ttelemetry.events("serve_cache_rebuild")] \
        == ["serve_cache_rebuild"]


@pytest.mark.parametrize("fails", [2, 3])
def test_launch_retries_escalate(models, wparams, monkeypatch, fails):
    """``MXNET_SERVE_LAUNCH_RETRIES=3``: two consecutive scoped decode
    failures retry and the requests complete; the third kills the engine
    and its requests fail `ServeEngineDead`, counted as launch errors."""
    monkeypatch.setenv("MXNET_SERVE_LAUNCH_RETRIES", "3")
    teng, jeng = _pair(models, wparams, max_batch=2)

    def drive(eng):
        _arm(eng, "decode", _poison, n=fails)
        reqs = [eng.submit([3 + i, 5], max_new_tokens=4) for i in range(2)]
        if fails >= 3:
            # on the caller's thread the death escapes `step`: drive the
            # scheduler thread, as the JAX test does
            eng.start()
            for r in reqs:
                with pytest.raises(Exception, match="3 consecutive"):
                    r.result(timeout=60)
            eng.stop()
        return reqs
    treqs = both(models, wparams, teng, jeng, drive)
    reg = ttelemetry.registry()
    assert reg.counter("serve.launch_errors").value == min(fails, 3)
    if fails >= 3:
        assert teng._dead is not None
        assert all(isinstance(r.error, ServeEngineDead) for r in treqs)
        assert reg.counter("serve.engine_failures").value == 1
    else:
        assert teng._dead is None and all(len(r.tokens) == 4 for r in treqs)


# -- chaos's serving clauses ----------------------------------------------------


@pytest.mark.parametrize("spec,kw", [
    ("launch_error:0.3", {}),
    ("block_exhaust:0.3", {}),
    ("prefix_evict:0.5", {"n_blocks": 24}),
    ("queue_flood:2:6", {"queue_max": 3}),
    ("engine_crash:3", {}),
    ("launch_error:0.2,block_exhaust:0.2,prefix_evict:0.3", {}),
])
def test_chaos_clauses_match_jax(models, wparams, monkeypatch, spec, kw):
    """Each clause under one spec and seed in both packages: the same
    requests quarantined, denied, preempted, evicted, shed or failed, the
    same tokens, stats and counters."""
    monkeypatch.setenv("MXNET_CHAOS", spec)
    monkeypatch.setenv("MXNET_SERVE_LAUNCH_RETRIES", "50")
    teng, jeng = _pair(models, wparams, max_batch=3, **kw)
    rng = np.random.RandomState(5)
    prompts = [_prompt(rng, int(n)) for n in rng.randint(2, 14, size=8)]
    shared = prompts[0][:8]

    def drive(eng):
        reqs = []
        for i, p in enumerate(prompts):
            # half of them share an 8-token prefix: parked blocks to evict
            p = shared + p if i % 2 else p
            try:
                reqs.append(eng.submit(p[:20], max_new_tokens=5))
            except Exception as e:  # shed, or dead, at the door in both
                assert type(e).__name__ in ("ServeOverload",
                                            "ServeEngineDead"), e
            try:
                eng.step()
            except Exception as e:  # noqa: BLE001
                # a dead device escapes `step` on the caller's thread;
                # the scheduler thread would die so
                eng._die(str(e)[:500])
        return reqs
    treqs = both(models, wparams, teng, jeng, drive)
    reg = ttelemetry.registry()
    name = spec.split(":")[0]
    moved = {"launch_error": "serve.quarantined",
             "block_exhaust": "serve.alloc_denied",
             "prefix_evict": "serve.prefix_evictions",
             "queue_flood": "serve.chaos_flooded",
             "engine_crash": None}[name]
    if name == "engine_crash":
        assert teng._dead is not None and "engine_crash" in teng._dead
        assert all(isinstance(r.error, ServeEngineDead) for r in treqs
                   if r.error is not None)
    else:
        assert teng._dead is None
        assert reg.counter(moved).value > 0, moved


def test_decode_slow_expires_deadlines_mid_flight(models, wparams,
                                                  monkeypatch):
    """``decode_slow:1.0:30``: every decode sleeps 30 ms, so a 60 ms
    deadline on a 50-token generation expires mid-flight in both engines,
    typed, with the tokens so far a prefix of the fault-free answer."""
    monkeypatch.setenv("MXNET_CHAOS", "decode_slow:1.0:30")
    teng, jeng = _pair(models, wparams, max_new_tokens=50)
    out = []
    for eng, mod in ((jeng, jchaos), (teng, tchaos)):
        mod.reset()
        req = eng.submit([1, 2, 3], max_new_tokens=28, deadline_ms=60)
        t0 = time.perf_counter()
        eng.run_until_idle(timeout=120)
        assert time.perf_counter() - t0 < 30
        assert type(req.error).__name__ == "ServeDeadlineExceeded"
        assert 1 <= len(req.tokens) < 28
        out.append(list(req.tokens))
    n = min(len(t) for t in out)
    assert out[0][:n] == out[1][:n]
    jc, tc = counters()
    for key in ("serve.expired", "serve.requests", "serve.prefills"):
        assert tc[key] == jc[key] == 1
    assert teng._dead is None
