"""The port's serving request contract against the JAX package's, on the
CPU.

Every submitted request resolves, with its tokens or a typed error:
deadlines and ``cancel()`` (queued: no dispatch; running: the partial
tokens stay on the request), the ``shed``, ``block`` and ``degrade``
overload policies, the anti-thrash guards (``min_progress``, the
oldest request never a victim, stalls, ``thrash_trip``) and the
scheduler thread (`start`, `stop`, `drain`, `run_until_idle`, a dead
scheduler).  Where a scenario runs on both engines, the outcomes (the
error's class name, the tokens) and the `stats` must agree as in
`tests/test_torch_serving_prefix.py`, whose helpers and 1e-3 margin rule
this file uses.  The JAX engine reaches a stall only through its chaos
clause ``block_exhaust``, an allocator that refuses with free blocks on
hand; here both engines' allocators refuse the same calls, drawn from
one seeded stream each.
"""
import threading
import time

import numpy as np
import pytest

from mxnet_tpu.serving import ServeRequest as JServeRequest
from mxnet_tpu.serving import ServingEngine as JServingEngine
from mxnet_tpu_torch.serving import (ServeCancelled, ServeDeadlineExceeded,
                                     ServeEngineDead, ServeOverload,
                                     ServeRequest, ServeTimeout,
                                     ServingEngine)

from test_torch_serving_prefix import (_fresh_telemetry, _pair,  # noqa: F401
                                       _prompt, margins, models, same_stats,
                                       wparams)
from test_torch_kernels import _one_thread  # noqa: F401


def both(models, params, teng, jeng, drive, leaked=True):
    """Run ``drive(engine) -> [requests]`` on each engine to idle; the
    outcomes and the stats must agree.  Returns the port's requests."""
    out = []
    for eng in (jeng, teng):
        reqs = drive(eng)
        eng.run_until_idle(timeout=120)
        out.append(reqs)
    jreqs, treqs = out
    ran = [(r.prompt, list(r.tokens)) for r in jreqs if r.tokens]
    if ran:
        m = margins(models[0], params, ran)
        assert m.min() > 1e-3, m.min()
    assert [outcome(r) for r in treqs] == [outcome(r) for r in jreqs]
    same_stats(teng, jeng)
    if leaked:
        assert teng.leaked_blocks() == 0 and jeng.leaked_blocks() == 0
    return treqs


def outcome(r):
    assert r.done
    return (None if r.error is None else type(r.error).__name__,
            list(r.tokens))


def refuse(eng, p, seed):
    """Make ``eng``'s allocator refuse a fraction ``p`` of its non-empty
    allocations, whatever its free list holds: the JAX chaos clause
    ``block_exhaust:p`` as a seeded stream of its own."""
    rng = np.random.RandomState(seed)
    alloc = eng._alloc.alloc

    def refusing(n):
        if int(n) > 0 and rng.rand() < p:
            return None
        return alloc(n)
    eng._alloc.alloc = refusing
    return alloc


# -- defaults and pins --------------------------------------------------------

_PINS = {"MXNET_SERVE_QUEUE_MAX": "3", "MXNET_SERVE_OVERLOAD": "block",
         "MXNET_SERVE_DEADLINE_MS": "250", "MXNET_SERVE_PREFIX": "0",
         "MXNET_SERVE_PREFIX_POOL": "5", "MXNET_SERVE_MIN_PROGRESS": "2",
         "MXNET_SERVE_THRASH_TRIP": "0"}


@pytest.mark.parametrize("pinned", [False, True])
def test_defaults_read_the_jax_engines_pins(models, wparams, monkeypatch,
                                            pinned):
    """With no keyword, each setting is the JAX engine's: its pin if set,
    else its default (prefix caching on, min_progress 4, thrash_trip 8,
    an unbounded queue, no deadline).  A keyword beats the pin."""
    jm, tm = models
    for k in _PINS:
        monkeypatch.delenv(k, raising=False)
    if pinned:
        for k, v in _PINS.items():
            monkeypatch.setenv(k, v)
    teng = ServingEngine(tm, wparams, ctx="cpu")
    jeng = JServingEngine(jm, wparams)
    for attr in ("_queue_max", "_overload", "_deadline_ms_default",
                 "_prefix_pool", "_min_progress", "_thrash_trip", "name"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert (teng._prefix is None) == (jeng._prefix is None) == pinned
    if not pinned:
        assert (teng._queue_max, teng._overload, teng._deadline_ms_default,
                teng._min_progress, teng._thrash_trip) == \
            (0, "shed", None, 4, 8)
    kw = dict(queue_max=1, overload="degrade", deadline_ms=0, prefix=True,
              prefix_pool=-1, min_progress=0, thrash_trip=3)
    teng = ServingEngine(tm, wparams, ctx="cpu", **kw)
    jeng = JServingEngine(jm, wparams, **kw)
    for attr in ("_queue_max", "_overload", "_deadline_ms_default",
                 "_prefix_pool", "_min_progress", "_thrash_trip"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert teng._prefix is not None
    with pytest.raises(Exception, match="overload policy"):
        ServingEngine(tm, wparams, ctx="cpu", overload="panic")


# -- deadlines and cancellation -----------------------------------------------


def test_deadline_passes_in_the_queue_before_any_dispatch(models, wparams):
    teng, jeng = _pair(models, wparams)
    reqs = []

    def drive(eng):
        req = eng.submit([1, 2], deadline_ms=1)
        with pytest.raises(Exception) as e:
            req.result(timeout=0.01)  # nothing steps: a client-side wait
        assert type(e.value).__name__ == "ServeTimeout"
        time.sleep(0.01)
        eng.step()
        reqs.append(req)
        return [req]
    both(models, wparams, teng, jeng, drive)
    with pytest.raises(ServeDeadlineExceeded, match="ServeRequest %d"
                       % reqs[1].id):
        reqs[1].result(timeout=1)
    assert teng.stats["prefills"] == 0 and teng.stats["expired"] == 1
    assert teng.stats["decode_steps"] == 0


def test_deadline_passes_mid_decode(models, wparams):
    """A running request whose deadline passes leaves the batch at the
    next iteration; its partial tokens stay on the request."""
    teng, jeng = _pair(models, wparams, max_batch=2)

    def drive(eng):
        keep = eng.submit(_prompt(np.random.RandomState(3), 5))
        late = eng.submit([1, 2, 3], deadline_ms=60000)
        eng.step()
        eng.step()
        late.t_deadline = time.perf_counter() - 1.0
        return [keep, late]
    keep, late = both(models, wparams, teng, jeng, drive)
    assert keep.error is None and len(keep.tokens) == 6
    assert isinstance(late.error, ServeDeadlineExceeded)
    assert len(late.tokens) == 3          # a prefill and two decodes
    assert teng.stats["expired"] == 1
    assert not teng._active and len(teng._free) == teng.max_batch


def test_cancel_queued_and_running_requests(models, wparams):
    """``cancel()`` retires a running request (partial tokens kept) and a
    queued one (never dispatched); its neighbour decodes on unchanged."""
    teng, jeng = _pair(models, wparams, max_batch=2, max_new_tokens=8)
    rng = np.random.RandomState(4)
    prompts = [_prompt(rng, 4), _prompt(rng, 9), _prompt(rng, 6)]

    def drive(eng):
        keep, victim, queued = [eng.submit(p) for p in prompts]
        eng.step()
        victim.cancel()
        queued.cancel()
        queued.cancel()                   # idempotent
        return [keep, victim, queued]
    keep, victim, queued = both(models, wparams, teng, jeng, drive)
    assert keep.error is None and len(keep.tokens) == 8
    with pytest.raises(ServeCancelled):
        victim.result(timeout=1)
    assert len(victim.tokens) == 2 and queued.tokens == []
    assert teng.stats["cancelled"] == 2 and teng.stats["prefills"] == 2


# -- overload policies ----------------------------------------------------------


def test_shed_raises_at_the_queue_bound(models, wparams):
    teng, jeng = _pair(models, wparams, queue_max=2, overload="shed")
    sheds = []

    def drive(eng):
        reqs = [eng.submit([1 + i, 2]) for i in range(2)]
        with pytest.raises(Exception, match="queue full") as e:
            eng.submit([3])
        sheds.append(e.value)
        return reqs
    both(models, wparams, teng, jeng, drive)
    assert isinstance(sheds[1], ServeOverload)
    assert type(sheds[0]).__name__ == "ServeOverload"
    assert teng.stats["shed"] == 1 and teng.stats["completed"] == 2


def test_degrade_caps_new_work_until_the_4x_backstop(models, wparams):
    """``degrade`` caps max_new_tokens at max_new_tokens // 4 once the
    queue holds queue_max, and sheds at 4x queue_max; a resumed request
    keeps its promised length."""
    teng, jeng = _pair(models, wparams, queue_max=1, overload="degrade",
                       max_new_tokens=8)

    def drive(eng):
        reqs = [eng.submit([1 + i, 4]) for i in range(4)]
        with pytest.raises(Exception, match="queue full"):
            eng.submit([9])
        return reqs
    reqs = both(models, wparams, teng, jeng, drive)
    assert [r.max_new_tokens for r in reqs] == [8, 2, 2, 2]
    assert [len(r.tokens) for r in reqs] == [8, 2, 2, 2]
    assert teng.stats["degraded"] == 3 and teng.stats["shed"] == 1

    for eng, cls in ((teng, ServeRequest), (jeng, JServeRequest)):
        eng._queue.append(cls([1], 1))
        fresh, moved = cls([2, 3], 8), cls([2, 3], 8)
        moved.tokens = [5, 6, 7]
        moved._resume = ([2, 3, 5, 6], 7, 4, 3)
        eng._enqueue(fresh)
        eng._enqueue(moved)
        assert (fresh.max_new_tokens, moved.max_new_tokens) == (2, 8)
        eng._queue.clear()


def test_block_waits_bounded_by_deadline_cancel_and_stop(models, wparams):
    """``block`` waits for room; the request's own deadline, its
    ``cancel()`` and the engine's ``stop()`` each end the wait typed."""
    teng, jeng = _pair(models, wparams, queue_max=1, overload="block")
    for eng, cls in ((teng, ServeRequest), (jeng, JServeRequest)):
        eng.submit([1, 2])                # fills the queue
        t0 = time.perf_counter()
        with pytest.raises(Exception, match="deadline passed") as e:
            eng.submit([3], deadline_ms=50)
        assert type(e.value).__name__ == "ServeDeadlineExceeded"
        assert time.perf_counter() - t0 >= 0.05
        req = cls([4], 2)
        threading.Timer(0.05, req.cancel).start()
        with pytest.raises(Exception, match="cancelled while blocked") as e:
            eng._enqueue_blocking(req)
        assert type(e.value).__name__ == "ServeCancelled"
        threading.Timer(0.05, eng.stop).start()
        with pytest.raises(Exception, match="stopped") as e:
            eng.submit([5])
        assert type(e.value).__name__ == "ServeEngineDead"
    same_stats(teng, jeng)
    assert teng.stats["expired"] == teng.stats["cancelled"] == 1
    assert teng.stats["block_waits"] == 0 and teng.leaked_blocks() == 0


def test_block_policy_drains_through_the_thread(models, wparams):
    _, tm = models
    eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=2, queue_max=1,
                        overload="block", max_new_tokens=2,
                        prefill_buckets=[8, 16])
    eng.start()
    try:
        reqs = [eng.submit([1 + i]) for i in range(5)]
        outs = [r.result(timeout=60) for r in reqs]
    finally:
        eng.stop()
    assert all(len(o) == 2 for o in outs)
    assert eng.stats["block_waits"] >= 1 and eng.leaked_blocks() == 0


# -- anti-thrash preemption ---------------------------------------------------


def test_min_progress_stalls_instead_of_churning(models, wparams):
    """Under an allocator refusing 70% of its calls, ``min_progress=0``
    preempts on every denial; the default stalls protected rows in place
    and preempts less.  Same tokens either way, the JAX engine's stats."""
    rng = np.random.RandomState(21)
    prompts = [_prompt(rng, n) for n in (3, 9, 5)]
    legs = {}
    for mp in (0, 4):
        teng, jeng = _pair(models, wparams, max_batch=3, max_new_tokens=16,
                           min_progress=mp, name="leg%d" % mp)
        for eng in (teng, jeng):
            refuse(eng, 0.7, 5)
        legs[mp] = both(models, wparams, teng, jeng,
                        lambda eng: [eng.submit(p) for p in prompts])
        legs[mp] = (legs[mp], dict(teng.stats))
    (churn_reqs, churn), (calm_reqs, calm) = legs[0], legs[4]
    assert [r.tokens for r in churn_reqs] == [r.tokens for r in calm_reqs]
    assert churn["preemptions"] > calm["preemptions"]
    assert calm["stalls"] > 0 and churn["stalls"] == 0
    assert calm["stalled"] == calm["stalls"]


@pytest.mark.parametrize("min_progress", [0, 4])
def test_oldest_request_is_never_a_victim(models, wparams, min_progress):
    """Three growers in 5 usable blocks: the pool preempts, never the
    oldest request; ``min_progress=0`` and the default agree with the
    JAX engine's tokens and stats."""
    teng, jeng = _pair(models, wparams, max_batch=3, n_blocks=6,
                       max_new_tokens=12, min_progress=min_progress)
    rng = np.random.RandomState(23)
    prompts = [_prompt(rng, 7) for _ in range(3)]
    reqs = both(models, wparams, teng, jeng,
                lambda eng: [eng.submit(p) for p in prompts])
    assert teng.stats["preemptions"] >= 1
    assert reqs[0]._preempt_n_new is None
    assert any(r._preempt_n_new is not None for r in reqs[1:])


def test_thrash_trip_degrades_until_a_completion(models, wparams):
    """``thrash_trip`` preemptions with no completion cap new admissions
    at max_new_tokens // 4 until a request completes."""
    teng, jeng = _pair(models, wparams, max_batch=3, max_new_tokens=8,
                       min_progress=0, thrash_trip=2)
    probes = []

    def drive(eng):
        restore = refuse(eng, 0.9, 6)
        reqs = [eng.submit([3 + i, 4]) for i in range(3)]
        while eng.stats["thrash_trips"] < 1:
            eng.step()
        assert eng._storm
        probe = eng.submit([9, 9], max_new_tokens=8)
        probes.append(probe)
        eng._alloc.alloc = restore
        return reqs + [probe]
    both(models, wparams, teng, jeng, drive)
    assert probes[1].max_new_tokens == 2 and len(probes[1].tokens) == 2
    assert not teng._storm and teng.stats["degraded"] >= 1
    assert teng.stats["thrash_trips"] == 1


# -- the scheduler thread and the engine's lifetime ---------------------------


def test_thread_serves_what_stepping_serves(models, wparams):
    """`start` runs the scheduler on its own thread: the same tokens as
    stepping on the caller's; `run_until_idle` then polls; `stop` leaves
    later submits typed."""
    _, tm = models
    rng = np.random.RandomState(8)
    prompts = [_prompt(rng, n) for n in (5, 17, 3, 11)]
    outs = []
    for threaded in (False, True):
        eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=2,
                            prefill_buckets=[8, 16], max_new_tokens=5)
        if threaded:
            assert eng.start() is eng.start()  # idempotent
        reqs = [eng.submit(p) for p in prompts]
        assert eng.run_until_idle(timeout=60) == 0 or not threaded
        outs.append([r.result(timeout=60) for r in reqs])
        eng.stop()
        with pytest.raises(ServeEngineDead, match="stopped"):
            eng.submit([1])
        assert eng.leaked_blocks() == 0
    assert outs[0] == outs[1]


def test_stop_resolves_every_request(models, wparams):
    """Whatever is queued or admitted when the engine stops fails with
    `ServeEngineDead`; no `result()` hangs, no block leaks."""
    _, tm = models
    eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=2,
                        prefill_buckets=[8, 16], max_new_tokens=20)
    reqs = [eng.submit([1 + i, 2, 3]) for i in range(4)]
    eng.step()
    assert len(eng._active) == 2 and len(eng._queue) == 2
    eng.stop()
    for r in reqs:
        with pytest.raises(ServeEngineDead, match="engine stopped"):
            r.result(timeout=1)
    assert len(reqs[0].tokens) == 2 and reqs[3].tokens == []
    assert eng.leaked_blocks() == 0
    assert eng._alloc.free_blocks + eng._prefix.parked_count \
        == eng._alloc.capacity


def test_drain_serves_out_then_closes_admission(models, wparams):
    teng, jeng = _pair(models, wparams, max_new_tokens=4)
    strag = []

    def drive(eng):
        reqs = [eng.submit([3 + i, 4]) for i in range(2)]
        strag.append(eng.drain())
        with pytest.raises(Exception, match="draining") as e:
            eng.submit([9, 9])
        assert type(e.value).__name__ == "ServeEngineDead"
        return reqs
    both(models, wparams, teng, jeng, drive)
    assert strag == [[], []] and teng.stats["drained"] == 1


def test_drain_deadline_returns_the_stragglers(models, wparams):
    """A drain whose budget runs out stops the scheduler and hands back
    the unfinished requests unresolved, blocks released, the running
    ones first with their partial tokens; the thread-driven drain closes
    admission while it serves."""
    _, tm = models
    eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=2,
                        prefill_buckets=[8, 16], max_new_tokens=30)
    reqs = [eng.submit([3 + i, 4]) for i in range(4)]
    eng.step()
    stragglers = eng.drain(deadline_ms=1)
    assert stragglers and all(not r.done for r in stragglers)
    assert stragglers[0].tokens and stragglers[-1] is reqs[-1]
    assert eng.leaked_blocks() == 0 and eng.stats["drained"] == 1
    for r in reqs:
        r._finish(error=ServeEngineDead("test cleanup"))

    eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=2,
                        prefill_buckets=[8, 16], max_new_tokens=6)
    eng.start()
    reqs = [eng.submit([3 + i, 4]) for i in range(3)]
    closed = []

    def submit_during_drain():
        while not eng._draining:
            time.sleep(0.001)
        try:
            eng.submit([1])
        except ServeEngineDead as e:
            closed.append(e)
    t = threading.Thread(target=submit_during_drain)
    t.start()
    assert eng.drain() == []
    t.join(10)
    assert closed and [len(r.result(1)) for r in reqs] == [6, 6, 6]


def test_a_dead_scheduler_fails_every_request(models, wparams):
    """An exception escaping a step on the thread kills the scheduler:
    admitted and queued requests fail `ServeEngineDead`, later submits
    raise it, `run_until_idle` returns."""
    _, tm = models
    eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=2,
                        prefill_buckets=[8, 16], max_new_tokens=8)
    decode = eng._decode_plain
    calls = [0]

    def failing():
        calls[0] += 1
        if calls[0] > 2:
            raise RuntimeError("device lost")
        decode()
    eng._decode_plain = failing
    reqs = [eng.submit([1 + i, 2]) for i in range(3)]
    eng.start()
    for r in reqs:
        with pytest.raises(ServeEngineDead, match="device lost"):
            r.result(timeout=30)
    with pytest.raises(ServeEngineDead, match="scheduler died"):
        eng.submit([1])
    assert eng.run_until_idle(timeout=5) == 0
    assert eng.leaked_blocks() == 0
    with pytest.raises(ServeTimeout):
        ServeRequest([1], 1).result(timeout=0.001)


def test_concurrent_submitters_lose_no_request_or_count(models, wparams):
    """16 threads (twice this machine's cores, or more) submit into a
    bounded ``degrade`` queue while the scheduler thread serves it, with
    the interpreter switching threads every 10 us: every request resolves
    once, with its tokens or `ServeOverload`, and the counters the two
    sides share add up."""
    import os
    import sys
    _, tm = models
    eng = ServingEngine(tm, wparams, ctx="cpu", max_batch=4,
                        prefill_buckets=[8, 16], max_new_tokens=4,
                        queue_max=2, overload="degrade")
    n_threads = max(16, 2 * (os.cpu_count() or 1))
    reqs, sheds, lock = [], [0], threading.Lock()

    def submitter(i):
        for j in range(5):
            try:
                r = eng.submit([1 + i % 50, 2 + j])
            except ServeOverload:
                with lock:
                    sheds[0] += 1
                continue
            with lock:
                reqs.append(r)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        outs = [r.result(timeout=60) for r in reqs]
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    st = eng.stats
    assert len(reqs) + sheds[0] == 5 * n_threads
    assert st["shed"] == sheds[0] and st["completed"] == len(reqs)
    assert st["degraded"] == sum(r.max_new_tokens == 1 for r in reqs)
    assert all(len(o) == r.max_new_tokens for o, r in zip(outs, reqs))
    assert st["tokens"] == sum(len(o) for o in outs)
    assert eng.leaked_blocks() == 0
