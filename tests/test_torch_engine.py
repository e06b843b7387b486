"""The port's host dependency engine against the JAX package's.

The scenarios of `tests/test_engine.py` (random read/write workloads
over 20 vars against serial execution, readers overlapping and writers
exclusive, `wait_for_var`, duplicate checks, exceptions at the next sync
point, priorities) and the engine half of `tests/test_native.py` (the
C++ engine's workload with priorities, `num_executed`, `push_sync`), each
one parametrised test over the port's three engines: the threaded
`Engine`, `NaiveEngine` and `NativeEngine` (the port's C++ engine, built
at first use).  The JAX package's threaded engine runs the same
workloads beside them, and every result must equal the serial one
exactly.  Then the engine's side of the NDArray: a host op's pending
write (``_hvar``) holds back every read of the array and of its views,
`track_array` holds arrays weakly, and ``MXNET_ENGINE_TYPE`` picks the
engine of `engine.get`.
"""
import gc
import random
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import engine as jax_engine
from mxnet_tpu_torch import engine as eng_mod
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch.base import MXNetError


def _make(kind, workers=4):
    if kind == "threaded":
        return eng_mod.Engine(num_workers=workers)
    if kind == "naive":
        return eng_mod.NaiveEngine()
    return eng_mod.NativeEngine(num_workers=workers)


def _random_workload(num_vars=20, num_ops=200, seed=0):
    """`tests/test_engine.py`'s workload: each op reads some vars, writes
    some others."""
    rng = random.Random(seed)
    ops = []
    for i in range(num_ops):
        reads = rng.sample(range(num_vars), rng.randint(0, 3))
        writes = rng.sample(range(num_vars), rng.randint(1, 2))
        writes = [w for w in writes if w not in reads]
        if writes:
            ops.append((i, reads, writes))
    return ops


def _run_serial(ops, num_vars):
    mem = [0] * num_vars
    for i, reads, writes in ops:
        s = sum(mem[r] for r in reads)
        for w in writes:
            mem[w] = mem[w] * 2 + s + i + 1
    return mem


def _run_engine(engine, ops, num_vars):
    mem = [0] * num_vars
    vars_ = [engine.new_variable() for _ in range(num_vars)]

    def make_fn(i, reads, writes):
        def fn():
            s = sum(mem[r] for r in reads)
            time.sleep(0.0001 * (i % 3))  # jitter to expose races
            for w in writes:
                mem[w] = mem[w] * 2 + s + i + 1
        return fn

    for i, reads, writes in ops:
        engine.push(make_fn(i, reads, writes),
                    const_vars=[vars_[r] for r in reads],
                    mutable_vars=[vars_[w] for w in writes])
    engine.wait_for_all()
    return mem


@pytest.mark.parametrize("kind", ["threaded", "naive", "native"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_workload_matches_serial_and_the_jax_engine(kind, seed):
    ops = _random_workload(seed=seed)
    expected = _run_serial(ops, 20)
    ref_engine = jax_engine.Engine(num_workers=4)
    ref = _run_engine(ref_engine, ops, 20)
    ref_engine.shutdown()
    engine = _make(kind)
    got = _run_engine(engine, ops, 20)
    engine.shutdown()
    assert ref == expected
    assert got == expected


@pytest.mark.parametrize("kind", ["threaded", "native"])
def test_readers_overlap_and_a_writer_is_exclusive(kind):
    engine = _make(kind)
    v = engine.new_variable()
    state = {"readers": 0, "max_readers": 0, "writer_during_read": False}
    lock = threading.Lock()

    def reader():
        with lock:
            state["readers"] += 1
            state["max_readers"] = max(state["max_readers"],
                                       state["readers"])
        time.sleep(0.01)
        with lock:
            state["readers"] -= 1

    def writer():
        with lock:
            if state["readers"] > 0:
                state["writer_during_read"] = True

    for _ in range(4):
        engine.push(reader, const_vars=[v])
    engine.push(writer, mutable_vars=[v])
    for _ in range(4):
        engine.push(reader, const_vars=[v])
    engine.wait_for_all()
    engine.shutdown()
    assert state["max_readers"] >= 2, "readers should overlap"
    assert not state["writer_during_read"], "writer overlapped readers"


@pytest.mark.parametrize("kind", ["threaded", "naive", "native"])
def test_wait_for_var(kind):
    engine = _make(kind, workers=2)
    v = engine.new_variable()
    log = []
    engine.push(lambda: (time.sleep(0.05), log.append("write")),
                mutable_vars=[v])
    engine.wait_for_var(v)
    assert log == ["write"]
    engine.shutdown()


@pytest.mark.parametrize("kind", ["threaded", "native"])
def test_duplicate_and_overlapping_vars_are_refused(kind):
    engine = _make(kind, workers=1)
    v = engine.new_variable()
    with pytest.raises(MXNetError):
        engine.push(lambda: None, const_vars=[v], mutable_vars=[v])
    with pytest.raises(MXNetError):
        engine.push(lambda: None, mutable_vars=[v, v])
    engine.shutdown()


@pytest.mark.parametrize("kind", ["threaded", "native"])
def test_exception_surfaces_at_the_next_sync(kind):
    engine = _make(kind, workers=2)
    v = engine.new_variable()

    def boom():
        raise ValueError("boom")

    engine.push(boom, mutable_vars=[v])
    with pytest.raises(ValueError, match="boom"):
        engine.wait_for_all()
    engine.shutdown()


@pytest.mark.parametrize("kind", ["threaded", "native"])
def test_higher_priority_runs_first(kind):
    engine = _make(kind, workers=1)
    gate = threading.Event()
    order = []
    v0 = engine.new_variable()
    engine.push(lambda: gate.wait(1), mutable_vars=[v0])  # hold the worker
    time.sleep(0.05)  # let the worker take it before the rest queue up
    vars_ = [engine.new_variable() for _ in range(3)]
    for i, pr in enumerate([0, 10, 5]):
        engine.push(lambda i=i: order.append(i), mutable_vars=[vars_[i]],
                    priority=pr)
    gate.set()
    engine.wait_for_all()
    engine.shutdown()
    assert order == [1, 2, 0]


@pytest.mark.parametrize("kind", ["threaded", "naive", "native"])
def test_values_read_are_the_serial_ones_under_priorities(kind):
    """`tests/test_native.py`'s engine workload: 6 vars, 120 ops with
    random priorities; every op must read the values a serial run in push
    order reads."""
    rng = np.random.RandomState(0)
    engine = _make(kind)
    n_vars, n_ops = 6, 120
    vars_ = [engine.new_variable() for _ in range(n_vars)]
    state = [0] * n_vars
    serial = [0] * n_vars
    observed, expected = {}, {}

    def make_fn(k, reads, writes):
        def fn():
            got = tuple(state[i] for i in reads)
            time.sleep(0.0002 * (k % 3))
            for i in writes:
                state[i] = k
            observed[k] = got
        return fn

    for k in range(1, n_ops + 1):
        idx = rng.permutation(n_vars)
        n_read, n_write = rng.randint(0, 3), rng.randint(1, 3)
        reads = list(idx[:n_read])
        writes = list(idx[n_read:n_read + n_write])
        expected[k] = tuple(serial[i] for i in reads)
        for i in writes:
            serial[i] = k
        engine.push(make_fn(k, reads, writes),
                    const_vars=[vars_[i] for i in reads],
                    mutable_vars=[vars_[i] for i in writes],
                    priority=int(rng.randint(0, 3)))
    engine.wait_for_all()
    if kind == "native":
        assert engine.num_executed() == n_ops
    engine.shutdown()
    assert state == serial
    assert observed == expected


@pytest.mark.parametrize("kind", ["threaded", "naive", "native"])
def test_push_sync_returns_the_value(kind):
    engine = _make(kind, workers=2)
    v = engine.new_variable()
    assert engine.push_sync(lambda: 42, const_vars=[v]) == 42
    engine.shutdown()


@pytest.mark.parametrize("kind", ["threaded", "native"])
def test_a_pending_host_write_holds_back_reads_of_the_array_and_views(kind):
    engine = _make(kind, workers=2)
    eng_mod._engine, saved = engine, eng_mod._engine
    try:
        arr = nd.zeros((4, 3), ctx="cpu")
        view = arr[1:3]
        var = engine.new_variable()
        seen = []

        def write():
            time.sleep(0.05)
            # inside the op that holds the var: no wait on itself
            seen.append(float(arr.asnumpy().sum()))
            arr[:] = 5.0

        arr._hvar = (var, object())
        engine.push(write, mutable_vars=[var])
        np.testing.assert_array_equal(view.asnumpy(), np.full((2, 3), 5.0))
        assert arr._hvar is None  # the reader cleared the mark it waited on
        assert seen == [0.0]
        np.testing.assert_array_equal(arr.asnumpy(), np.full((4, 3), 5.0))
    finally:
        eng_mod._engine = saved
        engine.shutdown()


def test_track_array_holds_arrays_weakly_and_waitall_drains():
    arr = nd.ones((2, 2), ctx="cpu")
    assert arr in eng_mod._live_arrays
    n = len(eng_mod._live_arrays)
    del arr
    gc.collect()
    assert len(eng_mod._live_arrays) < n
    engine = eng_mod.get()
    done = []
    engine.push(lambda: (time.sleep(0.02), done.append(1)))
    nd.waitall()
    assert done == [1]


@pytest.mark.parametrize("etype,cls", [
    ("ThreadedEngine", eng_mod.Engine), ("NaiveEngine", eng_mod.NaiveEngine),
    ("NativeEngine", eng_mod.NativeEngine)])
def test_engine_type_pin_picks_the_engine(monkeypatch, etype, cls):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", etype)
    monkeypatch.setattr(eng_mod, "_engine", None)
    engine = eng_mod.get()
    assert type(engine) is cls
    assert eng_mod.get() is engine
    engine.shutdown()
