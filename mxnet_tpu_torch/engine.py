"""Host-side dependency engine.

A port of `mxnet_tpu/engine.py`.  Reference: `include/mxnet/engine.h`,
`src/engine/threaded_engine.{h,cc}`,
`src/engine/threaded_engine_perdevice.cc`, `src/engine/naive_engine.cc`.

The split of responsibilities:

* **Device compute is ordered by the CUDA streams.**  Every torch op on a
  CUDA tensor is queued asynchronously on its stream, which is what the
  reference's per-device worker threads + CUDA streams did for mshadow
  kernels.  The engine does not re-schedule device work.
* **Host-side ordering is ours.**  IO prefetch, KVStore host reductions,
  checkpoint writes and custom host callbacks still need the reference's
  single-writer / multi-reader versioned-variable semantics
  (`threaded_engine.cc:32-168`).  This module implements that dependency
  tracker over a thread pool, with the same API shape:
  ``push(fn, const_vars, mutable_vars, priority)`` + ``wait_for_var`` /
  ``wait_for_all``.

Engine selection follows the reference (`src/engine/engine.cc:14-27`): set
``MXNET_ENGINE_TYPE=NaiveEngine`` for a fully synchronous engine (debugging /
deterministic bisection) or ``NativeEngine`` for the C++ engine of
`_native` (built at first use; a failed build raises); default is the
threaded engine.  An NDArray that a host op will write carries the op's
var (``NDArray._hvar``), and every read of it waits for the op.
"""
from __future__ import annotations

import heapq
import itertools
import os
import threading
import weakref
from collections import deque

import torch

from .base import MXNetError


class Var:
    """A versioned variable: the unit of read/write dependency tracking.

    State machine follows `ThreadedVar` (`src/engine/threaded_engine.cc:32-79`):
    a FIFO of pending blocks per var; readers run concurrently, a writer waits
    for all earlier readers and runs exclusively.
    """

    __slots__ = ("queue", "num_running_reads", "_engine", "__weakref__")

    def __init__(self, engine):
        self.queue = deque()  # entries: [is_write, op]
        self.num_running_reads = 0
        self._engine = engine

    # All methods below are called with the engine lock held.
    def append_read(self, op) -> bool:
        """Register a read; returns True if the read can start now."""
        if not self.queue:  # no queued writer ahead of us
            self.num_running_reads += 1
            return True
        self.queue.append([False, op])
        return False

    def append_write(self, op) -> bool:
        """Register a write; returns True if the write can start now."""
        entry = [True, op]
        self.queue.append(entry)
        return self.queue[0] is entry and self.num_running_reads == 0

    def complete_read(self):
        """A reader finished; returns ops that became ready."""
        self.num_running_reads -= 1
        if self.num_running_reads == 0 and self.queue and self.queue[0][0]:
            return [self.queue[0][1]]
        return []

    def complete_write(self):
        """The head writer finished; returns ops that became ready."""
        self.queue.popleft()
        ready = []
        while self.queue and not self.queue[0][0]:
            _, op = self.queue.popleft()
            self.num_running_reads += 1
            ready.append(op)
        if not ready and self.queue and self.num_running_reads == 0:
            ready.append(self.queue[0][1])
        return ready


# Vars held by the engine op executing on the CURRENT thread.  Lets a
# sync point (NDArray._sync_host) detect "I am inside the op that owns
# this var" and skip the wait — the reference never hits this because its
# engine fns receive raw TBlobs, not NDArrays; ours run arbitrary Python
# that may touch the arrays they are producing (e.g. the kvstore pull op
# writing its out arrays).
_tls = threading.local()


def current_op_holds(var):
    held = getattr(_tls, "held", None)
    return held is not None and id(var) in held


class _Opr:
    __slots__ = ("fn", "const_vars", "mutable_vars", "priority", "wait", "name")

    def __init__(self, fn, const_vars, mutable_vars, priority, name):
        self.fn = fn
        self.const_vars = const_vars
        self.mutable_vars = mutable_vars
        self.priority = priority
        self.wait = 0
        self.name = name


class Engine:
    """Threaded host-side dependency engine (default).

    Reference: `ThreadedEnginePerDevice` with the var bookkeeping of
    `ThreadedEngine`.  One pool of worker threads (host tasks have no
    per-device affinity; device work is the streams').
    """

    def __init__(self, num_workers=None):
        if num_workers is None:
            num_workers = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "4"))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ready = []  # heapq of (-priority, seq, op)
        self._seq = itertools.count()
        self._num_pending = 0  # pushed but not completed
        self._all_done = threading.Condition(self._lock)
        self._shutdown = False
        self._threads = []
        self._exceptions = []
        for i in range(max(1, num_workers)):
            t = threading.Thread(target=self._worker, name="mx-engine-%d" % i, daemon=True)
            t.start()
            self._threads.append(t)

    # -- public API -------------------------------------------------------
    def new_variable(self) -> Var:
        return Var(self)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name="opr"):
        """Schedule ``fn()`` to run once all dependencies are satisfied.

        ``const_vars`` are read, ``mutable_vars`` are written.  Overlapping or
        duplicate var lists are rejected like `CheckDuplicate`
        (`threaded_engine.cc:205-237`).
        """
        const_vars = list(const_vars)
        mutable_vars = list(mutable_vars)
        mset = set(map(id, mutable_vars))
        if len(mset) != len(mutable_vars):
            raise MXNetError("duplicate variables in mutable_vars")
        if any(id(v) in mset for v in const_vars):
            raise MXNetError("const_vars and mutable_vars overlap")
        op = _Opr(fn, const_vars, mutable_vars, priority, name)
        with self._lock:
            if self._shutdown:
                raise MXNetError("engine has been shut down")
            self._num_pending += 1
            op.wait = len(const_vars) + len(mutable_vars) + 1
            satisfied = 1  # the +1 sentinel: op fully registered
            for v in const_vars:
                if v.append_read(op):
                    satisfied += 1
            for v in mutable_vars:
                if v.append_write(op):
                    satisfied += 1
            op.wait -= satisfied
            if op.wait == 0:
                self._enqueue(op)

    def push_sync(self, fn, const_vars=(), mutable_vars=(), priority=0, name="opr"):
        """Push and wait for this op to complete (reference `PushSync` is
        async-push-of-sync-fn; this also blocks like DoSync callers expect)."""
        done = threading.Event()
        box = {}

        def run():
            try:
                box["v"] = fn()
            finally:
                done.set()

        self.push(run, const_vars, mutable_vars, priority, name)
        done.wait()
        self._raise_pending()
        return box.get("v")

    def wait_for_var(self, var: Var):
        """Block until all previously pushed ops touching ``var`` finish.

        Implemented as a sentinel read op, like `threaded_engine.cc:300-327`.
        """
        done = threading.Event()
        self.push(done.set, const_vars=[var], name="wait_for_var")
        done.wait()
        self._raise_pending()

    def wait_for_all(self):
        """Block until the engine queue drains (`Engine::WaitForAll`)."""
        with self._all_done:
            while self._num_pending > 0:
                self._all_done.wait()
        self._raise_pending()

    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    # -- internals --------------------------------------------------------
    def _enqueue(self, op):
        heapq.heappush(self._ready, (-op.priority, next(self._seq), op))
        self._cv.notify()

    def _worker(self):
        while True:
            with self._cv:
                while not self._ready and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._ready:
                    return
                _, _, op = heapq.heappop(self._ready)
            _tls.held = {id(v) for v in op.const_vars}
            _tls.held.update(id(v) for v in op.mutable_vars)
            try:
                op.fn()
            except Exception as e:  # surfaced at next sync point
                with self._lock:
                    self._exceptions.append(e)
            finally:
                _tls.held = None
            self._complete(op)

    def _complete(self, op):
        with self._lock:
            ready = []
            for v in op.const_vars:
                ready += v.complete_read()
            for v in op.mutable_vars:
                ready += v.complete_write()
            for r in ready:
                r.wait -= 1
                if r.wait == 0:
                    self._enqueue(r)
            self._num_pending -= 1
            if self._num_pending == 0:
                self._all_done.notify_all()

    def _raise_pending(self):
        with self._lock:
            if self._exceptions:
                exc = self._exceptions[0]
                self._exceptions.clear()
                raise exc


class NaiveEngine(Engine):
    """Fully synchronous engine: ops execute inline at push.

    Reference `src/engine/naive_engine.cc`; select with
    ``MXNET_ENGINE_TYPE=NaiveEngine`` for debugging/determinism.
    """

    def __init__(self):  # no threads
        self._exceptions = []
        self._lock = threading.Lock()
        self._num_pending = 0

    def new_variable(self):
        return Var(self)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0, name="opr"):
        fn()

    def push_sync(self, fn, const_vars=(), mutable_vars=(), priority=0, name="opr"):
        return fn()

    def wait_for_var(self, var):
        pass

    def wait_for_all(self):
        pass

    def shutdown(self):
        pass


class NativeVar:
    """Variable handle owned by the native engine (C++ `ThreadedVar`)."""

    __slots__ = ("handle", "_eng")

    def __init__(self, eng):
        self._eng = eng
        self.handle = eng._lib.mxtpu_var_create(eng._handle)

    def __del__(self):
        try:
            if self.handle and self._eng._handle:
                self._eng._lib.mxtpu_var_delete(self._eng._handle, self.handle)
        except Exception:
            pass


class NativeEngine:
    """C++ dependency engine (`mxnet_tpu_torch/native/engine.cc`)
    behind the same API.

    The scheduler, var bookkeeping and worker pool run in native threads
    (the reference's architecture, `src/engine/threaded_engine.cc`); Python
    callables are invoked from those threads via a ctypes trampoline.
    Select with ``MXNET_ENGINE_TYPE=NativeEngine``; the library builds at
    first use, and a failed build raises.
    """

    def __init__(self, num_workers=None):
        from . import _native
        self._lib = _native.lib()
        if num_workers is None:
            num_workers = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "4"))
        self._handle = self._lib.mxtpu_engine_create(num_workers)
        self._lock = threading.Lock()
        self._exceptions = []
        self._callbacks = {}  # token -> callable (kept alive until run)
        self._tokens = itertools.count(1)

        def _trampoline(arg):
            token = int(arg)
            with self._lock:
                entry = self._callbacks.pop(token, None)
            if entry is None:
                return
            fn, held = entry
            _tls.held = held  # same contract as Engine._worker
            try:
                fn()
            except Exception as e:  # surfaced at next sync point
                with self._lock:
                    self._exceptions.append(e)
            finally:
                _tls.held = None

        self._c_trampoline = _native._FN_T(_trampoline)  # keep alive

    def new_variable(self):
        return NativeVar(self)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name="opr"):
        import ctypes
        const_vars = list(const_vars)
        mutable_vars = list(mutable_vars)
        mset = set(id(v) for v in mutable_vars)
        if len(mset) != len(mutable_vars):
            raise MXNetError("duplicate variables in mutable_vars")
        if any(id(v) in mset for v in const_vars):
            raise MXNetError("const_vars and mutable_vars overlap")
        token = next(self._tokens)
        held = {id(v) for v in const_vars}
        held.update(id(v) for v in mutable_vars)
        with self._lock:
            self._callbacks[token] = (fn, held)
        H = ctypes.c_int64
        cv = (H * max(1, len(const_vars)))(*[v.handle for v in const_vars])
        mv = (H * max(1, len(mutable_vars)))(*[v.handle for v in mutable_vars])
        rc = self._lib.mxtpu_push(
            self._handle, self._c_trampoline, ctypes.c_void_p(token),
            cv, len(const_vars), mv, len(mutable_vars), priority)
        if rc != 0:
            from . import _native
            with self._lock:
                self._callbacks.pop(token, None)
            raise MXNetError("native push failed: %s" % _native.last_error())

    def push_sync(self, fn, const_vars=(), mutable_vars=(), priority=0,
                  name="opr"):
        done = threading.Event()
        box = {}

        def run():
            try:
                box["v"] = fn()
            finally:
                done.set()

        self.push(run, const_vars, mutable_vars, priority, name)
        done.wait()
        self._raise_pending()
        return box.get("v")

    def wait_for_var(self, var):
        self._lib.mxtpu_wait_for_var(self._handle, var.handle)
        self._raise_pending()

    def wait_for_all(self):
        self._lib.mxtpu_wait_all(self._handle)
        self._raise_pending()

    def num_executed(self):
        return self._lib.mxtpu_engine_num_executed(self._handle)

    def shutdown(self):
        if self._handle:
            self._lib.mxtpu_engine_destroy(self._handle)
            self._handle = 0

    def _raise_pending(self):
        with self._lock:
            if self._exceptions:
                exc = self._exceptions[0]
                self._exceptions.clear()
                raise exc


_engine = None
_engine_lock = threading.Lock()

# Live NDArrays, held weakly (a tracked array is never kept alive by the
# set); wait_for_all() synchronizes the cards they live on, which gives the
# reference's "engine drained" guarantee across both the host engine and
# the CUDA streams.
_live_arrays: "weakref.WeakSet" = weakref.WeakSet()


def get() -> Engine:
    """Singleton engine (reference `Engine::Get`, `src/engine/engine.cc`)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            etype = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEngine")
            if etype == "NaiveEngine":
                _engine = NaiveEngine()
            elif etype == "NativeEngine":
                _engine = NativeEngine()
            else:
                _engine = Engine()
        return _engine


def track_array(nd):
    _live_arrays.add(nd)


def wait_for_all():
    """Drain the host engine, then block until the queued work of every card
    that holds a live NDArray is done (reference `MXNDArrayWaitAll`)."""
    get().wait_for_all()
    devices = {nd._buf.device for nd in list(_live_arrays)}
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
