"""Data iterators.

A port of `mxnet_tpu/io.py` (the reference's `include/mxnet/io.h`,
`src/io/`, `python/mxnet/io.py`): `DataBatch`, `DataIter`, `NDArrayIter`
(shuffle from numpy's global generator, which `random.seed` seeds;
last-batch ``pad``, ``discard`` and ``roll_over``), `CSVIter`,
`MNISTIter` (idx files, ``part_index``/``num_parts`` sharding),
`ResizeIter` and `PrefetchingIter`, the same code over the port's
NDArray.  Batches are NDArrays on the CPU.

`DevicePrefetchIter` is the training loops' device-staging layer
(``MXNET_DEVICE_PREFETCH``, default depth 2): a producer thread pulls
host batches from the inner iterator and a stager thread cuts each into
the executor group's per-device slices (`PrefetchPlan`) and copies them
to their devices while the step before computes.  On CUDA the stager
copies from pinned host memory on a side `torch.cuda.Stream` and records
an event; the consuming step makes its stream wait on the event (no host
sync) and `record_stream` keeps the allocator from reusing a slice's
memory while that step still reads it
(`executor_manager.DataParallelExecutorGroup.load_data_batch`).  On the
CPU the stager makes plain copies.  A worker's exception surfaces in
`next()`, `close()` is idempotent and joins both threads, and the
training loops close the iterator in ``finally`` (`close_iter`).  Both
prefetchers report their waits to `telemetry` (``io.wait_ms``;
``io.device_wait_ms``, ``io.prefetch_depth``, ``io.input_wait_frac``).
A batch already on its device (`ImageRecordIter`'s augmented batches) is
staged without a round trip through host memory: a slice that is the
whole batch is the batch's own tensor.

`ImageRecordIter` reads recordio packs (`recordio`) through the native
threaded loader (`_native`, which builds at first use; a failed build
raises) or, where the caller asks (``use_native=False``) or the payloads
are neither .npy nor JPEG, in Python, and augments on the device of
`context.current_context()` when it is made (`image.ImageAugmenter`):
its batches live on that device, the card unless a ``with mx.cpu()``
scope says otherwise, whichever thread (a prefetcher's) calls `next`.
"""
from __future__ import annotations

import gzip
import logging
import os
import queue as _queue
import struct
import threading
import time

import numpy as np
import torch

from . import recordio, telemetry
from .base import MXNetError, check_shape
from .context import cpu, current_context
from .ndarray import NDArray, array
from .recordio import _LREC_MASK, _MAGIC

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "ResizeIter", "PrefetchingIter", "PrefetchPlan",
           "DevicePrefetchIter", "device_prefetch_depth", "close_iter",
           "ImageRecordIter"]


class DataBatch:
    """One batch (reference `DataBatch`, `io.h:60-69`)."""

    def __init__(self, data, label, pad=0, index=None, bucket_key=None,
                 provide_data=None, provide_label=None):
        self.data = data  # list of NDArray
        self.label = label  # list of NDArray
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base (reference `python/mxnet/io.py:35`)."""

    def __init__(self):
        self.batch_size = 0

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        raise NotImplementedError()

    def __next__(self):
        return self.next()

    # convenience accessors used by older loops
    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            self._next_batch = None
            return False

    def getdata(self):
        return self._next_batch.data[0]

    def getlabel(self):
        return self._next_batch.label[0]

    def getindex(self):
        return self._next_batch.index

    def getpad(self):
        return self._next_batch.pad

    @property
    def provide_data(self):
        """[(name, shape)] of data (`io.py` provide_data)."""
        raise NotImplementedError()

    @property
    def provide_label(self):
        raise NotImplementedError()


class NDArrayIter(DataIter):
    """In-memory iterator (`python/mxnet/io.py:319` NDArrayIter): shuffle,
    pad/discard/roll_over last-batch handling."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__()
        self.data = self._init_data(data, data_name)
        self.label = self._init_data(label, label_name) if label is not None else []
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise MXNetError("batch_size larger than dataset")
        self.cursor = -batch_size
        self._order = np.arange(self.num_data)
        if shuffle:
            np.random.shuffle(self._order)

    @staticmethod
    def _init_data(data, default_name):
        if data is None:
            return []
        if isinstance(data, (np.ndarray, NDArray)):
            data = {default_name: data}
        elif isinstance(data, (list, tuple)):
            data = {("%s_%d" % (default_name, i) if i else default_name): d
                    for i, d in enumerate(data)}
        out = []
        for k, v in data.items():
            if isinstance(v, NDArray):
                v = v.asnumpy()
            out.append((k, np.asarray(v)))
        return out

    @property
    def provide_data(self):
        return [(k, (self.batch_size,) + v.shape[1:]) for k, v in self.data]

    @property
    def provide_label(self):
        return [(k, (self.batch_size,) + v.shape[1:]) for k, v in self.label]

    def reset(self):
        if self.shuffle:
            # re-derive the permutation from scratch: the epoch's order
            # must be a pure function of the RNG state at reset time (an
            # in-place shuffle composes with every PREVIOUS epoch's), so
            # auto-resume can replay one epoch's order from one saved RNG
            # snapshot (checkpoint.save_auto / docs/fault_tolerance.md)
            self._order = np.arange(self.num_data)
            np.random.shuffle(self._order)
        if self.last_batch_handle == "roll_over" and self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor - self.num_data)
        else:
            self.cursor = -self.batch_size

    def _getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def _take(self, arrs):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            idx = self._order[self.cursor:end]
        else:  # pad by wrapping
            idx = np.concatenate(
                [self._order[self.cursor:], self._order[:end - self.num_data]]
            )
        # host batches: the training loop copies them to its devices
        return [array(v[idx], ctx=cpu()) for _, v in arrs]

    def next(self):
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        if self.cursor + self.batch_size > self.num_data and \
                self.last_batch_handle == "discard":
            raise StopIteration
        return DataBatch(
            data=self._take(self.data),
            label=self._take(self.label),
            pad=self._getpad(),
            index=None,
            provide_data=self.provide_data,
            provide_label=self.provide_label,
        )


class CSVIter(DataIter):
    """CSV reader (`src/io/iter_csv.cc`): data_csv + optional label_csv,
    fixed row shapes, part_index/num_parts sharding."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, part_index=0, num_parts=1,
                 label_name="label"):
        super().__init__()
        data = np.loadtxt(data_csv, delimiter=",", ndmin=2, dtype=np.float32)
        data = data.reshape((-1,) + check_shape(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", ndmin=2, dtype=np.float32)
            label = label.reshape((-1,) + check_shape(label_shape))
            if label.shape[-1] == 1:
                label = label[..., 0]
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        if num_parts > 1:
            data = data[part_index::num_parts]
            label = label[part_index::num_parts]
        handle = "pad" if round_batch else "discard"
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size, last_batch_handle=handle,
            label_name=label_name,
        )
        self.batch_size = batch_size

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError("%s is not an MNIST image file" % path)
        data = np.frombuffer(f.read(), dtype=np.uint8).reshape(num, rows, cols)
    return data


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError("%s is not an MNIST label file" % path)
        return np.frombuffer(f.read(), dtype=np.uint8)


class MNISTIter(DataIter):
    """idx-format MNIST reader (`src/io/iter_mnist.cc`): flat or (1,28,28)
    layout, shuffle, silent, part_index/num_parts distributed sharding."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, part_index=0, num_parts=1,
                 input_shape=None):
        super().__init__()
        imgs = _read_idx_images(image).astype(np.float32) / 255.0
        lbls = _read_idx_labels(label).astype(np.float32)
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            lbls = lbls[part_index::num_parts]
        if flat:
            imgs = imgs.reshape(len(imgs), -1)
        else:
            imgs = imgs.reshape(len(imgs), 1, imgs.shape[1], imgs.shape[2])
            if input_shape is not None:
                imgs = imgs.reshape((len(imgs),) + check_shape(input_shape))
        if shuffle:
            rng = np.random.RandomState(seed)
            order = rng.permutation(len(imgs))
            imgs, lbls = imgs[order], lbls[order]
        self._inner = NDArrayIter(imgs, lbls, batch_size=batch_size,
                                  shuffle=False, last_batch_handle="pad")
        self.batch_size = batch_size

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class ResizeIter(DataIter):
    """An iterator resized to a fixed number of batches an epoch
    (`python/mxnet/io.py` ResizeIter): the inner one is reset and read on
    when it runs out first."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.batch_size = data_iter.batch_size

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class _WorkerError:
    """Queue marker carrying a prefetch worker's exception to the
    consumer thread, which raises it."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


def _drain_and_join(threads, queues, deadline_s=5.0):
    """Stop protocol of the prefetch iterators: drain the queues (so a
    worker blocked on a full ``put`` sees its stop flag) while joining,
    up to the deadline.  Returns the threads still alive then (stuck in
    the inner iterator's ``next()``), which `reset` waits out before it
    touches the inner iterator again."""
    deadline = time.perf_counter() + deadline_s
    while any(t.is_alive() for t in threads):
        for q in queues:
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
        for t in threads:
            t.join(timeout=0.05)
        if time.perf_counter() > deadline:
            break
    return [t for t in threads if t.is_alive()]


def _require_workers_dead(stale, what):
    """Wait out any worker an earlier `close` left inside the inner
    iterator's ``next()`` (two threads in one iterator would corrupt its
    cursor); one that will not end raises."""
    alive = [t for t in stale if t.is_alive()]
    for t in alive:
        t.join(timeout=30)
    if any(t.is_alive() for t in alive):
        raise MXNetError(
            "%s.reset(): a prefetch worker is still blocked inside the "
            "inner iterator's next(); cannot safely reset" % what)
    return []


class PrefetchingIter(DataIter):
    """Prefetch over one or more iterators on a worker thread and a
    bounded queue (`python/mxnet/io.py` PrefetchingIter).  The worker
    starts at the first `next()`; `close()` (idempotent; also from
    `reset` and the training loops' ``finally``) stops and joins it; a
    closed iterator revives on `reset()` or `next()`."""

    def __init__(self, iters, capacity=2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.iters = iters
        self.batch_size = iters[0].batch_size
        self._capacity = capacity
        self._queue = None
        self._thread = None
        self._stop = [False]  # one cell a generation of workers
        self._stale = []
        self._exhausted = False

    def _start(self):
        self._stale = _require_workers_dead(self._stale, "PrefetchingIter")
        self._queue = _queue.Queue(self._capacity)
        # a restart never un-stops a worker an earlier close gave up on:
        # each generation has its own stop cell
        stop = self._stop = [False]
        queue = self._queue

        def worker():
            while not stop[0]:
                try:
                    batches = [it.next() for it in self.iters]
                except StopIteration:
                    queue.put(None)
                    return
                except BaseException as e:  # raised again in next()
                    queue.put(_WorkerError(e))
                    return
                queue.put(batches)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="mx-prefetch")
        self._thread.start()

    def close(self):
        """Stop and join the worker, discarding queued batches
        (idempotent)."""
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop[0] = True
        self._stale = _drain_and_join((thread,), (self._queue,)) + \
            [t for t in self._stale if t.is_alive()]

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        return sum([it.provide_data for it in self.iters], [])

    @property
    def provide_label(self):
        return sum([it.provide_label for it in self.iters], [])

    def reset(self):
        self.close()
        self._stale = _require_workers_dead(self._stale, "PrefetchingIter")
        self._exhausted = False
        for it in self.iters:
            it.reset()

    def next(self):
        if self._exhausted:
            raise StopIteration
        if self._thread is None:
            self._start()
        # how long the loop blocked on the queue: near zero when the
        # pipeline keeps up, a step's time when the loop is input-bound
        t0 = time.perf_counter()
        batches = self._queue.get()
        telemetry.observe("io.wait_ms", 1e3 * (time.perf_counter() - t0))
        if batches is None or isinstance(batches, _WorkerError):
            self._exhausted = True
            self.close()
            if batches is not None:
                raise batches.error
            raise StopIteration
        if len(batches) == 1:
            return batches[0]
        return DataBatch(data=sum([b.data for b in batches], []),
                         label=sum([b.label for b in batches], []),
                         pad=batches[0].pad)


def device_prefetch_depth():
    """MXNET_DEVICE_PREFETCH: the queue depth of the training loops'
    device-staging layer (default 2; 0 copies each batch in the step)."""
    raw = os.environ.get("MXNET_DEVICE_PREFETCH", "2")
    try:
        depth = int(raw or 0)
    except ValueError:
        raise MXNetError(
            "MXNET_DEVICE_PREFETCH must be an integer queue depth, got %r"
            % raw)
    return max(depth, 0)


class PrefetchPlan:
    """Where a staged batch's slices go: the executor group's batch
    slices and contexts.  A staged batch carries the plan's `key`, and a
    group loads it in place only when the key is its own, so a stale plan
    falls back to the copy in the step."""

    def __init__(self, slices, contexts):
        self.slices = list(slices)
        self.contexts = list(contexts)
        self.key = (tuple((s.start, s.stop) for s in self.slices),
                    tuple(str(c) for c in self.contexts))


class DevicePrefetchIter(DataIter):
    """Stage host batches on their devices while the step before runs.

    A producer thread pulls batches from ``data_iter``; a stager thread
    cuts each into ``plan``'s per-device slices and copies them to their
    devices (pinned memory and a side stream on CUDA, with one event a
    device; plain copies on the CPU) and hangs them on the batch as
    ``device_parts``.  The batch keeps its host arrays for the host
    metric and callbacks.  Without a plan the batches pass through
    unstaged.  ``depth`` bounds both queues; `close()` is idempotent and
    joins the threads; `reset()` and `next()` revive a closed iterator."""

    def __init__(self, data_iter, plan=None, depth=None):
        super().__init__()
        self.data_iter = data_iter
        self.plan = plan
        self.batch_size = data_iter.batch_size
        if depth is None:
            depth = device_prefetch_depth()
        if depth <= 0:
            raise MXNetError(
                "DevicePrefetchIter needs depth >= 1; use the plain "
                "iterator (MXNET_DEVICE_PREFETCH=0) for the copy in the "
                "step")
        self._depth = depth
        self._last_return = None
        self._host_queue = None
        self._queue = None
        self._threads = ()
        self._stop = [False]  # one cell a generation of workers
        self._stale = []
        self._exhausted = False
        self._skip_stage = [0]  # see set_skip_staging
        self._streams = {}  # the stager's side stream a CUDA device

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def _side_stream(self, dev):
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(device=dev)
        return stream

    def _stage(self, batch):
        """Cut ``batch`` into the plan's slices on their devices (on the
        stager thread)."""
        plan = self.plan
        if plan is None:
            return batch
        devices = [c.torch_device() for c in plan.contexts]

        def shard(arrs):
            out = []
            for arr in arrs:
                src = arr.data if isinstance(arr, NDArray) else \
                    torch.as_tensor(np.asarray(arr))
                parts = []
                for s, ctx, dev in zip(plan.slices, plan.contexts, devices):
                    piece = src[s.start:s.stop]
                    if dev.type != "cuda":
                        parts.append(NDArray(piece.to(dev, copy=True), ctx))
                        continue
                    stream = self._side_stream(dev)
                    if piece.is_cuda:
                        # produced on another stream: copy after it
                        stream.wait_stream(
                            torch.cuda.current_stream(piece.device))
                        piece.record_stream(stream)
                    else:
                        piece = piece.pin_memory()
                    with torch.cuda.stream(stream):
                        parts.append(NDArray(piece.to(dev, non_blocking=True),
                                             ctx))
                out.append(parts)
            return out

        data, label = shard(batch.data), shard(batch.label)
        events = []
        for dev in devices:
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(self._side_stream(dev))
            events.append(event)
        batch.device_parts = {"key": plan.key, "data": data,
                              "label": label, "events": events}
        return batch

    def _start(self):
        self._stale = _require_workers_dead(self._stale,
                                            "DevicePrefetchIter")
        self._host_queue = _queue.Queue(self._depth)
        self._queue = _queue.Queue(self._depth)
        stop = self._stop = [False]
        host_queue, queue = self._host_queue, self._queue
        skip_stage = self._skip_stage

        def producer():
            while not stop[0]:
                try:
                    batch = self.data_iter.next()
                except StopIteration:
                    host_queue.put((None, None))
                    return
                except BaseException as e:  # raised again in next()
                    host_queue.put((e, None))
                    return
                host_queue.put((None, batch))

        def stager():
            while not stop[0]:
                try:
                    err, batch = host_queue.get(timeout=0.05)
                except _queue.Empty:
                    continue  # look at the stop flag again
                if err is not None or batch is None:
                    queue.put((err, None))
                    return
                if skip_stage[0] > 0:
                    # a resume's fast-forward discards this batch
                    skip_stage[0] -= 1
                    queue.put((None, batch))
                    continue
                try:
                    staged = self._stage(batch)
                except BaseException as e:  # raised again in next()
                    queue.put((e, None))
                    return
                queue.put((None, staged))

        self._threads = (
            threading.Thread(target=producer, daemon=True,
                             name="mx-device-prefetch-in"),
            threading.Thread(target=stager, daemon=True,
                             name="mx-device-prefetch-stage"))
        for t in self._threads:
            t.start()

    def close(self):
        """Stop and join both threads, discarding queued batches
        (idempotent)."""
        threads, self._threads = self._threads, ()
        if not threads:
            return
        self._stop[0] = True
        self._stale = _drain_and_join(
            threads, (self._host_queue, self._queue)) + \
            [t for t in self._stale if t.is_alive()]

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_skip_staging(self, n):
        """Deliver the next ``n`` batches unstaged: a resume consumes and
        discards them.  Call before the first `next()`."""
        self._skip_stage[0] = int(n)

    def reset(self):
        self.close()
        self._stale = _require_workers_dead(self._stale,
                                            "DevicePrefetchIter")
        self._exhausted = False
        self._last_return = None
        self._skip_stage[0] = 0
        self.data_iter.reset()

    def next(self):
        if self._exhausted:
            raise StopIteration
        if not self._threads:
            self._start()
        t0 = time.perf_counter()
        err, batch = self._queue.get()
        now = time.perf_counter()
        wait = now - t0
        telemetry.observe("io.device_wait_ms", 1e3 * wait)
        telemetry.set_gauge("io.prefetch_depth", self._queue.qsize())
        if self._last_return is not None:
            interval = now - self._last_return
            telemetry.set_gauge("io.input_wait_frac",
                                wait / interval if interval > 0 else 0.0)
        self._last_return = now
        if err is not None:
            self._exhausted = True
            self.close()
            raise err
        if batch is None:
            self._exhausted = True
            self.close()
            raise StopIteration
        return batch


def close_iter(data_iter):
    """Close a prefetching iterator from a training loop's ``finally``,
    so that no worker thread outlives ``fit``.  Only the prefetch layers
    are touched (they revive on reset); iterators that own resources,
    like ImageRecordIter's native loader, are left alone."""
    if isinstance(data_iter, (PrefetchingIter, DevicePrefetchIter)):
        try:
            data_iter.close()
        except Exception:
            logging.exception("close of %r failed", data_iter)


class ImageRecordIter(DataIter):
    """Batches from a recordio pack (reference `ImageRecordIter`,
    `src/io/iter_image_recordio.cc`): sharded reading via
    part_index/num_parts, multi-threaded decode, prefetching.

    Records are IRHeader + .npy or JPEG payloads (`recordio.pack_img`).
    The C++ threaded loader (`native/loader.cc`) reads, decodes and
    batches off the Python thread; JPEG batches stay uint8 HWC and become
    float NCHW on the device.  ``use_native=False`` (or payloads that are
    neither, such as PNG) takes the Python path, which decodes inline
    (PIL).  A JPEG pack where the native library was built without
    libjpeg raises.  Augmentation (`image.ImageAugmenter`) runs on the
    device of the context current when the iterator is made, and the
    batch stays there.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 part_index=0, num_parts=1, preprocess_threads=4,
                 prefetch_buffer=4, data_name="data",
                 label_name="softmax_label", use_native=None,
                 rand_crop=False, rand_mirror=False, mean_img=None,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, scale=1.0,
                 max_random_contrast=0.0, max_random_illumination=0.0,
                 record_shape=None,
                 # full ImageAugmentParam set (image_augmenter.h:29-54),
                 # handled by the on-device ImageAugmenter
                 max_rotate_angle=0, rotate=-1, max_shear_ratio=0.0,
                 max_random_scale=1.0, min_random_scale=1.0,
                 max_aspect_ratio=0.0, max_img_size=1e10, min_img_size=0.0,
                 random_h=0, random_s=0, random_l=0, fill_value=255,
                 crop_y_start=-1, crop_x_start=-1, max_crop_size=-1,
                 min_crop_size=-1, inter_method=1):
        super().__init__()
        self._handle = 0
        self._native = False
        self._ctx = current_context()  # where the batches live
        # remote URIs (a registered fetch hook, http://, file://) resolve
        # to a local file first — the dmlc::InputSplit remote-read role
        # (`iter_image_recordio.cc:105-126`)
        path_imgrec = recordio.resolve_uri(path_imgrec)
        self.batch_size = batch_size
        self._data_shape = tuple(int(x) for x in check_shape(data_shape))
        # records may be stored larger than data_shape (record_shape) so
        # random crops have margin: the reference's decode-then-crop flow
        self._record_shape = tuple(int(x) for x in check_shape(record_shape)) \
            if record_shape else self._data_shape
        self._augmenter = None
        aug_extra = dict(
            max_rotate_angle=max_rotate_angle, rotate=rotate,
            max_shear_ratio=max_shear_ratio,
            max_random_scale=max_random_scale,
            min_random_scale=min_random_scale,
            max_aspect_ratio=max_aspect_ratio, max_img_size=max_img_size,
            min_img_size=min_img_size, random_h=random_h,
            random_s=random_s, random_l=random_l, fill_value=fill_value,
            crop_y_start=crop_y_start, crop_x_start=crop_x_start,
            max_crop_size=max_crop_size, min_crop_size=min_crop_size,
            inter_method=inter_method)
        defaults = dict(
            max_rotate_angle=0, rotate=-1, max_shear_ratio=0.0,
            max_random_scale=1.0, min_random_scale=1.0,
            max_aspect_ratio=0.0, max_img_size=1e10, min_img_size=0.0,
            random_h=0, random_s=0, random_l=0, fill_value=255,
            crop_y_start=-1, crop_x_start=-1, max_crop_size=-1,
            min_crop_size=-1, inter_method=1)
        if (rand_crop or rand_mirror or mean_img is not None
                or any((mean_r, mean_g, mean_b))
                or scale != 1.0 or max_random_contrast
                or max_random_illumination
                or self._record_shape != self._data_shape
                or any(aug_extra[k] != defaults[k] for k in defaults)):
            from .image import ImageAugmenter

            mean_rgb = [mean_r, mean_g, mean_b] \
                if any((mean_r, mean_g, mean_b)) else None
            self._augmenter = ImageAugmenter(
                data_shape=self._data_shape, rand_crop=rand_crop,
                rand_mirror=rand_mirror,
                max_random_contrast=max_random_contrast,
                max_random_illumination=max_random_illumination,
                mean_img=mean_img, mean_rgb=mean_rgb, scale=scale,
                **aug_extra)
        self._sample_len = int(np.prod(self._record_shape))
        self._path = path_imgrec
        self._part_index = part_index
        self._num_parts = num_parts
        self._data_name = data_name
        self._label_name = label_name
        kinds = self._payload_kinds()
        kind = self._payload_kind(kinds)
        # decode failures (zero-filled samples) observed so far; surfaced
        # from the native loader's per-batch count so mixed/corrupt .rec
        # files don't silently train on zeros
        self.decode_failures = 0
        self._warned_decode_fail = False
        if use_native is None:
            use_native = kind in ("npy", "jpeg")
        self._native = bool(use_native)
        if self._native:
            import ctypes

            from . import _native

            self._lib = _native.lib()
            if "jpeg" in kinds and not _native.has_jpeg():
                raise MXNetError(
                    "ImageRecordIter: %s holds JPEG records and the native "
                    "library was built without libjpeg (jpeglib.h not "
                    "found); pass use_native=False to decode them with "
                    "PIL" % path_imgrec)
            # JPEG fast path: the C++ loader keeps batches uint8 HWC (no
            # host deinterleave/float widening, 4x smaller copies); the
            # device does layout+convert in _finish_hwc_u8
            self._native_u8 = (kind == "jpeg"
                               and self._record_shape[0] in (1, 3))
            opener = (self._lib.mxtpu_loader_open_u8 if self._native_u8
                      else self._lib.mxtpu_loader_open)
            self._handle = opener(
                path_imgrec.encode(), part_index, num_parts, batch_size,
                self._sample_len, preprocess_threads, prefetch_buffer)
            _native.check(self._handle != 0, "loader_open")
            if self._native_u8:
                c, h, w = self._record_shape
                self._data_buf = np.zeros((batch_size, h, w, c), np.uint8)
                self._data_ptr = self._data_buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8))
            else:
                self._data_buf = np.zeros(
                    (batch_size,) + self._record_shape, np.float32)
                self._data_ptr = self._data_buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float))
            self._label_buf = np.zeros((batch_size,), np.float32)
            self._label_ptr = self._label_buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
        else:
            self._native_u8 = False
            self._f = open(path_imgrec, "rb")
            self._f.seek(0, 2)
            fsize = self._f.tell()
            chunk = fsize // num_parts
            raw_begin = chunk * part_index
            self._end = fsize if part_index == num_parts - 1 \
                else chunk * (part_index + 1)
            self._begin = 0 if part_index == 0 \
                else self._resync(raw_begin, fsize)
            self._f.seek(self._begin)

    def _payload_kinds(self, sample=8):
        """The payload kinds ('npy' / 'jpeg' / 'other') of the first few
        records — not just the first, so a mixed-payload .rec (JPEG head,
        PNG tail) is caught up front."""
        kinds = set()
        try:
            with open(self._path, "rb") as f:
                for _ in range(sample):
                    head = f.read(8)
                    if len(head) < 8:
                        break
                    magic, lrec = struct.unpack("<II", head)
                    if magic != _MAGIC:
                        return {"other"}
                    ln = lrec & _LREC_MASK
                    payload = f.read(min(ln, 32))
                    body = payload[24:24 + 6]
                    if body[:6] == b"\x93NUMPY":
                        kinds.add("npy")
                    elif body[:3] == b"\xff\xd8\xff":
                        kinds.add("jpeg")
                    else:
                        return {"other"}
                    skip = ln - len(payload)
                    skip += (4 - ln % 4) % 4
                    f.seek(skip, 1)
        except OSError:
            return {"other"}
        return kinds

    def _payload_kind(self, kinds=None):
        """The sniffed kind of the pack.  The C++ loader handles .npy and
        JPEG (in float mode, per record); anything else (PNG) must take
        the Python/PIL path rather than silently zero-filling samples.  A
        mixed jpeg/npy file routes to the native float path ('npy'),
        which dispatches per record; any 'other' forces Python.  Deeper
        mixing is caught at run time by the loader's per-batch
        decode-failure count (`mxtpu_loader_last_failed`)."""
        if kinds is None:
            kinds = self._payload_kinds()
        if "other" in kinds or not kinds:
            return "other"
        if kinds == {"jpeg"}:
            return "jpeg"
        return "npy"  # npy, or mixed npy+jpeg: native float path

    @property
    def provide_data(self):
        return [(self._data_name, (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [(self._label_name, (self.batch_size,))]

    def _resync(self, pos, fsize):
        """Scan to the next record magic at 4-byte alignment (the byte-range
        shard boundary rule shared with `native/recordio.cc` Resync)."""
        magic = struct.pack("<I", _MAGIC)
        pos = (pos + 3) & ~3
        while pos + 8 <= fsize:
            self._f.seek(pos)
            head = self._f.read(8)
            if head[:4] == magic:
                ln = struct.unpack("<I", head[4:])[0] & _LREC_MASK
                if pos + 8 + ln <= fsize:
                    return pos
            pos += 4
        return fsize

    def _read_record(self):
        pos = self._f.tell()
        if pos >= self._end:
            return None
        head = self._f.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError("bad record magic in %s" % self._path)
        ln = lrec & _LREC_MASK
        buf = self._f.read(ln)
        pad = (4 - ln % 4) % 4
        if pad:
            self._f.read(pad)
        return buf

    def reset(self):
        if self._native:
            self._lib.mxtpu_loader_reset(self._handle)
        else:
            self._f.seek(self._begin)

    def next(self):
        self._ensure_mean()  # before any record is consumed for this batch
        if self._native:
            from . import _native

            nextfn = (self._lib.mxtpu_loader_next_u8 if self._native_u8
                      else self._lib.mxtpu_loader_next)
            n = nextfn(self._handle, self._data_ptr, self._label_ptr)
            _native.check(n >= 0, "loader_next")
            if n == 0:
                raise StopIteration
            failed = self._lib.mxtpu_loader_last_failed(self._handle)
            if failed > 0:
                self.decode_failures += failed
                if not self._warned_decode_fail:
                    self._warned_decode_fail = True
                    logging.warning(
                        "ImageRecordIter: %d sample(s) in this batch "
                        "failed to decode and were zero-filled (%s); "
                        "cumulative count in .decode_failures",
                        failed, _native.last_error())
            out = (self._finish_hwc_u8(self._data_buf) if self._native_u8
                   else self._finish(self._data_buf))
            return DataBatch(
                data=[out],
                label=[array(self._label_buf, ctx=self._ctx)],
                pad=self.batch_size - n,
                provide_data=self.provide_data,
                provide_label=self.provide_label,
            )
        # ---- pure-python path ----
        # Host does the minimum (JPEG/PNG decode to uint8 HWC); float
        # conversion, NCHW layout and augmentation run on the device in
        # `_finish_hwc_u8`, and staging uint8 moves 4x fewer bytes than f32.
        rs = self._record_shape
        rows, labels = [], []
        fast_u8 = True
        while len(rows) < self.batch_size:
            buf = self._read_record()
            if buf is None:
                break
            # force the channel count at decode (grayscale JPEGs in a color
            # dataset and vice versa, like the reference's cv2 iscolor)
            iscolor = 1 if rs[0] == 3 else (0 if rs[0] == 1 else -1)
            header, img = recordio.unpack_img(buf, iscolor=iscolor)
            img = np.asarray(img)
            if img.ndim == 2 and rs[0] == 1:
                img = img[:, :, None]  # grayscale HW -> HW1
            if img.dtype != np.uint8 or img.shape != (rs[1], rs[2], rs[0]):
                fast_u8 = False  # .npy float/CHW payload
            rows.append(img)
            labels.append(header.label)
        n = len(rows)
        if n == 0:
            raise StopIteration
        label = np.zeros((self.batch_size,), np.float32)
        label[:n] = labels
        if fast_u8:
            data = np.zeros((self.batch_size, rs[1], rs[2], rs[0]), np.uint8)
            for i, img in enumerate(rows):
                data[i] = img
            out = self._finish_hwc_u8(data)
        else:
            data = np.zeros((self.batch_size,) + rs, np.float32)
            for i, img in enumerate(rows):
                img = np.asarray(img, np.float32)
                if img.shape == (rs[1], rs[2], rs[0]) and img.shape != rs:
                    img = img.transpose(2, 0, 1)  # HWC -> CHW
                data[i] = img.reshape(rs)
            out = self._finish(data)
        return DataBatch(
            data=[out], label=[array(label, ctx=self._ctx)],
            pad=self.batch_size - n,
            provide_data=self.provide_data,
            provide_label=self.provide_label,
        )

    def _ensure_mean(self):
        """`iter_normalize.h` flow: mean_img named a file that doesn't
        exist — compute it with one raw pass over this iterator (augmenter
        suspended), cache to the file, then normalize with it."""
        if self._augmenter is None or not self._augmenter.needs_mean:
            return
        from .image import compute_mean_image

        aug, self._augmenter = self._augmenter, None
        try:
            mean = compute_mean_image(self)
        finally:
            self._augmenter = aug
        aug.set_mean(mean)

    def _finish(self, data):
        """The batch on the iterator's device, augmented there when an
        augmenter is set (no host round trip)."""
        if self._augmenter is None:
            # a copy: the loader reuses its buffer
            return array(data, ctx=self._ctx)
        with self._ctx:
            return NDArray(self._augmenter(data), self._ctx)

    def _finish_hwc_u8(self, data_u8):
        """Device-side tail of the uint8 decode paths: stage the uint8 HWC
        batch (4x smaller transfer than f32), then one permute + float
        conversion to NCHW on the device before the augmenter."""
        x = torch.as_tensor(data_u8).to(self._ctx.torch_device()).permute(
            0, 3, 1, 2).to(torch.float32,
                           memory_format=torch.contiguous_format)
        if self._augmenter is None:
            return NDArray(x, self._ctx)
        with self._ctx:
            return NDArray(self._augmenter(x), self._ctx)

    def close(self):
        """Release the native loader (its threads) or the pack's file."""
        if self._native and self._handle:
            self._lib.mxtpu_loader_close(self._handle)
            self._handle = 0
        elif not self._native and getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
