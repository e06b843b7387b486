"""Data iterators.

A port of `mxnet_tpu/io.py` (the reference's `include/mxnet/io.h`,
`src/io/`, `python/mxnet/io.py`): `DataBatch`, `DataIter`, `NDArrayIter`
(shuffle from numpy's global generator, which `random.seed` seeds;
last-batch ``pad``, ``discard`` and ``roll_over``), `CSVIter`,
and `MNISTIter` (idx files, ``part_index``/``num_parts`` sharding), the
same code over the port's NDArray.  Batches are
NDArrays on the CPU.

The training loop (`model._train_multi_device`) copies each batch to its
devices in the step, whatever ``MXNET_DEVICE_PREFETCH`` says: the JAX
package stages batch N+1 on the devices on a worker thread while step N
runs, which moves the same values, so both give the same numbers.
`ResizeIter`, `PrefetchingIter`, `DevicePrefetchIter` and
`ImageRecordIter` are not ported yet.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

from .base import MXNetError, check_shape
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "CSVIter", "MNISTIter"]


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
