"""Data iterators: the port of ``mxnet_tpu/io.py``: ``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter`` (with its resume cursor),
``ResizeIter``, ``PrefetchingIter`` (threads), ``CSVIter``,
``MNISTIter`` (idx files, plain or ``.gz``), ``LibSVMIter`` (CSR
batches), ``ImageRecordIter`` (JPEG records, through
``image_pipeline.MPImageRecordIter``'s worker processes where it can),
``DevicePrefetchIter`` (the card's infeed) and the ``MXDataIter``
factory.

An iterator fixes its context when it is made (the current context, so
the card unless a ``with mx.cpu():`` scope asks for the host, and an
error without a card) and hands out batches there. Shuffling draws from
:func:`mx.random.np_rng`, as the JAX package does, so one seed gives the
same order in both. Iterators that can resume mid-epoch have
``state_dict()``/``set_state()``: the next batch after ``set_state`` is
the one an uninterrupted run would have given.
"""
from __future__ import annotations

import os
import queue as queue_mod
import sys
import threading
from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .ndarray import ndarray as nd_mod
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "LibSVMIter",
           "ImageRecordIter", "DevicePrefetchIter", "MXDataIter"]

_IO_RETRY = None
_T_PREFETCH = None


def _io_policy():
    """The prefetch retry policy: retries only an explicit
    ``TransientError`` (chaos faults are injected before a fetch moves
    anything; re-calling ``next()`` after the cursor moved would skip a
    sample), as the JAX package's."""
    global _IO_RETRY
    if _IO_RETRY is None:
        from . import resilience

        _IO_RETRY = resilience.RetryPolicy(
            retry_on=(resilience.TransientError,))
    return _IO_RETRY


def _prefetched(pipeline):
    """Count one batch staged ahead of the consumer
    (``mxnet_io_prefetch_batches_total``)."""
    global _T_PREFETCH
    if _T_PREFETCH is None:
        from . import telemetry

        _T_PREFETCH = telemetry.counter(
            "mxnet_io_prefetch_batches_total",
            "batches prefetched ahead of the consumer",
            labels=("pipeline",))
    _T_PREFETCH.inc(pipeline=pipeline)


def _fetch(it):
    """``next(it)`` under the io retry policy at the chaos site
    ``io.prefetch``."""
    from .resilience import chaos

    def attempt():
        chaos.maybe_fail("io.prefetch")
        return next(it)

    return _io_policy().call(attempt, site="io.prefetch")


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name + shape (+ dtype, layout) descriptor (reference io.py)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


class DataBatch(object):
    """One mini-batch (reference io.py:118)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise MXNetError("Data must be a list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise MXNetError("Label must be a list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad if pad is not None else 0
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        return "%s: data shapes: %s label shapes: %s" % (
            self.__class__.__name__, [d.shape for d in self.data],
            [x.shape for x in self.label] if self.label else None)


class DataIter(object):
    """Base iterator (reference io.py:182)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Input data as a list of (name, numpy array) (reference
    io.py:_init_data)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data must not be None")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not data and not allow_empty:
            raise MXNetError("data must not be empty")
        if len(data) == 1:
            data = OrderedDictItems([(default_name, data[0])])
        else:
            data = OrderedDictItems([("_%d_%s" % (i, default_name), d)
                                     for i, d in enumerate(data)])
    if isinstance(data, dict):
        data = OrderedDictItems(sorted(data.items()))
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data]


class OrderedDictItems(list):
    """The ``(name, array)`` pairs of an iterator's inputs, in order
    (``mxnet_tpu/io.py:172``): a list, so a list of pairs given as
    ``data`` is told apart from a list of arrays."""


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle and padding (reference
    io.py:NDArrayIter); ``last_batch_handle`` 'pad', 'discard' or
    'roll_over'."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._ctx = current_context()
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            from . import random as _random

            idx = np.arange(self.num_data)
            _random.np_rng().shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        if self.num_data < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size")
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, source):
        if self.cursor >= self.num_data:
            raise MXNetError("DataIter needs reset")
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            parts = [v[self.cursor:end] for _, v in source]
        else:  # pad by wrapping around
            pad = end - self.num_data
            parts = [np.concatenate([v[self.cursor:], v[:pad]], axis=0)
                     for _, v in source]
        # float64 becomes float32, as in the JAX package (no x64 there)
        return [nd_mod.array(p, ctx=self._ctx) for p in parts]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def hard_reset(self):
        """Back to the first batch, ignoring ``roll_over``."""
        self.cursor = -self.batch_size

    def state_dict(self):
        """The resume cursor. The shuffle (drawn once, at construction, from
        the seeded ``mx.random`` host stream) is not part of it: a resumed
        run makes the iterator again under the same seed."""
        return {"cursor": int(self.cursor)}

    def set_state(self, state):
        self.cursor = int(state["cursor"])


class ResizeIter(DataIter):
    """An iterator cut or stretched to ``size`` batches an epoch
    (reference io.py:ResizeIter): the base restarts when it runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Prefetch one batch ahead of each of one or more iterators, a
    thread each (reference io.py:349, iter_prefetcher.h).

    A transient fault of a base iterator (chaos site ``io.prefetch``) is
    retried; any other exception is kept and raised at the consumer's
    next ``next()``, after which the stream reads as ended until
    ``reset()``."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        if not self.n_iter:
            raise MXNetError("PrefetchingIter: no iterator")
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self._errors = [None for _ in range(self.n_iter)]
        self._failed = False
        self._delivered = 0  # batches handed to the consumer this pass

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = _fetch(self.iters[i])
                except StopIteration:
                    self.next_batch[i] = None
                except Exception as exc:  # noqa: BLE001 - raised at next()
                    self.next_batch[i] = None
                    self._errors[i] = exc
                if self.next_batch[i] is not None:
                    _prefetched("PrefetchingIter")
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True) for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in getattr(self, "data_taken", ()):
            e.set()
        for thread in getattr(self, "prefetch_threads", ()):
            thread.join(timeout=1)

    def _renamed(self, attr, renames):
        if renames is None:
            return sum([getattr(i, attr) for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in getattr(i, attr)]
                    for r, i in zip(renames, self.iters)], [])

    @property
    def provide_data(self):
        return self._renamed("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._renamed("provide_label", self.rename_label)

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        self._errors = [None for _ in range(self.n_iter)]
        self._failed = False
        self._delivered = 0
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        if self._failed:
            return False
        for e in self.data_ready:
            e.wait()
        errors = [e for e in self._errors if e is not None]
        if errors:
            self._errors = [None for _ in range(self.n_iter)]
            self._failed = True
            raise errors[0]
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("PrefetchingIter: the iterators hold "
                                 "different numbers of batches")
            return False
        if any(b.pad != self.next_batch[0].pad for b in self.next_batch):
            raise MXNetError("PrefetchingIter: different pad sizes in the "
                             "data batches")
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([b.label for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        self._delivered += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def state_dict(self):
        """The resume cursor: batches delivered to the consumer (a batch
        the threads read ahead was never trained on)."""
        return {"delivered": int(self._delivered)}

    def set_state(self, state):
        """Reset, then consume ``delivered`` batches through the normal
        path (skipping at the base would race the threads)."""
        self.reset()
        for _ in range(int(state.get("delivered", 0))):
            self.next()


class CSVIter(NDArrayIter):
    """CSV file iterator (reference src/io/iter_csv.cc): rows of
    ``data_csv`` shaped ``data_shape``, labels from ``label_csv``;
    ``round_batch`` pads the last batch, else it is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label.reshape(label.shape[0])
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard")


def _read_idx(path, header):
    """The payload of an idx file (``.gz`` by its name) after its
    big-endian header of ``header`` int32s, with the header."""
    import gzip
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fin:
        head = struct.unpack(">" + "I" * header, fin.read(4 * header))
        return head, fin.read()


class MNISTIter(NDArrayIter):
    """The MNIST idx-file iterator (reference src/io/iter_mnist.cc,
    ``mxnet_tpu/io.py:492-512``): images as float32 in [0, 1] shaped
    ``(n, 1, rows, cols)``, or ``(n, rows * cols)`` with ``flat``, or
    ``(n,) + input_shape``; labels as float32. ``shuffle`` draws from
    :func:`mx.random.np_rng` as ``NDArrayIter`` does (``seed`` and
    ``silent`` are taken and unused, as in the JAX package)."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=None, input_shape=None,
                 **kwargs):
        _, raw = _read_idx(label, 2)
        lab = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        (_, n, r, c), raw = _read_idx(image, 4)
        img = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) / 255.0
        img = img.reshape(n, 1, r, c)
        if flat:
            img = img.reshape(n, r * c)
        elif input_shape is not None:
            img = img.reshape((n,) + tuple(input_shape))
        super().__init__(img, lab, batch_size=batch_size, shuffle=shuffle)


def _parse_libsvm(path):
    """(first label of each row, row offsets, column ids, values) of a
    LibSVM text file: ``label[,label...] idx:value idx:value ...`` a
    line, blank lines skipped."""
    labels, indptr, indices, values = [], [0], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0].split(",")[0]))
            for tok in parts[1:]:
                k, _, v = tok.partition(":")
                indices.append(int(k))
                values.append(float(v))
            indptr.append(len(indices))
    return (np.asarray(labels, np.float32), np.asarray(indptr, np.int64),
            np.asarray(indices, np.int64), np.asarray(values, np.float32))


class LibSVMIter(DataIter):
    """Sparse batches of a LibSVM file (reference ``src/iter_libsvm.cc``,
    ``mxnet_tpu/io.py:633-735``): the data of a batch is a
    ``CSRNDArray`` of shape (rows, prod(data_shape)), its triple copied
    to the iterator's context once, never made dense; the label is the
    line's first label, or with ``label_libsvm`` the dense rows of a
    second LibSVM file (``label_shape`` wide, else its largest index + 1).
    ``round_batch`` fills the last batch from the first rows (its
    ``pad`` says how many); without it the last batch is short."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=None, round_batch=True,
                 data_name="data", label_name="softmax_label", **_ignored):
        super().__init__(batch_size)
        self._ctx = current_context()
        self.data_shape = (data_shape,) if isinstance(data_shape, int) \
            else tuple(data_shape)
        self.num_features = int(np.prod(self.data_shape))
        self.round_batch = round_batch
        self.data_name = data_name
        self.label_name = label_name
        labels, self._indptr, self._indices, self._values = \
            _parse_libsvm(data_libsvm)
        self.num_rows = len(labels)
        if label_libsvm:
            _, lptr, lidx, lval = _parse_libsvm(label_libsvm)
            if len(lptr) - 1 != self.num_rows:
                raise MXNetError("label_libsvm row count mismatch")
            counts = np.diff(lptr)
            width = int(np.prod(label_shape)) if label_shape else max(
                [int(lidx[e - 1]) + 1 if c else 1
                 for c, e in zip(counts, lptr[1:])])
            labels = np.zeros((self.num_rows, width), np.float32)
            labels[np.repeat(np.arange(self.num_rows), counts), lidx] = lval
        self._labels = labels
        self.cur = 0

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,
                                          self.num_features))]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._labels.ndim == 1 \
            else (self.batch_size, self._labels.shape[1])
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self.cur = 0

    def iter_next(self):
        return self.cur < self.num_rows

    def _rows(self, lo, hi):
        """The CSR triple of rows lo..hi, offsets from 0."""
        a, b = self._indptr[lo], self._indptr[hi]
        return (self._values[a:b], self._indices[a:b],
                self._indptr[lo:hi + 1] - a)

    def next(self):
        from .ndarray.sparse import CSRNDArray

        if self.cur >= self.num_rows:
            raise StopIteration
        end = min(self.cur + self.batch_size, self.num_rows)
        values, indices, indptr = self._rows(self.cur, end)
        labels = self._labels[self.cur:end]
        pad = self.batch_size - (end - self.cur)
        if pad and self.round_batch:
            wv, wi, wp = self._rows(0, pad)  # wrap, as the reference
            values = np.concatenate([values, wv])
            indices = np.concatenate([indices, wi])
            indptr = np.concatenate([indptr, wp[1:] + indptr[-1]])
            labels = np.concatenate([labels, self._labels[:pad]], axis=0)
        self.cur = end
        dev = self._ctx.torch_device()
        data = CSRNDArray(torch.from_numpy(values).to(dev),
                          torch.from_numpy(indices).to(dev),
                          torch.from_numpy(indptr).to(dev),
                          (len(indptr) - 1, self.num_features))
        return DataBatch([data], [nd_mod.array(labels, ctx=self._ctx)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)




def _spawnable() -> bool:
    """Spawned workers re-import ``__main__``: only a file can be."""
    return getattr(sys.modules.get("__main__"), "__file__", None) is not None


def ImageRecordIter(path_imgrec=None, data_shape=None, batch_size=128,
                    shuffle=False, preprocess_threads=4, prefetch_buffer=4,
                    label_width=1, **kwargs):
    """RecordIO image iterator (reference
    src/io/iter_image_recordio_2.cc:663), the JAX package's rule: where
    the ``.idx`` exists, more than one preprocess worker is asked for,
    ``__main__`` is a file (spawned workers re-import it) and no
    ``force_single_process`` is given, an
    :class:`~mxnet_tpu_torch.image_pipeline.MPImageRecordIter` of worker
    processes; otherwise one process decoding (``image.imdecode``) and
    resizing (``image.imresize``) every record to ``data_shape``, wrapped
    in a :class:`PrefetchingIter` when ``preprocess_threads`` and
    ``prefetch_buffer`` are set. Batches land on the current context; the
    codec is the one that context picks."""
    idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
    if preprocess_threads and preprocess_threads > 1 \
            and os.path.exists(idx_path) and _spawnable() \
            and not kwargs.pop("force_single_process", False):
        from .image_pipeline import MPImageRecordIter

        return MPImageRecordIter(
            path_imgrec=path_imgrec, data_shape=data_shape,
            batch_size=batch_size, shuffle=shuffle,
            label_width=label_width, preprocess_threads=preprocess_threads,
            prefetch_buffer=prefetch_buffer, **kwargs)
    it = _RecordIter(path_imgrec, data_shape, batch_size, shuffle,
                     label_width)
    if preprocess_threads and prefetch_buffer:
        return PrefetchingIter(it)
    return it


class _RecordIter(DataIter):
    """ImageRecordIter's single process: decode, resize to the data
    shape, batch; the last batch padded with its last image."""

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle,
                 label_width):
        from . import recordio

        from . import _imgcodec

        super().__init__(batch_size)
        self._ctx = current_context()
        self._lib = _imgcodec.use_library(self._ctx)  # the JPEG codec
        idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
        if os.path.exists(idx_path):
            self._rec = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = recordio.MXRecordIO(path_imgrec, "r")
            self._keys = None
        self._shuffle = shuffle
        self._label_width = label_width
        self._order = None
        self._pos = 0
        self.data_shape = tuple(data_shape)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        self._pos = 0
        if self._keys is not None:
            self._order = list(self._keys)
            if self._shuffle:
                from . import random as _random

                _random.np_rng().shuffle(self._order)
        else:
            self._rec.reset()

    def _read_one(self):
        from . import image as image_mod
        from . import recordio

        if self._keys is not None:
            if self._pos >= len(self._order):
                return None
            rec = self._rec.read_idx(self._order[self._pos])
            self._pos += 1
        else:
            rec = self._rec.read()
            if rec is None:
                return None
        header, img_bytes = recordio.unpack(rec)
        img = image_mod.decode_pixels(bytes(img_bytes), lib=self._lib)
        _, h, w = self.data_shape
        if img.shape[0] != h or img.shape[1] != w:
            img = image_mod.imresize(img, w, h).asnumpy()
        return img.transpose(2, 0, 1).astype(np.float32), header.label

    def next(self):
        datas, labels = [], []
        pad = 0
        while len(datas) < self.batch_size:
            one = self._read_one()
            if one is None:
                if not datas:
                    raise StopIteration
                pad = self.batch_size - len(datas)
                datas += [datas[-1]] * pad
                labels += [labels[-1]] * pad
                break
            datas.append(one[0])
            labels.append(one[1])
        return DataBatch(
            [nd_mod.array(np.stack(datas), ctx=self._ctx)],
            [nd_mod.array(np.asarray(labels, dtype=np.float32),
                          ctx=self._ctx)],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)

    def iter_next(self):
        try:
            self._next_cache = self.next()
            return True
        except StopIteration:
            return False


class DevicePrefetchIter(DataIter):
    """The card's infeed (the JAX package's ``DevicePrefetchIter``): a
    background thread takes the base iterator's batches and stages each
    array through pinned host memory to the target device on a side CUDA
    stream, ``depth`` batches ahead; ``next()`` makes the consumer's
    stream wait for the copy's event and records the tensors on that
    stream. An array already on the target device passes through
    untouched.

    ``sharding`` is None (this iterator's context), a context, a
    one-device mesh (``parallel.device_mesh``), or a callable ``ndim ->``
    one of these; a layout over more devices raises "not ported yet".
    An error of the base iterator is raised at the consumer's ``next()``;
    ``state_dict``/``set_state`` resume after the batches delivered."""

    def __init__(self, base_iter, ctx=None, depth=2, sharding=None):
        super().__init__(base_iter.batch_size)
        self.base = base_iter
        self.ctx = ctx or current_context()
        self._sharding = sharding
        self._depth = max(1, depth)
        self._queue = queue_mod.Queue(maxsize=self._depth)
        self._sentinel = object()
        self._thread = None
        self._stream = None
        self._done = False
        self._delivered = 0
        self._skip = 0
        self._start()

    @property
    def provide_data(self):
        return self.base.provide_data

    @property
    def provide_label(self):
        return self.base.provide_label

    def _target(self, ndim) -> torch.device:
        s = self._sharding
        if callable(s) and not isinstance(s, Context) \
                and not hasattr(s, "devices"):
            s = s(ndim)
        if s is None:
            return self.ctx.torch_device()
        if isinstance(s, Context):
            return s.torch_device()
        if isinstance(s, torch.device):
            return s
        devices = getattr(s, "devices", None)
        if devices is None:
            raise MXNetError("DevicePrefetchIter: sharding %r (a context or "
                             "a one-device mesh expected)" % (s,))
        devices = list(devices)
        if len(devices) != 1:
            raise MXNetError("DevicePrefetchIter: a layout over %d devices "
                             "is not ported yet" % len(devices))
        d = devices[0]
        return d.torch_device() if isinstance(d, Context) else \
            torch.device(d)

    def _stage(self, batch):
        """The batch with every array on its target; on the card the
        copies run on the side stream, and the event that follows them
        comes with the batch."""
        staged_any = []

        def put(arrs):
            out = []
            for a in arrs:
                if not isinstance(a, NDArray):
                    out.append(a)
                    continue
                t = a._data
                dev = self._target(t.dim())
                if t.device == dev or (dev.type == "cuda" and t.is_cuda
                                       and t.device.index == dev.index):
                    out.append(a)
                    continue
                if dev.type == "cuda":
                    if self._stream is None:
                        self._stream = torch.cuda.Stream(device=dev)
                    with torch.cuda.stream(self._stream):
                        host = t if t.is_pinned() else t.pin_memory()
                        moved = host.to(dev, non_blocking=True)
                    staged_any.append(moved)
                else:
                    moved = t.to(dev)
                out.append(NDArray(moved))
            return out

        staged = DataBatch(put(batch.data),
                           put(batch.label) if batch.label else batch.label,
                           pad=batch.pad, index=getattr(batch, "index", None),
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)
        event = None
        if staged_any:
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event, staged_any

    def _start(self):
        def worker():
            it = iter(self.base)
            try:
                skip, self._skip = self._skip, 0
                for _ in range(skip):  # resume: fetched, never staged
                    try:
                        _fetch(it)
                    except StopIteration:
                        break
                while True:
                    try:
                        batch = _fetch(it)
                    except StopIteration:
                        break
                    self._queue.put(self._stage(batch))
                    _prefetched("DevicePrefetchIter")
            except Exception as exc:  # noqa: BLE001 - raised at next()
                self._queue.put(exc)
                return
            self._queue.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="mxnet-device-infeed")
        self._thread.start()

    def _drain(self):
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                continue
        while not self._queue.empty():
            self._queue.get_nowait()

    def reset(self):
        self._drain()
        self.base.reset()
        self._done = False
        self._delivered = 0
        self._skip = 0
        self._start()

    def state_dict(self):
        """The resume cursor: batches delivered to the consumer."""
        return {"delivered": int(self._delivered)}

    def set_state(self, state):
        """Restart the base and skip ``delivered`` batches on the host
        (fetched, never copied to the device)."""
        self._drain()
        self.base.reset()
        self._done = False
        self._delivered = int(state.get("delivered", 0))
        self._skip = self._delivered
        self._start()

    def next(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._sentinel:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        batch, event, tensors = item
        if event is not None:
            consumer = torch.cuda.current_stream(tensors[0].device)
            consumer.wait_event(event)
            for t in tensors:
                t.record_stream(consumer)
        self._delivered += 1
        return batch

    def iter_next(self):
        try:
            self._cached = self.next()
            return True
        except StopIteration:
            return False


def MXDataIter(handle=None, **kwargs):  # noqa: N802 - reference name
    """The reference's C++-registered iterator wrapper as a factory by
    name: ``MXDataIter(name="ImageRecordIter", **params)`` (or the name as
    ``handle``)."""
    name = kwargs.pop("name", handle)
    factories = {
        "ImageRecordIter": ImageRecordIter,
        "MNISTIter": MNISTIter,
        "CSVIter": CSVIter,
        "LibSVMIter": LibSVMIter,
        "NDArrayIter": NDArrayIter,
    }
    if name not in factories:
        raise MXNetError("MXDataIter: unknown iterator %r (available: %s)"
                         % (name, sorted(factories)))
    return factories[name](**kwargs)
