"""Data iterators: the port of the part of ``mxnet_tpu/io.py`` the SSD,
MNIST and sparse paths use: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``MNISTIter`` (idx files, plain or ``.gz``) and
``LibSVMIter`` (CSR batches).

An iterator fixes its context when it is made (the current context, so
the card unless a ``with mx.cpu():`` scope asks for the host, and an
error without a card) and hands out batches there. Shuffling draws from
:func:`mx.random.np_rng`, as the JAX package does, so one seed gives the
same order in both. The prefetching, CSV and record iterators of the
JAX module are not ported yet: ``ImageRecordIter`` raises so.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError
from .context import current_context
from .ndarray import ndarray as nd_mod
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "LibSVMIter", "ImageRecordIter"]


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
            data = [(default_name, data[0])]
        else:
            data = [("_%d_%s" % (i, default_name), d)
                    for i, d in enumerate(data)]
    if isinstance(data, dict):
        data = sorted(data.items())
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data]


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


def ImageRecordIter(**kwargs):
    """The JAX package's RecordIO image iterator: not ported yet (it
    needs the JPEG decoder and ``image_pipeline.py``, ROADMAP queue 1,
    item 9); raises."""
    raise MXNetError("io.ImageRecordIter is not ported yet (JPEG decoding "
                     "and the image pipeline)")
