"""Data iterators: the port of the part of ``mxnet_tpu/io.py`` the SSD
and MNIST paths use: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter`` and ``MNISTIter`` (idx files, plain or ``.gz``).

An iterator fixes its context when it is made (the current context, so
the card unless a ``with mx.cpu():`` scope asks for the host, and an
error without a card) and hands out batches there. Shuffling draws from
:func:`mx.random.np_rng`, as the JAX package does, so one seed gives the
same order in both. The prefetching, CSV, LibSVM and record iterators
of the JAX module are not ported yet.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .base import MXNetError
from .context import current_context
from .ndarray import ndarray as nd_mod
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter"]


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
