"""Gluon datasets: the port of ``mxnet_tpu/gluon/data/dataset.py``
(``Dataset`` with ``filter``/``transform``/``transform_first``,
``SimpleDataset``, ``ArrayDataset`` and ``RecordFileDataset`` over the
port's ``recordio``).

A dataset hands out its samples where they are kept: an
``ArrayDataset`` of NDArrays indexes them on their own device (an array
made on the card gives card samples, one slice each), one of numpy
arrays gives numpy rows. ``DataLoader`` builds the batch and moves it
to its target device once (see ``dataloader.py``), so host-kept samples
cost one copy a batch.
"""
from __future__ import annotations

import os

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset(object):
    """Abstract dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([i for i in self if fn(i)])

    def transform(self, fn, lazy=True):
        """``fn`` on every sample (a tuple sample unpacked into its
        arguments), at each access when ``lazy``, else once now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([i for i in trans])

    def transform_first(self, fn, lazy=True):
        """``fn`` on the first element of every sample only."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Any list-like as a dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure(object):
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Equal-length arrays zipped: sample ``i`` is the tuple of their
    ``i``-th elements (the element alone for one array)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has length " \
                "%d while array[%d] has %d." % (self._length, i + 1,
                                                len(data))
            self._data.append(data if isinstance(data, Dataset)
                              else SimpleDataset(data))

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of a RecordIO file (``.rec`` beside its ``.idx``), as
    bytes, in the index's order."""

    def __init__(self, filename):
        from ... import recordio

        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
