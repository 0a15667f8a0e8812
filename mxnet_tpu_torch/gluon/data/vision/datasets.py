"""Vision datasets: the port of
``mxnet_tpu/gluon/data/vision/datasets.py`` (``MNIST``,
``FashionMNIST``, ``CIFAR10``, ``CIFAR100``, ``ImageRecordDataset`` and
``ImageFolderDataset``).

Nothing is downloaded: each dataset reads the standard files under
``root`` (idx files, plain or ``.gz``; CIFAR's pickled batches; a
RecordIO file; class folders of PNG or ``.npy`` images), and a missing
file raises, as in the JAX package. With ``MXNET_TPU_FAKE_DATA=1`` a
missing MNIST or CIFAR set is synthesized from ``RandomState(42)``
instead, the same 1024 images and labels the JAX package makes. As
there, ``root`` is created when it does not exist.

Images are kept on the host (uint8 NDArrays of the CPU context, HWC)
and labels as numpy int32; a sample is ``(image, label)`` through the
optional ``transform(image, label)``. Decoding is the port's JPEG and
PNG codecs (``image.imread``/``imdecode``), the JPEG codec picked by the
current context.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ....base import MXNetError, get_env
from ....context import cpu
from ....ndarray import ndarray as nd_mod
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _fake_ok():
    return bool(get_env("MXNET_TPU_FAKE_DATA", 0, int, cache=False))


def _host_uint8(a):
    return nd_mod.array(a, ctx=cpu(), dtype="uint8")


def _fake(shape, classes):
    rng = np.random.RandomState(42)
    data = _host_uint8(rng.randint(0, 255, shape).astype(np.uint8))
    return data, rng.randint(0, classes, shape[0]).astype(np.int32)


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from its idx-ubyte files (``.gz`` or plain) under ``root``:
    images (28, 28, 1) uint8."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz",
                            "train-labels-idx1-ubyte.gz")
        self._test_data = ("t10k-images-idx3-ubyte.gz",
                           "t10k-labels-idx1-ubyte.gz")
        super().__init__(root, transform)

    def _get_data(self):
        data_file, label_file = self._train_data if self._train \
            else self._test_data
        data_path = os.path.join(self._root, data_file)
        label_path = os.path.join(self._root, label_file)
        if not os.path.exists(data_path):
            if os.path.exists(data_path[:-3]):
                data_path, label_path = data_path[:-3], label_path[:-3]
            elif _fake_ok():
                self._data, self._label = _fake((1024, 28, 28, 1), 10)
                return
            else:
                raise MXNetError(
                    "MNIST files not found under %s and downloads are "
                    "disabled. Set MXNET_TPU_FAKE_DATA=1 for synthetic "
                    "data." % self._root)
        opener = gzip.open if data_path.endswith(".gz") else open
        with opener(label_path, "rb") as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
        with opener(data_path, "rb") as fin:
            struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
        self._data = _host_uint8(data.reshape(len(label), 28, 28, 1))
        self._label = label


class FashionMNIST(MNIST):
    """FashionMNIST: MNIST's files under its own ``root``."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from its pickled batches under
    ``root/cifar-10-batches-py``: images (32, 32, 3) uint8."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            d = pickle.load(fin, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        label = np.asarray(d.get(b"labels", d.get(b"fine_labels")),
                           dtype=np.int32)
        return data, label

    def _get_data(self):
        batch_dir = os.path.join(self._root, "cifar-10-batches-py")
        if not os.path.isdir(batch_dir):
            if _fake_ok():
                self._data, self._label = _fake((1024, 32, 32, 3), 10)
                return
            raise MXNetError(
                "CIFAR10 batches not found under %s and downloads are "
                "disabled. Set MXNET_TPU_FAKE_DATA=1 for synthetic data."
                % self._root)
        files = ["data_batch_%d" % i for i in range(1, 6)] if self._train \
            else ["test_batch"]
        data, label = zip(*[self._read_batch(os.path.join(batch_dir, f))
                            for f in files])
        self._data = _host_uint8(np.concatenate(data))
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR100 from ``root/cifar-100-python``, coarse labels unless
    ``fine_label``."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _get_data(self):
        batch_dir = os.path.join(self._root, "cifar-100-python")
        if not os.path.isdir(batch_dir):
            if _fake_ok():
                self._data, self._label = _fake((1024, 32, 32, 3), 100)
                return
            raise MXNetError(
                "CIFAR100 batches not found under %s and downloads are "
                "disabled. Set MXNET_TPU_FAKE_DATA=1 for synthetic data."
                % self._root)
        with open(os.path.join(batch_dir, "train" if self._train
                               else "test"), "rb") as fin:
            d = pickle.load(fin, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = b"fine_labels" if self._fine_label else b"coarse_labels"
        self._data = _host_uint8(data)
        self._label = np.asarray(d[key], dtype=np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Images of a RecordIO file: each record's header label and its
    decoded image."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image, recordio

        header, img = recordio.unpack(super().__getitem__(idx))
        decoded = image.imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(decoded, header.label)
        return decoded, header.label


class ImageFolderDataset(Dataset):
    """Images in one folder per class (``root/<class>/<image>``): the
    class index is the folder's place in sorted order (``synsets``);
    ``.jpg``, ``.jpeg``, ``.png`` and ``.npy`` files, in sorted order."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((filename, label))

    def __getitem__(self, idx):
        from .... import image

        filename, label = self.items[idx]
        if filename.endswith(".npy"):
            img = nd_mod.array(np.load(filename), ctx=cpu())
        else:
            img = image.imread(filename, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
