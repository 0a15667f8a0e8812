#!/usr/bin/env python
"""Train MNIST with the Module API: the port of
``example/image-classification/train_mnist.py`` (BASELINE workload 1,
reference ``train_mnist.py:79,96``), through ``common/fit.py``'s
``Module.fit`` with a ``local`` kvstore, with the same arguments and
defaults (mlp, batch 64, 60,000 examples, 2 epochs, SGD lr 0.05,
momentum 0.9, wd 1e-4).

It reads the MNIST idx files (plain or ``.gz``) from ``--data-dir``
through ``io.MNISTIter`` when they are there; without them it trains on
the JAX example's synthetic MNIST-shaped set (10 class blobs around fixed
centres), so it runs with no network. ``--device`` picks the context: the
card by default, ``cpu`` for the host. The path runs no hand-written
kernel.

Run:  python3 mxnet_tpu_torch/example/image_classification/train_mnist.py
          [--network mlp|lenet] [--num-epochs 2] [--device gpu|cpu]
"""
import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.example.image_classification.common import fit  # noqa: E402,E501

MNIST_FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
               "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def _synthetic_mnist(n, seed):
    """MNIST-shaped synthetic data: 10 class blobs around fixed centres
    (shared by train and val, so validation means something)."""
    centers = np.random.RandomState(0).rand(10, 1, 28, 28).astype(np.float32)
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 10, n)
    img = centers[label] + 0.3 * rng.rand(n, 1, 28, 28).astype(np.float32)
    return img, label.astype(np.float32)


def get_mnist_iter(args, kv):
    """The MNIST iterators (reference train_mnist.py:get_mnist_iter), or
    the synthetic set's when the idx files are absent."""
    d = args.data_dir

    def find(name):
        for suffix in ("", ".gz"):
            p = os.path.join(d, name + suffix)
            if os.path.exists(p):
                return p
        return None

    paths = [find(f) for f in MNIST_FILES]
    if all(paths):
        train = mx.io.MNISTIter(image=paths[0], label=paths[1],
                                batch_size=args.batch_size, shuffle=True)
        val = mx.io.MNISTIter(image=paths[2], label=paths[3],
                              batch_size=args.batch_size, shuffle=False)
        return train, val
    logging.warning("MNIST files not found under %r; using synthetic data", d)
    n_train = args.num_examples
    train_img, train_lbl = _synthetic_mnist(n_train, seed=7)
    val_img, val_lbl = _synthetic_mnist(max(n_train // 6, args.batch_size),
                                        seed=8)
    train = mx.io.NDArrayIter(train_img, train_lbl, args.batch_size,
                              shuffle=True)
    val = mx.io.NDArrayIter(val_img, val_lbl, args.batch_size)
    return train, val


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train mnist",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--num-examples", type=int, default=60000)
    parser.add_argument("--data-dir", type=str, default="data")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                        help="the card (default) or the host")
    fit.add_fit_args(parser)
    parser.set_defaults(network="mlp", batch_size=64, disp_batches=100,
                        num_epochs=2, lr=0.05, lr_step_epochs="10")
    return parser.parse_args(argv)


def get_symbol(args):
    from importlib import import_module

    net = import_module("mxnet_tpu_torch.example.image_classification."
                        "symbols." + args.network)
    return net.get_symbol(**vars(args))


def main(argv=None):
    """Train as the example does, on ``--device``; returns the Module."""
    args = parse_args(argv)
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        return fit.fit(args, get_symbol(args), get_mnist_iter)


if __name__ == "__main__":
    main()
