#!/usr/bin/env python
"""Multiclass SVM heads on MNIST-like data: the port of
``example/svm_mnist/svm_mnist.py`` (reference
``example/svm_mnist/svm_mnist.py``).

The same MLP (784-256-128-10) trained three ways, L2-SVM (gluon
``SquaredHingeLoss``), L1-SVM (``HingeLoss``) and softmax
(``SoftmaxCrossEntropyLoss``), by SGD with momentum, then tested. The
same arguments and defaults as the JAX example; ``--device`` picks the
context, the card by default, ``cpu`` for the host. The path runs no
hand-written kernel. Exit code 0 when every head's test accuracy passes
0.8.

Run:  python3 mxnet_tpu_torch/example/svm_mnist/svm_mnist.py
          [--epochs 2] [--device gpu|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, nd  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, loss as gloss, nn  # noqa: E402

KINDS = ("l2svm", "l1svm", "softmax")


def make_data(n, rs):
    """784-wide rows, class c lit in columns 70c..70c+70 (the JAX
    example's)."""
    y = rs.randint(0, 10, size=n)
    x = rs.rand(n, 784).astype(np.float32) * 0.1
    for i, c in enumerate(y):
        x[i, c * 70:(c + 1) * 70] += 0.7 + 0.2 * rs.rand()
    return x, y.astype(np.int32)


def one_hot_pm1(y, classes=10):
    """Hinge losses want +1/-1 targets (reference SVMOutput convention)."""
    t = -np.ones((len(y), classes), dtype=np.float32)
    t[np.arange(len(y)), y] = 1.0
    return t


def build_net():
    net = nn.HybridSequential()
    net.add(nn.Dense(256, activation="relu"),
            nn.Dense(128, activation="relu"),
            nn.Dense(10))
    return net


def build(kind):
    """The seeded net (Xavier), the head's loss and whether its labels
    are +1/-1, and the trainer."""
    net = build_net()
    net.initialize(mx.initializer.Xavier())
    if kind == "l2svm":
        lossfn, pm1 = gloss.SquaredHingeLoss(), True
    elif kind == "l1svm":
        lossfn, pm1 = gloss.HingeLoss(), True
    else:
        lossfn, pm1 = gloss.SoftmaxCrossEntropyLoss(), False
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5})
    return net, lossfn, pm1, trainer


def train_step(net, lossfn, trainer, data, label):
    with autograd.record():
        loss = lossfn(net(data), label)
    loss.backward()
    trainer.step(data.shape[0])
    return loss


def train_one(kind, xtr, ytr, xte, yte, epochs, batch, rs):
    net, lossfn, pm1, trainer = build(kind)
    for _ in range(epochs):
        perm = rs.permutation(len(xtr))
        for i in range(0, len(xtr), batch):
            idx = perm[i:i + batch]
            data = nd.array(xtr[idx])
            label = nd.array(one_hot_pm1(ytr[idx]) if pm1 else ytr[idx])
            train_step(net, lossfn, trainer, data, label)
    pred = net(nd.array(xte)).asnumpy().argmax(axis=1)
    return float((pred == yte).mean())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def run(args):
    """Train and test the three heads as the JAX example's ``main``."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    mx.random.seed(7)  # deterministic param init
    rs = np.random.RandomState(31)
    xtr, ytr = make_data(args.train_size, rs)
    xte, yte = make_data(512, rs)
    results = {}
    t0 = time.perf_counter()
    with ctx:
        for kind in KINDS:
            results[kind] = train_one(kind, xtr, ytr, xte, yte, args.epochs,
                                      args.batch_size, rs)
            print("%-8s test accuracy %.3f (%.1fs)"
                  % (kind, results[kind], time.perf_counter() - t0),
                  flush=True)
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())
    seconds = time.perf_counter() - t0
    steps = len(KINDS) * args.epochs * -(-args.train_size // args.batch_size)
    return {"accuracy": results, "ok": all(v > 0.8 for v in
                                           results.values()),
            "steps": steps, "seconds": seconds,
            "step_ms": 1e3 * seconds / steps}


def main(argv=None):
    res = run(parse_args(argv))
    print("svm heads %s" % ("ALL LEARNED" if res["ok"] else "failed"))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
