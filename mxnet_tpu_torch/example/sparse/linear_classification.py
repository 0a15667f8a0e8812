#!/usr/bin/env python
"""Sparse linear classification over LibSVM data: the port of
``example/sparse/linear_classification.py`` (reference
``example/sparse/linear_classification/``).

Logistic regression whose design matrix stays CSR end to end:
``io.LibSVMIter`` hands out ``CSRNDArray`` batches (their triple copied
to the device, never made dense), the score is ``sparse.dot(csr, w)``,
and the weight's gradient is the transposed sparse product, so the work
scales with the stored values, not the feature count. The same arguments
and defaults as the JAX example; ``--device`` picks the context, the card
by default, ``cpu`` for the host. Without ``--data`` (or when it is
missing) a synthetic planted-separator LibSVM file is written, as the JAX
example writes it. The path runs no hand-written kernel. Exit code 0
when the last epoch's log loss is below 0.7 of the first's.

Run:  python3 mxnet_tpu_torch/example/sparse/linear_classification.py
          [--epochs 12] [--data train.libsvm --feature-dim N]
          [--device gpu|cpu]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, nd  # noqa: E402
from mxnet_tpu_torch import io as mxio  # noqa: E402
from mxnet_tpu_torch.ndarray import sparse as mxs  # noqa: E402


def make_libsvm(path, num_samples, feature_dim, density, rs):
    """Synthetic planted-separator LibSVM file (the JAX example's)."""
    w_true = rs.randn(feature_dim)
    with open(path, "w") as f:
        for _ in range(num_samples):
            nnz = max(1, int(density * feature_dim))
            idx = np.sort(rs.choice(feature_dim, nnz, replace=False))
            val = rs.randn(nnz)
            label = 1.0 if float(val @ w_true[idx]) > 0 else 0.0
            f.write("%g %s\n" % (label, " ".join(
                "%d:%.4f" % (i, v) for i, v in zip(idx, val))))


class SparseLogReg:
    """The example's model and update: w (feature_dim, 1), b (1,), SGD
    with ``rescale_grad = 1 / batch_size``, one ``opt.update`` a
    parameter keeping the state it returns."""

    def __init__(self, feature_dim, lr, batch_size):
        self.w = nd.zeros((feature_dim, 1))
        self.b = nd.zeros((1,))
        self.w.attach_grad()
        self.b.attach_grad()
        self.opt = mx.optimizer.create("sgd", learning_rate=lr,
                                       rescale_grad=1.0 / batch_size)
        self.states = {i: self.opt.create_state(i, p)
                       for i, p in enumerate((self.w, self.b))}

    def step(self, batch):
        """One step on a ``LibSVMIter`` batch; the summed log loss (on the
        device, not read back)."""
        x = batch.data[0]            # CSRNDArray straight off the iter
        assert x.stype == "csr"
        y = batch.label[0].reshape((-1, 1))
        with autograd.record():
            score = mxs.dot(x, self.w) + self.b
            # logistic loss, numerically stable form
            loss = (mx.nd.relu(score) - score * y
                    + mx.nd.log(1 + mx.nd.exp(-mx.nd.abs(score)))).sum()
        loss.backward()
        for i, p in enumerate((self.w, self.b)):
            self.states[i] = self.opt.update(i, p, p.grad, self.states[i])
        return loss


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", default=None, help="LibSVM file (synthetic "
                    "data is generated when absent)")
    ap.add_argument("--feature-dim", type=int, default=2000)
    ap.add_argument("--num-samples", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--lr", type=float, default=3.0)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def run(args, max_steps=None):
    """Train as the JAX example's ``main``; ``max_steps`` stops early.
    Returns the readings (first and last epoch log loss, every step's
    loss, ms a step over the run and in each epoch, samples/s) with the
    model."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    rs = np.random.RandomState(7)
    path = args.data
    if not path or not os.path.exists(path):
        path = os.path.join(tempfile.mkdtemp(), "train.libsvm")
        make_libsvm(path, args.num_samples, args.feature_dim, 0.02, rs)
        print("generated synthetic LibSVM data at", path)
    with ctx:
        it = mxio.LibSVMIter(data_libsvm=path, data_shape=args.feature_dim,
                             batch_size=args.batch_size)
        model = SparseLogReg(args.feature_dim, args.lr, args.batch_size)
        epoch_loss, losses, epoch_ms, train_s = [], [], [], 0.0
        for epoch in range(args.epochs):
            it.reset()
            total, nb = 0.0, 0
            _sync(ctx)
            tic = time.perf_counter()
            for batch in it:
                loss = model.step(batch)
                losses.append(float(loss.asnumpy()))
                total += losses[-1] / args.batch_size
                nb += 1
                if max_steps is not None and len(losses) >= max_steps:
                    break
            _sync(ctx)
            epoch_ms.append(1e3 * (time.perf_counter() - tic) / nb)
            train_s += time.perf_counter() - tic
            epoch_loss.append(total / nb)
            print("epoch %2d  logloss %.4f" % (epoch, epoch_loss[-1]),
                  flush=True)
            if max_steps is not None and len(losses) >= max_steps:
                break
    first, last = epoch_loss[0], epoch_loss[-1]
    return {"first": first, "last": last, "improved": last < first * 0.7,
            "losses": losses, "steps": len(losses), "train_s": train_s,
            "step_ms": 1e3 * train_s / len(losses), "epoch_step_ms": epoch_ms,
            "samples_per_s": len(losses) * args.batch_size / train_s,
            "model": model, "iter": it}


def main(argv=None):
    res = run(parse_args(argv))
    print("logloss %.4f -> %.4f" % (res["first"], res["last"]))
    print("%.3f ms a step, %.0f samples/s" % (res["step_ms"],
                                              res["samples_per_s"]))
    print("IMPROVED" if res["improved"] else "NOT IMPROVED")
    return 0 if res["improved"] else 1


if __name__ == "__main__":
    sys.exit(main())
