#!/usr/bin/env python
"""Factorization-machine training on CSR data: the port of
``example/sparse/fm.py`` (reference ``tests/python/train/
test_sparse_fm.py``).

A degree-2 FM

    score(x) = <w1, x> + b + 0.5 * sum_f [ (x V)_f^2 - (x^2)(V^2)_f ]

fit by regression to a planted linear target on random CSR batches
(``cast_storage``), through ``sparse.dot(csr, dense)`` (its backward the
transposed product) and the squared-feature term, a CSR matrix built from
the batch's own components on the device. The same arguments and
defaults as the JAX example; ``--device`` picks the context, the card by
default, ``cpu`` for the host. The path runs no hand-written kernel.
Exit code 0 when the last epoch's MSE is below 0.8 of the first's.

Run:  python3 mxnet_tpu_torch/example/sparse/fm.py
          [--optimizer sgd|adam|adagrad] [--device gpu|cpu]
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
from mxnet_tpu_torch.ndarray import sparse as mxs  # noqa: E402


def make_data(num_samples, feature_dim, density, rs):
    """A random design matrix (density ``density``) and a planted linear
    target with noise (the JAX example's)."""
    mask = rs.rand(num_samples, feature_dim) < density
    x = (rs.randn(num_samples, feature_dim) * mask).astype(np.float32)
    w_true = rs.randn(feature_dim, 1).astype(np.float32)
    y = x @ w_true + 0.1 * rs.randn(num_samples, 1).astype(np.float32)
    return x, y.astype(np.float32)


def fm_forward(x_csr, w1, b, v):
    """The FM score of one CSR batch. x^2 shares x's pattern, so it is a
    CSR matrix of the squared stored values over x's indices (no host
    copy, no dense batch)."""
    xw = mxs.dot(x_csr, w1)                               # (n, 1)
    xv = mxs.dot(x_csr, v)                                # (n, f)
    x_sq = mx.nd.sparse.csr_matrix(
        (x_csr.data ** 2, x_csr.indices, x_csr.indptr), shape=x_csr.shape)
    v_sq = v * v                                          # dense (d, f)
    bd = mxs.dot(x_sq, v_sq)                              # (n, f)
    pairwise = 0.5 * ((xv * xv) - bd).sum(axis=1, keepdims=True)
    return xw + b + pairwise


class FM:
    """The example's parameters and optimizer (``opt.update`` a
    parameter, keeping the state it returns)."""

    def __init__(self, args, rs):
        self.w1 = nd.array(0.01 * rs.randn(args.feature_dim, 1)
                           .astype(np.float32))
        self.b = nd.zeros((1,))
        self.v = nd.array(0.01 * rs.randn(args.feature_dim,
                                          args.factor_size)
                          .astype(np.float32))
        self.params = (self.w1, self.b, self.v)
        for p in self.params:
            p.attach_grad()
        lr = {"sgd": 0.05, "adam": 0.02, "adagrad": 0.1}[args.optimizer]
        kw = {"momentum": 0.9} if args.optimizer == "sgd" else {}
        self.opt = mx.optimizer.create(args.optimizer, learning_rate=lr,
                                       clip_gradient=5.0,
                                       rescale_grad=1.0 / args.batch_size,
                                       **kw)
        self.states = {i: self.opt.create_state(i, p)
                       for i, p in enumerate(self.params)}

    def step(self, x_csr, y):
        """One step; the summed squared error (on the device)."""
        with autograd.record():
            pred = fm_forward(x_csr, self.w1, self.b, self.v)
            loss = ((pred - y) ** 2).sum()
        loss.backward()
        for i, p in enumerate(self.params):
            self.states[i] = self.opt.update(i, p, p.grad, self.states[i])
        return loss


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "adam", "adagrad"])
    ap.add_argument("--num-samples", type=int, default=320)
    ap.add_argument("--feature-dim", type=int, default=1000)
    ap.add_argument("--factor-size", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def run(args, max_steps=None):
    """Train as the JAX example's ``main``; ``max_steps`` stops early.
    Returns the readings (each epoch's MSE, every step's loss, ms a
    step over the run and in each epoch) with the model."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    rs = np.random.RandomState(42)
    x_np, y_np = make_data(args.num_samples, args.feature_dim, args.density,
                           rs)
    with ctx:
        model = FM(args, rs)
        nb = args.num_samples // args.batch_size
        batches = []
        for k in range(nb):
            sl = slice(k * args.batch_size, (k + 1) * args.batch_size)
            batches.append((mxs.cast_storage(nd.array(x_np[sl]), "csr"),
                            nd.array(y_np[sl])))
        mses, losses, epoch_ms, train_s = [], [], [], 0.0
        for epoch in range(args.epochs):
            tot = 0.0
            _sync(ctx)
            tic = time.perf_counter()
            for x_csr, y in batches:
                loss = model.step(x_csr, y)
                losses.append(float(loss.asnumpy()))
                tot += losses[-1] / args.batch_size
                if max_steps is not None and len(losses) >= max_steps:
                    break
            _sync(ctx)
            epoch_ms.append(1e3 * (time.perf_counter() - tic) / nb)
            train_s += time.perf_counter() - tic
            mses.append(tot / nb)
            print("epoch %2d  mse %.5f" % (epoch, mses[-1]), flush=True)
            if max_steps is not None and len(losses) >= max_steps:
                break
    return {"mse": mses, "improved": mses[-1] < mses[0] * 0.8,
            "losses": losses, "steps": len(losses), "train_s": train_s,
            "step_ms": 1e3 * train_s / len(losses), "epoch_step_ms": epoch_ms,
            "model": model, "batches": batches}


def main(argv=None):
    args = parse_args(argv)
    res = run(args)
    print("trained %d epochs in %.1fs — mse %.5f -> %.5f"
          % (args.epochs, res["train_s"], res["mse"][0], res["mse"][-1]))
    print("IMPROVED" if res["improved"] else "NOT IMPROVED")
    return 0 if res["improved"] else 1


if __name__ == "__main__":
    sys.exit(main())
