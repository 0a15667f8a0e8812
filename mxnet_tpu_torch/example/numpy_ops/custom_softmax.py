"""Training through a numpy-implemented custom operator: the port of
``example/numpy-ops/custom_softmax.py`` (the reference's
``example/numpy-ops/custom_softmax.py``).

The final softmax and cross-entropy gradient of an MLP (784 -> 128 relu
-> 10) are written by hand in numpy as a ``CustomOp``: forward computes
the softmax, backward writes (prob - onehot) / n straight into the
logits' gradient (``need_top_grad=False``: the op is its own loss), and
the whole net still trains. The same synthetic data (class c lights up
pixels 70c .. 70c+69), the same seeds (``mx.random.seed(7)``,
``RandomState(19)``) and the same defaults (2 epochs, batch 64, 2048
samples, SGD lr 0.2 with momentum 0.9) as the JAX example.

On the card the gluon MLP runs there, and the op copies its logits to
the host and the results back: two round trips a step, the reference's
CustomOp contract. ``custom_softmax_rtc.py`` beside this file writes the
same op as two CUDA-C kernels compiled at run time.

Run:  python -m mxnet_tpu_torch.example.numpy_ops.custom_softmax
      [--epochs 2] [--device cpu]
"""
import argparse
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import Trainer, nn


@mx.operator.register("np_softmax_ce")
class NpSoftmaxCEProp(mx.operator.CustomOpProp):
    """Softmax forward; backward emits (prob - onehot)/n against the
    logits directly, ``need_top_grad=False`` like the reference example
    (the op is its own loss; the incoming gradient is an implicit 1)."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["prob"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return NpSoftmaxCE()


class NpSoftmaxCE(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        logits = in_data[0].asnumpy()
        z = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(z)
        self.assign(out_data[0], req[0], nd.array(e / e.sum(axis=1,
                                                            keepdims=True)))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        prob = out_data[0].asnumpy().copy()
        label = in_data[1].asnumpy().astype(np.int64)
        prob[np.arange(len(label)), label] -= 1.0
        self.assign(in_grad[0], req[0], nd.array(prob / len(label)))
        self.assign(in_grad[1], req[1], nd.zeros_like(in_data[1]))


def make_data(n, rs):
    y = rs.randint(0, 10, size=n)
    x = rs.rand(n, 784).astype(np.float32) * 0.1
    for i, c in enumerate(y):
        x[i, c * 70:(c + 1) * 70] += 0.7
    return x, y.astype(np.float32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def build():
    """The example's MLP (Xavier weights from the global seed) and its
    SGD trainer, in the current context."""
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"), nn.Dense(10))
    net.initialize(mx.initializer.Xavier())
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.2, "momentum": 0.9})
    return net, trainer


def train_step(net, trainer, x, y):
    """One step on host batch ``(x, y)``; returns the op's ``prob``."""
    data, label = nd.array(x), nd.array(y)
    with autograd.record():
        prob = nd.Custom(net(data), label, op_type="np_softmax_ce")
    prob.backward()  # the custom backward supplies the loss gradient
    trainer.step(1)  # backward already divides by the batch size
    return prob


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def run(args):
    """Train, then test; returns the run's readings."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        mx.random.seed(7)
        rs = np.random.RandomState(19)
        xtr, ytr = make_data(args.train_size, rs)
        xte, yte = make_data(512, rs)
        net, trainer = build()
        train_acc, steps, train_s = [], 0, 0.0
        for epoch in range(args.epochs):
            perm = rs.permutation(len(xtr))
            correct = 0
            _sync(ctx)
            tic = time.perf_counter()
            for i in range(0, len(xtr), args.batch_size):
                idx = perm[i:i + args.batch_size]
                prob = train_step(net, trainer, xtr[idx], ytr[idx])
                correct += int((prob.asnumpy().argmax(1) == ytr[idx]).sum())
                steps += 1
            _sync(ctx)
            train_s += time.perf_counter() - tic
            train_acc.append(correct / len(xtr))
            print("epoch %d train-acc %.3f (%.1fs)"
                  % (epoch, train_acc[-1], train_s), flush=True)
        prob = nd.Custom(net(nd.array(xte)), nd.array(yte),
                         op_type="np_softmax_ce")
        acc = float((prob.asnumpy().argmax(1) == yte).mean())
    return {"train_acc": train_acc, "test_acc": acc, "steps": steps,
            "train_s": train_s, "step_ms": 1e3 * train_s / steps,
            "learned": acc > 0.9}


def main(argv=None):
    res = run(parse_args(argv))
    print("test accuracy %.3f (through the numpy CustomOp)" % res["test_acc"])
    print("custom-op training %s" % ("LEARNED" if res["learned"]
                                     else "failed"))
    return 0 if res["learned"] else 1


if __name__ == "__main__":
    sys.exit(main())
