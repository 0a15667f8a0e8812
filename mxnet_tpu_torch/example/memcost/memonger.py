#!/usr/bin/env python
"""Memory-cost engineering: where rematerialization saves memory, the port
of ``example/memcost/memonger.py`` (reference ``example/memcost``,
memonger's sublinear training memory).

Two findings, each reading stored against recomputed:

1. **Whole-graph remat** on the fused gluon ``TrainStep`` (a stack of
   ``depth`` Dense(width, relu) layers): ``TrainStep(remat=True)``
   against ``remat=False``, read by ``TrainStep.memory_analysis()``'s
   ``temp_size_in_bytes`` (on the card the step's peak above what was
   resident, on the host the bytes autograd saves).
2. **Scan-granular remat**: the deep stack as one ``_foreach`` scan,
   ``x -> tanh(x @ w_i)`` over stacked weights, loss ``mean(final^2)``,
   its gradient with respect to every weight with ``remat=True`` (each
   step checkpointed) against ``remat=False``: on the card the peak of
   ``torch.cuda.max_memory_allocated`` above what was resident (the
   statistics reset first), on the host the bytes autograd saves
   (``torch.autograd.graph.saved_tensors_hooks``, each storage once; the
   weights and the input left out). Both gradients must agree.

The JAX example reads XLA's compiled workspace, where per-step remat
shrinks the scan's live activations. In eager PyTorch this body keeps
nothing remat can drop: ``tanh`` saves its output, which is the next
step's carry, and the matrix product saves its inputs, the carry and a
view of the weights; a checkpointed step saves the same carry. So the
port predicts a ratio about 1.0. The JAX gate (a ratio above 1.3) is kept
and its verdict printed; the exit code follows it.

``--device`` picks the context (the card by default, ``cpu`` for the
host).

Run:  python3 mxnet_tpu_torch/example/memcost/memonger.py [--depth 32]
          [--width 256] [--batch-size 2048] [--device gpu|cpu]
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
from mxnet_tpu_torch import nd, parallel  # noqa: E402
from mxnet_tpu_torch.gluon import loss as gloss, nn  # noqa: E402
from mxnet_tpu_torch.ops.registry import get_op  # noqa: E402

MB = 2.0 ** 20


def trainstep_numbers(remat, depth, width, batch, ctx):
    """The fused gluon TrainStep's ``temp_size_in_bytes`` (finding 1)."""
    mx.random.seed(7)
    with ctx:
        net = nn.HybridSequential()
        for _ in range(depth):
            net.add(nn.Dense(width, activation="relu"))
        net.add(nn.Dense(10))
        net.initialize(mx.initializer.Xavier())
        x, y = nd.zeros((batch, width)), nd.zeros((batch,))
        net(x)
        step = parallel.TrainStep(
            net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
            parallel.device_mesh(1, devices=[ctx]),
            optimizer_params={"learning_rate": 0.1}, remat=remat)
        step(x, y).asnumpy()
    return step.memory_analysis().temp_size_in_bytes


def scan_numbers(remat, depth, width, batch, ctx):
    """Finding 2: ``(temp bytes, seconds, the gradient)`` of the
    ``_foreach`` scan's loss with respect to the stacked weights."""
    w_sym, x_sym = mx.sym.var("w_in"), mx.sym.var("x_in")
    sub = mx.sym.Group([mx.sym.tanh(mx.sym.dot(x_sym, w_sym))])
    op = get_op("_foreach")
    attrs = op.parse_attrs({
        "__subgraph__": sub, "data_names": ("w_in",),
        "state_names": ("x_in",), "free_names": (),
        "num_out_data": 0, "remat": remat})
    dev = ctx.torch_device()
    rs = np.random.RandomState(0)
    wstack = torch.from_numpy(rs.randn(depth, width, width).astype(
        np.float32) * 0.1).to(dev).requires_grad_(True)
    x0 = torch.from_numpy(rs.randn(batch, width).astype(np.float32)).to(dev)

    def grad():
        (final,) = op.fcompute(attrs, wstack, x0)
        return torch.autograd.grad((final * final).mean(), wstack)[0]

    grad()  # warm: the first call's one-time work is not the scan's
    t0 = time.perf_counter()
    g, temp = parallel._measure(dev, grad, [wstack, x0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return temp, time.perf_counter() - t0, g


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def main(argv=None):
    """Both findings; returns the readings (bytes, seconds, the ratio,
    the JAX gate's verdict and the gradients' largest difference)."""
    args = parse_args(argv)
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    print("== finding 1: whole-graph remat on the fused TrainStep")
    t_stored, t_remat = (trainstep_numbers(r, args.depth, args.width,
                                           args.batch_size, ctx)
                         for r in (False, True))
    print("  stored %.1f MB | remat %.1f MB" % (t_stored / MB,
                                                  t_remat / MB))
    print("== finding 2: scan-granular remat (_foreach remat=True)")
    s_stored, dt0, g0 = scan_numbers(False, args.depth, args.width,
                                     args.batch_size, ctx)
    s_remat, dt1, g1 = scan_numbers(True, args.depth, args.width,
                                    args.batch_size, ctx)
    ratio = s_stored / max(s_remat, 1)
    grad_diff = float((g0 - g1).abs().max())
    print("  stored %.1f MB (%.3fs) | remat %.1f MB (%.3fs) -> %.2fx "
          "smaller workspace; gradients within %.3g"
          % (s_stored / MB, dt0, s_remat / MB, dt1, ratio, grad_diff))
    sublinear = bool(ratio > 1.3)
    print("memonger %s" % ("SUBLINEAR" if sublinear else "no saving"))
    return {"trainstep_bytes": {"stored": t_stored, "remat": t_remat},
            "scan_bytes": {"stored": s_stored, "remat": s_remat},
            "scan_seconds": {"stored": dt0, "remat": dt1}, "ratio": ratio,
            "sublinear": sublinear, "grad_max_abs_diff": grad_diff}


if __name__ == "__main__":
    sys.exit(0 if main()["sublinear"] else 1)
