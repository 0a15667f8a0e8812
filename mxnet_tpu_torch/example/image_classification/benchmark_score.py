"""Inference throughput across the vision model zoo: the port of
``example/image-classification/benchmark_score.py``, the script behind
BASELINE.md's inference tables.

For each network and batch size, img/s of the hybridized net's forward
(the port runs it eagerly, op by op: ``hybridize`` keeps the bits, see
``gluon/block.py``) on random weights and ``RandomState(0)`` data: one
probe call sizes the iteration count to the time budget, then a timed
loop, which ends in a synchronisation on the card. ``--dtype bfloat16``
casts the net with ``Block.cast`` after one float32 call has made its
parameters.

Run:  python -m mxnet_tpu_torch.example.image_classification.benchmark_score
          [--networks resnet50_v1,mobilenet1_0] [--batch-sizes 1,32]
          [--image-shape 3,224,224] [--dtype float32|bfloat16]
          [--seconds 5] [--device gpu|cpu]

Note: inception_v3 expects 3,299,299; pass it with --image-shape.
"""
import argparse
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon.model_zoo import vision

DEFAULT_NETS = ("resnet18_v1", "resnet50_v1", "mobilenet1_0",
                "densenet121", "inception_v3")


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def build(network, batch, shape, dtype, ctx, init=None):
    """The zoo's ``network`` (1000 classes) initialized on ``ctx`` (by
    ``init``, default the gluon default), cast to ``dtype`` and
    hybridized, and a ``(batch, *shape)`` input from ``RandomState(0)``:
    ``(net, x)``."""
    with ctx:
        net = getattr(vision, network)(classes=1000)
        net.initialize(init)
        x_np = np.random.RandomState(0).rand(batch, *shape).astype(
            np.float32)
        x = nd.array(x_np)
        if dtype == "bfloat16":
            with autograd.pause():
                net(x)  # makes the parameters before the cast
            net.cast("bfloat16")
            x = nd.NDArray(x._data.to(torch.bfloat16))
        net.hybridize()
    return net, x


def timed(fn, budget_s, ctx):
    """Runs ``fn()`` in a loop for about ``budget_s`` seconds: one probe
    call sizes the iteration count (between 3 and 1000; calls queue on
    the card, so an open loop would run far past the budget); returns
    ``(calls, seconds)``."""
    t0 = time.perf_counter()
    fn()
    _sync(ctx)
    probe = time.perf_counter() - t0
    iters = max(3, min(1000, int(budget_s / max(probe, 1e-6))))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(ctx)
    return iters, time.perf_counter() - t0


def score(network, batch, shape, dtype, budget_s, ctx=None):
    """img/s of ``network``'s inference forward at ``batch`` x ``shape`` in
    ``dtype`` over about ``budget_s`` seconds on ``ctx`` (default: the
    card)."""
    ctx = ctx or mx.gpu(0)
    net, x = build(network, batch, shape, dtype, ctx)
    return score_net(net, x, budget_s, ctx)


def score_net(net, x, budget_s, ctx):
    """img/s of ``net``'s inference forward on ``x`` (see :func:`score`)."""

    def forward():
        with autograd.pause():
            return net(x)

    forward()  # the first call (cuDNN picks its algorithms)
    _sync(ctx)
    iters, seconds = timed(forward, budget_s, ctx)
    return iters * x.shape[0] / seconds


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--networks", default=",".join(DEFAULT_NETS))
    ap.add_argument("--batch-sizes", default="1,32")
    ap.add_argument("--image-shape", default="3,224,224")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    shape = tuple(int(v) for v in args.image_shape.split(","))
    nets = [n.strip() for n in args.networks.split(",") if n.strip()]
    batches = [int(b) for b in args.batch_sizes.split(",")]

    print("network, batch, %s img/s" % args.dtype)
    for network in nets:
        for batch in batches:
            rate = score(network, batch, shape, args.dtype, args.seconds,
                         ctx=ctx)
            print("%s, %d, %.2f" % (network, batch, rate), flush=True)
    print("BENCHMARK_SCORE_DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
