#!/usr/bin/env python
"""ResNet training with Gluon hybridize: the port of
``example/gluon/train_resnet.py`` (BASELINE workload 2).

The same flow, arguments and defaults: a ``model_zoo.vision`` net with
Xavier weights (gaussian, fan-in, magnitude 2), ``hybridize()``, the
whole step (forward, softmax cross-entropy, backward, SGD with momentum
and weight decay) as one ``parallel.TrainStep`` over a one-device mesh,
``metric.Loss``, ``step.copy_to_net()``, and with ``--save-prefix`` an
``export`` of the trained net (``<prefix>-symbol.json`` and
``<prefix>-0000.params``). On the card the step is one CUDA graph a
batch; the path runs no hand-written kernel.

``--device`` picks the context, the card by default, ``cpu`` to run on
the host. ``--devices`` above 1 raises "not ported yet" (the port runs a
step on one device). With ``--rec`` the data is ``io.ImageRecordIter``
over that RecordIO file (its ``.idx`` beside it), called as the JAX
example calls it: worker processes decode each JPEG with the port's
codec, stretch it to ``--image-size`` with Pillow's bilinear resample
and hand the batch to the card in one pinned copy. Without it the data
is the JAX example's synthetic ImageNet-shaped set (``RandomState(0)``).

Run:  python3 mxnet_tpu_torch/example/gluon/train_resnet.py
          [--model resnet50_v1] [--batch-size 32] [--num-batches 50]
          [--rec train.rec] [--save-prefix PREFIX] [--device gpu|cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import MXNetError, gluon, parallel  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Gluon hybridized ResNet trainer (captured step)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", type=str, default="resnet50_v1",
                   help="any gluon.model_zoo.vision model name")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--devices", type=int, default=0,
                   help="devices in the dp mesh; 0 = the one device")
    p.add_argument("--num-batches", type=int, default=50,
                   help="batches per epoch for synthetic data")
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--mom", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--disp-batches", type=int, default=10)
    p.add_argument("--rec", type=str, default=None,
                   help="path to an ImageRecord .rec file")
    p.add_argument("--save-prefix", type=str, default=None,
                   help="export symbol+params here after training")
    p.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                   help="the card (default) or the host")
    return p.parse_args(argv)


def data_iter(args):
    if args.rec:
        return mx.io.ImageRecordIter(
            path_imgrec=args.rec, batch_size=args.batch_size,
            data_shape=(3, args.image_size, args.image_size), shuffle=True)
    rng = np.random.RandomState(0)
    x = rng.rand(args.batch_size * args.num_batches, 3, args.image_size,
                 args.image_size).astype(np.float32)
    y = rng.randint(0, args.num_classes,
                    args.batch_size * args.num_batches).astype(np.float32)
    return mx.io.NDArrayIter(x, y, args.batch_size, shuffle=False,
                             last_batch_handle="discard")


def _timed(it, wait_s):
    """The batches of ``it``, each one's wait appended to ``wait_s``."""
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        wait_s.append(time.perf_counter() - t0)
        yield batch


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def run(args):
    """Train (and export) as the JAX example's ``main`` does. Returns the
    readings: each batch's mean loss and wall seconds (the loss metric
    reads every loss back, so a batch's time is its step's), the seconds
    each batch was waited for (``wait_s``: the iterator's ``next``), the
    export's seconds, and the net and step to go on with."""
    if args.devices > 1:
        raise MXNetError("--devices %d is not ported yet: the port runs a "
                         "step on one device" % args.devices)
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        mesh = parallel.device_mesh(1, devices=[ctx])
        logging.info("training %s on %s", args.model, mesh.device)
        net = getattr(vision, args.model)(classes=args.num_classes)
        net.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2))
        net.hybridize()
        step = parallel.TrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", mesh,
            optimizer_params={"learning_rate": args.lr,
                              "momentum": args.mom, "wd": args.wd})
        metric = mx.metric.Loss()
        losses, step_s, wait_s = [], [], []
        for epoch in range(args.num_epochs):
            it = data_iter(args)
            tic = time.time()
            n_seen = 0
            for i, batch in enumerate(_timed(it, wait_s)):
                t0 = time.perf_counter()
                loss = step(batch.data[0], batch.label[0])
                metric.update(None, [loss])
                losses.append(float(loss.asnumpy()))
                step_s.append(time.perf_counter() - t0)
                n_seen += args.batch_size
                if (i + 1) % args.disp_batches == 0:
                    speed = n_seen / (time.time() - tic)
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec\tloss=%.4f", epoch, i + 1,
                                 speed, metric.get()[1])
                    metric.reset()
                    tic, n_seen = time.time(), 0
            logging.info("Epoch[%d] done", epoch)
            if hasattr(it, "close"):  # the record pipeline's workers
                it.close()
        step.copy_to_net()
        export_s = None
        if args.save_prefix:
            _sync(ctx)
            t0 = time.perf_counter()
            net.export(args.save_prefix)
            export_s = time.perf_counter() - t0
            logging.info("exported to %s-symbol.json / %s-0000.params",
                         args.save_prefix, args.save_prefix)
    return {"losses": losses, "step_s": step_s, "wait_s": wait_s,
            "export_s": export_s, "net": net, "step": step, "ctx": ctx}


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
