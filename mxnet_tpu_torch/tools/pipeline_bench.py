"""Input-pipeline throughput: the port of ``tools/pipeline_bench.py``.

Images a second out of the data pipeline against the train step's
consumption rate. Three numbers:

  1. the single-process ImageRecordIter (decode and resize on one
     thread), the old path;
  2. MPImageRecordIter with N worker processes, the throughput path
     (short side ``--side``, random crop ``--crop``, mirror);
  3. with ``--train MODEL``, the captured ``parallel.TrainStep``'s img/s
     on one device at the same batch and crop.

The verdict: the MP pipeline must give more img/s than the step takes.
The data set is ``--images`` seeded pattern images of ``--side`` square,
JPEG at quality 90, in a temporary directory. On the card (the default)
the JPEG codec is the host library; ``--device cpu`` runs everything on
the host with the plain codec.

Run:  python -m mxnet_tpu_torch.tools.pipeline_bench [--images 512]
          [--side 256] [--crop 224] [--batch-size 32] [--workers N]
          [--train resnet50_v1] [--device gpu|cpu]
Prints ONE JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def build_dataset(n, side, tmpdir):
    from mxnet_tpu_torch import recordio

    rec = os.path.join(tmpdir, "bench.rec")
    idx = os.path.join(tmpdir, "bench.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(0)
    # structured patterns compress like natural images (pure noise JPEGs
    # decode unrealistically slowly)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    for i in range(n):
        f1, f2 = rs.uniform(0.01, 0.1, 2)
        img = np.stack([
            127 + 120 * np.sin(f1 * xx + i),
            127 + 120 * np.cos(f2 * yy + 2 * i),
            127 + 120 * np.sin(f1 * xx + f2 * yy),
        ], axis=2).clip(0, 255).astype(np.uint8)
        hdr = recordio.IRHeader(0, float(i % 1000), i, 0)
        w.write_idx(i, recordio.pack_img(hdr, img, quality=90))
    w.close()
    return rec


def drain(it, seconds):
    """Pull batches for about ``seconds``: images a second."""
    n_img = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        try:
            batch = it.next()
        except StopIteration:
            it.reset()
            continue
        batch.data[0].asnumpy()  # the batch is complete where it lands
        n_img += batch.data[0].shape[0] - batch.pad
    return n_img / (time.perf_counter() - start)


def train_rate(batch_size, crop, model, seconds, ctx):
    import torch

    from mxnet_tpu_torch import gluon, nd, parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = getattr(vision, model)(classes=1000)
    net.initialize()
    mesh = parallel.device_mesh(1, devices=[ctx])
    step = parallel.TrainStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", mesh,
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    rs = np.random.RandomState(0)
    x = nd.array(rs.rand(batch_size, 3, crop, crop).astype(np.float32))
    y = nd.array(rs.randint(0, 1000, (batch_size,)))

    def sync():
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()

    step(x, y).asnumpy()  # capture
    sync()
    n = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        step(x, y)
        n += batch_size
    sync()
    return n / (time.perf_counter() - start)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--workers", type=int,
                    default=max(2, (os.cpu_count() or 4) // 2))
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--train", default=None,
                    help="also measure this model's train-step img/s "
                         "(e.g. resnet50_v1)")
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    return ap.parse_args(argv)


def run(args):
    """The benchmark's JSON object."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io as mxio
    from mxnet_tpu_torch.image_pipeline import MPImageRecordIter

    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx, tempfile.TemporaryDirectory() as tmpdir:
        rec = build_dataset(args.images, args.side, tmpdir)
        shape = (3, args.crop, args.crop)
        single = mxio.ImageRecordIter(
            path_imgrec=rec, data_shape=shape, batch_size=args.batch_size,
            preprocess_threads=0, prefetch_buffer=0)
        single_rate = drain(single, args.seconds)
        mp_it = MPImageRecordIter(
            rec, data_shape=shape, batch_size=args.batch_size,
            shuffle=True, rand_crop=True, rand_mirror=True,
            preprocess_threads=args.workers, prefetch_buffer=4)
        try:
            drain(mp_it, 2.0)  # the workers' start-up
            mp_rate = drain(mp_it, args.seconds)
        finally:
            mp_it.close()
        result = {
            "metric": "input pipeline img/s (mp, %d workers, %dpx->%d crop)"
                      % (args.workers, args.side, args.crop),
            "value": round(mp_rate, 1),
            "unit": "img/s",
            "vs_baseline": round(mp_rate / single_rate, 2),
            "extra": {
                "single_process_img_s": round(single_rate, 1),
                "speedup_vs_single": round(mp_rate / single_rate, 2),
                "batch": args.batch_size,
            },
        }
        if args.train:
            t = train_rate(args.batch_size, args.crop, args.train,
                           args.seconds, ctx)
            result["extra"]["train_step_img_s"] = round(t, 1)
            result["extra"]["pipeline_keeps_up"] = bool(mp_rate > t)
    return result


def main(argv=None):
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))
    sys.exit(main())
