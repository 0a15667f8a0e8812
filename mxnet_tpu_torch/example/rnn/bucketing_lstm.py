#!/usr/bin/env python
"""Bucketed LSTM sequence classifier: the port of
``example/rnn/bucketing_lstm.py`` (reference ``example/rnn/bucketing``).

Variable-length sequences are grouped into length buckets (8, 16, 24);
``BucketingModule`` binds one executor a bucket, every one over the
default bucket's parameter, gradient and auxiliary arrays
(``bind(shared_module=)``), so a switch between buckets copies nothing.
The model: ``Embedding`` -> ``transpose`` to (T, B, E) -> the ``RNN`` op
in LSTM mode (cuDNN through torch on the card, its step loop on the
host) -> ``SequenceLast`` -> ``FullyConnected`` -> ``SoftmaxOutput``;
SGD with momentum 0.9. The task: does a synthetic integer sequence
contain the token 7.

The JAX script's arguments and defaults; ``--device`` picks the context
(the card by default, ``cpu`` for the host). ``mx.random`` is seeded with
0 (the JAX script draws its Xavier weights unseeded). The path runs no
hand-written kernel. :func:`main` returns the readings; the exit code is
0 when the last epoch's accuracy beats the first's.

Run:  python3 mxnet_tpu_torch/example/rnn/bucketing_lstm.py
          [--epochs 20] [--device gpu|cpu]
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
from mxnet_tpu_torch.io import DataBatch, DataDesc  # noqa: E402

BUCKETS = [8, 16, 24]
VOCAB = 16


def sym_gen_factory(num_hidden, num_embed):
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=num_embed,
                                 name="embed")
        tbe = mx.sym.transpose(embed, axes=(1, 0, 2), name="tbe")
        rnn_out = mx.sym.RNN(tbe, state_size=num_hidden, num_layers=1,
                             mode="lstm", name="lstm")
        last = mx.sym.SequenceLast(rnn_out, name="last")
        fc = mx.sym.FullyConnected(last, num_hidden=2, name="fc")
        return (mx.sym.SoftmaxOutput(fc, label, name="softmax"), ("data",),
                ("softmax_label",))

    return sym_gen


def make_batches(n, batch_size, rs, ctx):
    """``n`` batches of sequences padded to their bucket's length (the JAX
    script's draws), their arrays on ``ctx``."""
    batches = []
    for _ in range(n):
        bucket = BUCKETS[rs.randint(len(BUCKETS))]
        length = rs.randint(bucket // 2 + 1, bucket + 1)
        seqs = rs.randint(1, VOCAB, (batch_size, bucket)).astype(np.float32)
        seqs[:, length:] = 0  # pad
        labels = (seqs == 7).any(axis=1).astype(np.float32)
        batches.append(DataBatch(
            data=[mx.nd.array(seqs, ctx=ctx)],
            label=[mx.nd.array(labels, ctx=ctx)],
            provide_data=[DataDesc("data", (batch_size, bucket))],
            provide_label=[DataDesc("softmax_label", (batch_size,))],
            bucket_key=bucket))
    return batches


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--num-hidden", type=int, default=32)
    ap.add_argument("--num-embed", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def build(args, ctx):
    """The bound, initialized bucketing module with its optimizer."""
    mod = mx.module.BucketingModule(
        sym_gen_factory(args.num_hidden, args.num_embed),
        default_bucket_key=max(BUCKETS), context=ctx)
    mod.bind(data_shapes=[("data", (args.batch_size, max(BUCKETS)))],
             label_shapes=[("softmax_label", (args.batch_size,))])
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": args.lr,
                                         "momentum": 0.9})
    return mod


def train_batch(mod, batch, metric):
    """The JAX script's loop body."""
    mod.forward_backward(batch)
    mod.update()
    mod.update_metric(metric, batch.label)


def main(argv=None):
    """Train; returns the readings: each epoch's accuracy, seconds and
    seq/s, ``improved``, the buckets bound, and the module."""
    args = parse_args(argv)
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    mx.random.seed(0)
    rs = np.random.RandomState(0)
    train = make_batches(40, args.batch_size, rs, ctx)
    mod = build(args, ctx)
    metric = mx.metric.Accuracy()
    accs, seconds = [], []
    for epoch in range(args.epochs):
        metric.reset()
        tic = time.perf_counter()
        for batch in train:
            train_batch(mod, batch, metric)
        acc = metric.get()[1]
        if ctx.device_type == "gpu":
            torch.cuda.synchronize(ctx.torch_device())
        seconds.append(time.perf_counter() - tic)
        accs.append(acc)
        print("[epoch %d] train-acc %.3f (%.1f seq/s, %d buckets bound)"
              % (epoch, acc, len(train) * args.batch_size / seconds[-1],
                 len(mod._buckets)), flush=True)
    improved = bool(accs[-1] > accs[0])
    print("accuracy %.3f -> %.3f (%s)" % (
        accs[0], accs[-1], "improved" if improved else "NOT improved"))
    return {"accuracy": accs, "seconds": seconds, "improved": improved,
            "buckets": sorted(mod._buckets), "batches": len(train),
            "seq_per_s": [len(train) * args.batch_size / s for s in seconds],
            "module": mod}


if __name__ == "__main__":
    sys.exit(0 if main()["improved"] else 1)
