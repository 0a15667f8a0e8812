#!/usr/bin/env python
"""LSTM + CTC sequence recognition (OCR-style): the port of
``example/ctc/lstm_ocr.py`` (reference ``example/ctc/lstm_ocr.py``,
captcha OCR with warpctc).

The columns of a synthetic 'image' go as a time series through a
bidirectional ``rnn.LSTM`` (cuDNN on the card) and a Dense head; gluon's
``CTCLoss`` (the ``CTCLoss`` op: the log-space alpha recursion over the
(B, 2L + 1) lattice, blank 0) aligns the unsegmented labels; decoding is
best path (argmax, collapse repeats, drop blanks). The same arguments and
defaults as the JAX example; ``--device`` picks the context, the card by
default, ``cpu`` for the host. The path runs no hand-written kernel.
Exit code 0 when the per-character test accuracy passes 0.5.

Run:  python3 mxnet_tpu_torch/example/ctc/lstm_ocr.py [--epochs 6]
          [--device gpu|cpu]
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
from mxnet_tpu_torch.gluon import Trainer, loss as gloss, nn, rnn  # noqa: E402,E501

NUM_CLASSES = 6        # blank=0 + digits 1..5
LABEL_LEN = 3
SEQ_LEN = 16           # image width = LSTM time steps
IMG_H = 12


def render(digits, rs):
    """Each digit takes about 4 columns with its own row band; noise
    everywhere (the JAX example's)."""
    img = rs.rand(SEQ_LEN, IMG_H).astype(np.float32) * 0.2
    for i, d in enumerate(digits):
        c0 = i * 5 + rs.randint(0, 2)
        rows = slice(2 * (d - 1), 2 * (d - 1) + 3)
        img[c0:c0 + 4, rows] += 0.8
    return np.clip(img, 0, 1)


def make_data(n, rs):
    y = rs.randint(1, NUM_CLASSES, size=(n, LABEL_LEN))
    x = np.stack([render(row, rs) for row in y])
    return x.astype(np.float32), y.astype(np.float32)


class OCRNet(mx.gluon.HybridBlock):
    def __init__(self, hidden=64, **kw):
        super().__init__(**kw)
        self.lstm = rnn.LSTM(hidden, num_layers=1, bidirectional=True,
                             layout="NTC")
        self.head = nn.Dense(NUM_CLASSES, flatten=False)

    def hybrid_forward(self, F, x):
        return self.head(self.lstm(x))      # (n, t, classes)


def best_path_decode(logits):
    """argmax per frame -> collapse repeats -> drop blanks (class 0)."""
    ids = logits.argmax(axis=2)
    out = []
    for row in ids:
        seq, prev = [], -1
        for t in row:
            if t != prev and t != 0:
                seq.append(int(t))
            prev = t
        out.append(seq)
    return out


def train_step(net, lossfn, trainer, data, label):
    """One step of the example's loop; the per-sample losses."""
    with autograd.record():
        loss = lossfn(net(data), label)
    loss.backward()
    trainer.step(data.shape[0])
    return loss


def build():
    """The seeded net (Xavier), its loss and its Adam trainer."""
    net = OCRNet()
    net.initialize(mx.initializer.Xavier())
    lossfn = gloss.CTCLoss(layout="NTC", label_layout="NT")
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 3e-3})
    return net, lossfn, trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--train-size", type=int, default=4096)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def run(args):
    """Train and test as the JAX example's ``main``; the readings."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    mx.random.seed(7)  # deterministic param init
    rs = np.random.RandomState(21)
    xtr, ytr = make_data(args.train_size, rs)
    xte, yte = make_data(256, rs)
    with ctx:
        net, lossfn, trainer = build()
        steps, train_s, epoch_loss, epoch_ms = 0, 0.0, [], []
        for epoch in range(args.epochs):
            perm = rs.permutation(len(xtr))
            tot = 0.0
            _sync(ctx)
            tic = time.perf_counter()
            for i in range(0, len(xtr), args.batch_size):
                idx = perm[i:i + args.batch_size]
                loss = train_step(net, lossfn, trainer, nd.array(xtr[idx]),
                                  nd.array(ytr[idx]))
                tot += float(loss.mean().asscalar()) * len(idx)
                steps += 1
            _sync(ctx)
            epoch_ms.append(1e3 * (time.perf_counter() - tic)
                            / -(-len(xtr) // args.batch_size))
            train_s += time.perf_counter() - tic
            epoch_loss.append(tot / len(xtr))
            print("epoch %d ctc-loss %.4f (%.1fs)"
                  % (epoch, epoch_loss[-1], train_s), flush=True)
        decoded = best_path_decode(net(nd.array(xte)).asnumpy())
    truth = [[int(v) for v in row] for row in yte]
    exact = float(np.mean([d == t for d, t in zip(decoded, truth)]))
    char_hits = float(np.mean([sum(a == b for a, b in zip(d, t)) / LABEL_LEN
                               for d, t in zip(decoded, truth)]))
    return {"loss": epoch_loss, "exact": exact, "per_char": char_hits,
            "ok": char_hits > 0.5, "steps": steps, "train_s": train_s,
            "step_ms": 1e3 * train_s / max(1, steps),
            "epoch_step_ms": epoch_ms, "net": net}


def main(argv=None):
    res = run(parse_args(argv))
    print("test: %.3f exact sequences, %.3f per-char"
          % (res["exact"], res["per_char"]))
    print("ocr %s" % ("LEARNED" if res["ok"] else "failed"))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
