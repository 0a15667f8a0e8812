"""Causal transformer LM (GPT-style) trained with the port's gluon stack:
the port of ``example/transformer/train_gpt.py``.

The same corpus, model and loop, with the same defaults (dim 64, 4
heads, 2 layers, ``SEQ`` 64, ``VOCAB`` 128, batch 32, Adam 3e-3, seeds
7 and 29): every ``Block`` runs its attention through the registered op
``_contrib_flash_attention``, which on the card launches the
hand-written CUDA flash-attention kernel (``ops/csrc/flash_attention.cu``)
and on the CPU runs its plain PyTorch version. ``--device`` picks the
context: the card by default, ``cpu`` to run on the host.

Run:  python -m mxnet_tpu_torch.example.transformer.train_gpt [--epochs 3]
      [--layers 2] [--device cpu]
"""
import argparse
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import Trainer, loss as gloss, nn

VOCAB = 128
SEQ = 64
PERIOD = 8


def make_corpus(n, rs):
    """Periodic-copy corpus: each stream repeats a random PERIOD-token
    motif (with 5% corruption); predicting token t means attending to
    t - PERIOD, an induction task a causal transformer learns fast."""
    motif = rs.randint(0, VOCAB, size=(n, PERIOD))
    reps = (SEQ + 1 + PERIOD - 1) // PERIOD
    x = np.tile(motif, (1, reps))[:, :SEQ + 1]
    corrupt = rs.rand(n, SEQ + 1) < 0.05
    x[corrupt] = rs.randint(0, VOCAB, size=int(corrupt.sum()))
    return x[:, :-1].astype(np.int32), x[:, 1:].astype(np.int32)


class Block(mx.gluon.HybridBlock):
    def __init__(self, dim, heads, **kw):
        super().__init__(**kw)
        self.dim, self.heads = dim, heads
        self.norm1 = nn.LayerNorm()
        self.qkv = nn.Dense(3 * dim, use_bias=False, flatten=False)
        self.proj = nn.Dense(dim, flatten=False)
        self.norm2 = nn.LayerNorm()
        self.mlp = nn.HybridSequential()
        self.mlp.add(nn.Dense(4 * dim, activation="relu", flatten=False),
                     nn.Dense(dim, flatten=False))

    def hybrid_forward(self, F, x):
        # pre-norm attention; the flash kernel wants (B, H, S, D)
        h = self.norm1(x)
        qkv = self.qkv(h)                                  # (b, s, 3d)
        q, k, v = (F.transpose(
            F.reshape(t, (0, 0, self.heads, -1)), (0, 2, 1, 3))
            for t in F.split(qkv, num_outputs=3, axis=2))
        att = F.invoke("_contrib_flash_attention", q, k, v, causal=True)
        att = F.reshape(F.transpose(att, (0, 2, 1, 3)), (0, 0, -1))
        x = x + self.proj(att)
        return x + self.mlp(self.norm2(x))


class GPT(mx.gluon.HybridBlock):
    def __init__(self, dim=64, heads=4, layers=2, **kw):
        super().__init__(**kw)
        self.tok = nn.Embedding(VOCAB, dim)
        self.pos = nn.Embedding(SEQ, dim)
        self.blocks = nn.HybridSequential()
        for _ in range(layers):
            self.blocks.add(Block(dim, heads))
        self.norm = nn.LayerNorm()
        self.head = nn.Dense(VOCAB, flatten=False)

    def hybrid_forward(self, F, tokens, positions):
        h = self.tok(tokens) + self.pos(positions)
        return self.head(self.norm(self.blocks(h)))   # (b, s, vocab)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def run(args):
    """Train and evaluate; returns the run's readings as a dict."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        mx.random.seed(7)  # deterministic param init
        rs = np.random.RandomState(29)
        xtr, ytr = make_corpus(args.train_size, rs)
        xte, yte = make_corpus(256, rs)
        pos_nd = nd.array(np.broadcast_to(
            np.arange(SEQ, dtype=np.int32), (args.batch_size, SEQ)).copy())

        net = GPT(layers=args.layers)
        net.initialize(mx.initializer.Xavier())
        lossfn = gloss.SoftmaxCrossEntropyLoss(axis=2)
        trainer = Trainer(net.collect_params(), "adam",
                          {"learning_rate": 3e-3})

        epoch_ppl = []
        steps = 0
        train_s = 0.0
        t0 = time.time()
        for epoch in range(args.epochs):
            perm = rs.permutation(len(xtr))
            tot, cnt = 0.0, 0
            _sync(ctx)
            te = time.perf_counter()
            for i in range(0, len(xtr) - args.batch_size + 1,
                           args.batch_size):
                idx = perm[i:i + args.batch_size]
                data, label = nd.array(xtr[idx]), nd.array(ytr[idx])
                with autograd.record():
                    loss = lossfn(net(data, pos_nd), label)
                loss.backward()
                trainer.step(1)
                tot += float(loss.mean().asscalar())
                cnt += 1
            _sync(ctx)
            train_s += time.perf_counter() - te
            steps += cnt
            epoch_ppl.append(float(np.exp(tot / cnt)))
            print("epoch %d train ppl %.1f (%.1fs)"
                  % (epoch, epoch_ppl[-1], time.time() - t0), flush=True)

        pos_te = np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                 (len(xte), SEQ)).copy()
        out = net(nd.array(xte), nd.array(pos_te))
        lp = nd.log_softmax(out, axis=2).asnumpy()
    nll = -np.take_along_axis(lp, yte[:, :, None].astype(np.int64),
                              axis=2).mean()
    test_ppl = float(np.exp(nll))
    return {"steps": steps, "train_s": train_s,
            "steps_per_s": steps / train_s,
            "tokens_per_s": steps * args.batch_size * SEQ / train_s,
            "epoch_train_ppl": epoch_ppl, "test_ppl": test_ppl,
            "uniform_ppl": float(VOCAB),
            "learned": test_ppl < 0.2 * VOCAB}


def main(argv=None):
    res = run(parse_args(argv))
    print("test ppl %.1f (uniform %.0f)" % (res["test_ppl"],
                                            res["uniform_ppl"]))
    print("transformer %s" % ("LEARNED" if res["learned"] else "failed"))
    return 0 if res["learned"] else 1


if __name__ == "__main__":
    sys.exit(main())
