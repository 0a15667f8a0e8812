#!/usr/bin/env python
"""Word-level language model: the port of
``example/gluon/word_language_model/train.py`` (BASELINE workload 3).

The same model (Embedding -> dropout -> ``rnn.LSTM`` -> dropout -> Dense,
the decoder optionally tied to the embedding), corpus, truncated BPTT
(``detach``), ``clip_global_norm`` and SGD, with the same arguments and
defaults; ``--device`` picks the context, the card by default, ``cpu``
to run on the host. On the card the LSTM runs on cuDNN through torch
(the ``RNN`` op, ``ops/nn.py``); the path runs no hand-written kernel.

With no network access, ``--data`` may name any whitespace-tokenised
corpus (PTB's ptb.train.txt works unchanged); without it a deterministic
synthetic Zipf corpus keeps the example runnable end to end. The exit
code is 0 when the last epoch's validation perplexity is no worse than
the first's.

Run:  python3 mxnet_tpu_torch/example/gluon/word_language_model/train.py
          [--epochs 3] [--nhid 200] [--emsize 200] [--tied]
          [--device gpu|cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402
from mxnet_tpu_torch.gluon import Block, Trainer, nn, rnn  # noqa: E402
from mxnet_tpu_torch.gluon.utils import clip_global_norm  # noqa: E402


class RNNModel(Block):
    """Embedding -> LSTM -> (tied) decoder (reference model.py:RNNModel)."""

    def __init__(self, vocab_size, emsize, nhid, nlayers, dropout=0.2,
                 tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        self.nhid = nhid
        self.nlayers = nlayers
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(
                vocab_size, emsize,
                weight_initializer=mx.initializer.Uniform(0.1))
            self.rnn = rnn.LSTM(nhid, num_layers=nlayers, dropout=dropout,
                                input_size=emsize)
            if tie_weights:
                if nhid != emsize:
                    raise ValueError("tied weights need nhid == emsize")
                self.decoder = nn.Dense(vocab_size, in_units=nhid,
                                        params=self.encoder.params)
            else:
                self.decoder = nn.Dense(vocab_size, in_units=nhid)

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        decoded = self.decoder(output.reshape((-1, self.nhid)))
        return decoded, hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)


def load_corpus(path, synth_tokens=40000, synth_vocab=200):
    """Token ids + vocab size from a text file, or a synthetic Zipf
    corpus (``RandomState(1234)``, as the JAX example's)."""
    if path and os.path.isfile(path):
        with open(path) as f:
            words = f.read().replace("\n", " <eos> ").split()
        vocab = {}
        ids = np.empty(len(words), dtype=np.int32)
        for i, w in enumerate(words):
            ids[i] = vocab.setdefault(w, len(vocab))
        return ids, len(vocab)
    rs = np.random.RandomState(1234)
    # Zipf-ish unigram draws with a little bigram structure
    probs = 1.0 / np.arange(1, synth_vocab + 1)
    probs /= probs.sum()
    ids = rs.choice(synth_vocab, size=synth_tokens, p=probs).astype(np.int32)
    ids[1::2] = (ids[::2][: len(ids[1::2])] + 1) % synth_vocab
    return ids, synth_vocab


def batchify(ids, batch_size):
    """(steps, batch) token ids on the current context."""
    nbatch = len(ids) // batch_size
    data = ids[: nbatch * batch_size].reshape(batch_size, nbatch).T
    return mx.nd.array(data)


def detach(hidden):
    if isinstance(hidden, (list, tuple)):
        return [detach(h) for h in hidden]
    return hidden.detach()


def get_batch(source, i, bptt):
    seq_len = min(bptt, source.shape[0] - 1 - i)
    return source[i:i + seq_len], source[i + 1:i + 1 + seq_len].reshape(
        (-1,))


def train_step(model, trainer, loss_fn, data, target, hidden, clip,
               batch_size, bptt):
    """One truncated-BPTT step (reference train.py:131-169): forward and
    backward from the detached ``hidden``, the gradients clipped to
    ``clip * batch_size * bptt`` as a whole, an SGD step over the batch's
    tokens. Returns (the per-token losses, the next hidden state, the
    gradients' norm before clipping)."""
    hidden = detach(hidden)
    with autograd.record():
        output, hidden = model(data, hidden)
        loss = loss_fn(output, target)
    loss.backward()
    grads = [p.grad() for p in model.collect_params().values()
             if p.grad_req != "null"]
    norm = clip_global_norm(grads, clip * batch_size * bptt)
    trainer.step(data.shape[0] * data.shape[1])
    return loss, hidden, norm


def evaluate(model, loss_fn, source, batch_size, bptt):
    """The mean per-token loss over ``source``."""
    total, ntoks = 0.0, 0
    hidden = model.begin_state(func=mx.nd.zeros, batch_size=batch_size)
    for i in range(0, source.shape[0] - 1, bptt):
        data, target = get_batch(source, i, bptt)
        output, hidden = model(data, hidden)
        total += float(mx.nd.sum(loss_fn(output, target)).asnumpy())
        ntoks += target.shape[0]
    return total / max(1, ntoks)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", default=None, help="tokenized corpus file")
    parser.add_argument("--emsize", type=int, default=200)
    parser.add_argument("--nhid", type=int, default=200)
    parser.add_argument("--nlayers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1.0)
    parser.add_argument("--clip", type=float, default=0.25)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--bptt", type=int, default=35)
    parser.add_argument("--dropout", type=float, default=0.2)
    parser.add_argument("--tied", action="store_true")
    parser.add_argument("--log-interval", type=int, default=20)
    parser.add_argument("--synth-tokens", type=int, default=40000,
                        help="synthetic corpus size when --data is absent")
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                        help="the card (default) or the host")
    return parser.parse_args(argv)


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def run(args, corpus=None):
    """Train and validate as the example's ``main`` does; ``corpus`` is
    (ids, vocab size) to use instead of ``load_corpus``. Returns the
    run's readings as a dict, with the model, trainer, loss and training
    data to go on with."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        ids, vocab_size = corpus if corpus is not None else load_corpus(
            args.data, synth_tokens=args.synth_tokens)
        n_train = int(len(ids) * 0.9)
        train_data = batchify(ids[:n_train], args.batch_size)
        val_data = batchify(ids[n_train:], args.batch_size)
        print("corpus: %d tokens, vocab %d" % (len(ids), vocab_size))

        model = RNNModel(vocab_size, args.emsize, args.nhid, args.nlayers,
                         args.dropout, args.tied)
        model.initialize(mx.initializer.Xavier())
        trainer = Trainer(model.collect_params(), "sgd",
                          {"learning_rate": args.lr, "momentum": 0,
                           "wd": 0})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

        ppls, steps, train_s, ntoks_all = [], 0, 0.0, 0
        for epoch in range(args.epochs):
            total, ntoks = 0.0, 0
            hidden = model.begin_state(func=mx.nd.zeros,
                                       batch_size=args.batch_size)
            _sync(ctx)
            tic = time.perf_counter()
            for bi, i in enumerate(range(0, train_data.shape[0] - 1,
                                         args.bptt)):
                data, target = get_batch(train_data, i, args.bptt)
                loss, hidden, _ = train_step(
                    model, trainer, loss_fn, data, target, hidden,
                    args.clip, args.batch_size, args.bptt)
                total += float(mx.nd.sum(loss).asnumpy())
                ntoks += target.shape[0]
                if bi % args.log_interval == 0 and bi:
                    cur = total / ntoks
                    print("epoch %d batch %d loss %.3f ppl %.2f (%.1f tok/s)"
                          % (epoch, bi, cur, math.exp(min(cur, 20)),
                             ntoks / (time.perf_counter() - tic)))
                steps += 1
            _sync(ctx)
            train_s += time.perf_counter() - tic
            ntoks_all += ntoks
            val_loss = evaluate(model, loss_fn, val_data, args.batch_size,
                                args.bptt)
            ppls.append(math.exp(min(val_loss, 20)))
            print("[epoch %d] val loss %.3f val ppl %.2f"
                  % (epoch, val_loss, ppls[-1]), flush=True)
    return {"val_ppl": ppls, "steps": steps, "train_s": train_s,
            "tokens": ntoks_all, "tokens_per_s": ntoks_all / train_s,
            "step_ms": 1e3 * train_s / steps, "vocab": vocab_size,
            "ok": ppls[-1] <= ppls[0], "model": model, "trainer": trainer,
            "loss_fn": loss_fn, "train_data": train_data}


def main(argv=None):
    res = run(parse_args(argv))
    print("final val ppl %.2f (first %.2f)" % (res["val_ppl"][-1],
                                               res["val_ppl"][0]))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
