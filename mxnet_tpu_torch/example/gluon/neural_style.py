#!/usr/bin/env python
"""Neural style transfer by input optimization: the port of
``example/gluon/neural_style.py`` (reference ``example/neural-style/``):
freeze a conv feature extractor, then optimize the INPUT image so its
deep features match a content image while its Gram matrices
(``nd.batch_dot``) match a style image. Gradients flow to the data, not
the weights, through ``attach_grad`` on the input and Adam.

The same flow, arguments and defaults: a randomly initialized extractor
and synthetic images (``RandomState(0)``), and the JAX example's
criterion (the trailing-5 mean loss below half the first). ``--device``
picks the context, the card by default, ``cpu`` to run on the host.

Run:  python3 mxnet_tpu_torch/example/gluon/neural_style.py [--iters 40]
          [--device gpu|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, nd  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402


def feature_net(channels=(16, 32, 64)):
    """A small VGG-style extractor giving its features at every scale."""
    blocks = []
    for ch in channels:
        seq = nn.HybridSequential(prefix="")
        seq.add(nn.Conv2D(ch, 3, padding=1, activation="relu"))
        seq.add(nn.Conv2D(ch, 3, padding=1, activation="relu"))
        seq.add(nn.MaxPool2D(2, 2))
        blocks.append(seq)
    net = nn.HybridSequential(prefix="style_")
    for b in blocks:
        net.add(b)
    return net, blocks


def gram(feat):
    b, c, h, w = feat.shape
    flat = feat.reshape((b, c, h * w))
    return mx.nd.batch_dot(flat, flat, transpose_b=True) / (c * h * w)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--style-weight", type=float, default=50.0)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def run(args):
    """Optimize the image as the JAX example's ``main`` does. Returns every
    iteration's loss and whether the run improved."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        rs = np.random.RandomState(0)
        net, blocks = feature_net()
        net.initialize(init=mx.initializer.Xavier())
        content = nd.array(rs.rand(1, 3, args.size, args.size)
                           .astype(np.float32))
        style = nd.array(rs.rand(1, 3, args.size, args.size)
                         .astype(np.float32))

        def features(x):
            outs = []
            h = x
            for b in blocks:
                h = b(h)
                outs.append(h)
            return outs

        with autograd.pause():
            content_feats = [f.detach() for f in features(content)]
            style_grams = [gram(f).detach() for f in features(style)]

        # the optimized variable is the IMAGE
        img = nd.array(rs.rand(1, 3, args.size, args.size)
                       .astype(np.float32))
        img.attach_grad()
        opt = mx.optimizer.create("adam", learning_rate=args.lr)
        state = opt.create_state(0, img)
        losses = []
        for it in range(args.iters):
            with autograd.record():
                feats = features(img)
                content_loss = ((feats[-1] - content_feats[-1]) ** 2).mean()
                style_loss = sum(((gram(f) - g) ** 2).sum()
                                 for f, g in zip(feats, style_grams))
                loss = content_loss + args.style_weight * style_loss
            loss.backward()
            state = opt.update(0, img, img.grad, state)
            img[:] = img.clip(0.0, 1.0)
            losses.append(float(loss.asnumpy()))
            if it % 10 == 0:
                print("iter %3d  loss %.3e (content %.3e style %.3e)"
                      % (it, losses[-1], float(content_loss.asnumpy()),
                         float(style_loss.asnumpy())))
    # the weighted style term is noisy iterate to iterate: judge on the
    # trailing-5 mean, not one final iterate
    last = sum(losses[-5:]) / len(losses[-5:])
    print("loss %.3e -> %.3e (trailing-5 avg)" % (losses[0], last))
    improved = last < losses[0] * 0.5
    print("IMPROVED" if improved else "NOT IMPROVED")
    return {"losses": losses, "improved": improved}


def main(argv=None):
    return 0 if run(parse_args(argv))["improved"] else 1


if __name__ == "__main__":
    sys.exit(main())
