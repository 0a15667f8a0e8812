#!/usr/bin/env python
"""DCGAN: the port of ``example/gluon/dcgan.py`` (reference
``example/gluon/dcgan.py``): adversarial training of two Gluon networks,
a transposed-conv generator against a strided-conv discriminator,
alternating SigmoidBCE updates through one autograd tape a player.

The same flow, arguments and defaults; ``--device`` picks the context,
the card by default, ``cpu`` to run on the host. Data: MNIST
(``gluon.data.vision.MNIST``, local files, or the synthetic set under
``MXNET_TPU_FAKE_DATA=1``), else the JAX example's synthetic blobs
(``RandomState(0)``). The run checks adversarial mechanics, as the JAX
one does: finite losses, and both players' parameters move every epoch.

Run:  python3 mxnet_tpu_torch/example/gluon/dcgan.py [--epochs 3]
          [--device gpu|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, nn  # noqa: E402


def build_generator(ngf=32, nz=64):
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        # nz x 1 x 1 -> 32 x 32
        net.add(nn.Conv2DTranspose(ngf * 4, 4, strides=1, padding=0,
                                   use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(ngf * 2, 4, strides=2, padding=1,
                                   use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(ngf, 4, strides=2, padding=1,
                                   use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2DTranspose(1, 4, strides=2, padding=1, use_bias=False),
                nn.Activation("tanh"))
    return net


def build_discriminator(ndf=32):
    net = nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, strides=2, padding=1, use_bias=False),
                nn.LeakyReLU(0.2),
                nn.Conv2D(ndf * 2, 4, strides=2, padding=1, use_bias=False),
                nn.BatchNorm(), nn.LeakyReLU(0.2),
                nn.Conv2D(ndf * 4, 4, strides=2, padding=1, use_bias=False),
                nn.BatchNorm(), nn.LeakyReLU(0.2),
                nn.Conv2D(1, 4, strides=1, padding=0, use_bias=False),
                nn.Flatten())
    return net


def load_images(n):
    """(n, 1, 32, 32) float32 images in [-1, 1]: MNIST padded to 32, or
    the synthetic blobs when MNIST is not there."""
    try:
        from mxnet_tpu_torch.gluon.data.vision import MNIST

        ds = MNIST(train=True)
        X = np.stack([np.asarray(ds[i][0]) for i in range(min(n, len(ds)))])
        X = X.reshape(-1, 1, 28, 28).astype(np.float32)
        X = np.pad(X, ((0, 0), (0, 0), (2, 2), (2, 2)))  # 32x32
    except Exception:
        rs = np.random.RandomState(0)
        X = np.zeros((n, 1, 32, 32), np.float32)
        for i in range(n):  # blobs with structure
            cx, cy = rs.randint(8, 24, 2)
            yy, xx = np.mgrid[0:32, 0:32]
            X[i, 0] = 255 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 30.0)
    return X / 127.5 - 1.0


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--nz", type=int, default=64)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--num-samples", type=int, default=512)
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                        help="the card (default) or the host")
    return parser.parse_args(argv)


def run(args):
    """Train as the JAX example's ``main`` does. Returns each step's mean
    discriminator and generator loss, the epochs' img/s and the sample
    range."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    with ctx:
        X = load_images(args.num_samples)
        print("training on %d images" % len(X))
        gen = build_generator(nz=args.nz)
        disc = build_discriminator()
        gen.initialize(mx.initializer.Normal(0.02))
        disc.initialize(mx.initializer.Normal(0.02))
        g_tr = Trainer(gen.collect_params(), "adam",
                       {"learning_rate": args.lr, "beta1": 0.5})
        d_tr = Trainer(disc.collect_params(), "adam",
                       {"learning_rate": args.lr, "beta1": 0.5})
        loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        rs = np.random.RandomState(1)
        B = args.batch_size
        ones, zeros = mx.nd.ones((B,)), mx.nd.zeros((B,))

        def param_snapshot(net):
            return {k: p.data().asnumpy().copy()
                    for k, p in net.collect_params().items()}

        gen(mx.nd.zeros((1, args.nz, 1, 1)))  # materialize deferred shapes
        disc(mx.nd.zeros((1, 1, 32, 32)))
        g_prev, d_prev = param_snapshot(gen), param_snapshot(disc)
        all_d, all_g, speeds = [], [], []
        for epoch in range(args.epochs):
            perm = rs.permutation(len(X))
            d_losses, g_losses, fooled = [], [], []
            tic = time.time()
            for s in range(0, len(X) - B + 1, B):
                real = mx.nd.array(X[perm[s:s + B]])
                noise = mx.nd.array(rs.randn(B, args.nz, 1, 1).astype(
                    np.float32))
                # D step: real -> 1, fake -> 0
                with autograd.record():
                    out_real = disc(real).reshape((-1,))
                    fake = gen(noise)
                    out_fake = disc(fake.detach()).reshape((-1,))
                    d_loss = loss_fn(out_real, ones) + loss_fn(out_fake,
                                                               zeros)
                d_loss.backward()
                d_tr.step(B)
                # G step: fake -> 1
                with autograd.record():
                    out = disc(gen(noise)).reshape((-1,))
                    g_loss = loss_fn(out, ones)
                g_loss.backward()
                g_tr.step(B)
                d_losses.append(float(mx.nd.mean(d_loss).asnumpy()))
                g_losses.append(float(mx.nd.mean(g_loss).asnumpy()))
                fooled.append(float((out.asnumpy() > 0).mean()))
            speeds.append(len(perm) // B * B / (time.time() - tic))
            print("[epoch %d] d_loss %.3f g_loss %.3f fool-rate %.2f "
                  "(%.1f img/s)" % (epoch, np.mean(d_losses),
                                    np.mean(g_losses),
                                    np.mean(fooled[-4:]), speeds[-1]))
            assert np.isfinite(d_losses).all() and \
                np.isfinite(g_losses).all()
            # both players must actually move every epoch
            g_now, d_now = param_snapshot(gen), param_snapshot(disc)
            g_delta = max(np.abs(g_now[k] - g_prev[k]).max() for k in g_now)
            d_delta = max(np.abs(d_now[k] - d_prev[k]).max() for k in d_now)
            assert g_delta > 0 and d_delta > 0, (g_delta, d_delta)
            g_prev, d_prev = g_now, d_now
            all_d += d_losses
            all_g += g_losses
        samples = gen(mx.nd.array(rs.randn(4, args.nz, 1, 1).astype(
            np.float32)))
        lo, hi = float(samples.min().asnumpy()), float(
            samples.max().asnumpy())
    print("adversarial mechanics OK; sample range [%.2f, %.2f]" % (lo, hi))
    return {"d_losses": all_d, "g_losses": all_g, "img_per_s": speeds,
            "sample_range": (lo, hi)}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
