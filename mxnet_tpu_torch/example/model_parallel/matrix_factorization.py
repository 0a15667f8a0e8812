#!/usr/bin/env python
"""Model-parallel matrix factorization through ``group2ctx``: the port of
``example/model-parallel/matrix_factorization.py`` (reference
``example/model-parallel/matrix_factorization/``).

The two embedding tables live in two ``ctx_group``s, ``embed_user`` and
``embed_item``, placed at bind time by ``group2ctx``: by default the user
table on the host (``cpu(0)``) and the item table on the card, MXNet's
pattern of keeping a table in host memory. The executor runs on
``--device`` (the card by default, ``cpu`` for the host); each tensor that
crosses between the groups' devices is copied at the edge, forward and
backward. ``--user-ctx``/``--item-ctx`` place each group on ``cpu`` or
the card (``gpu``); with ``--device cpu`` the groups are ``cpu(0)`` and
``cpu(1)``, as in the JAX example. The same synthetic low-rank ratings,
initial tables and SGD as the JAX example, from its seed. Prints the
same lines; exit code 0 when the last epoch's rmse is below the first's.

Run:  python3 mxnet_tpu_torch/example/model_parallel/matrix_factorization.py
          [--epochs 4] [--device gpu|cpu] [--user-ctx cpu|gpu]
          [--item-ctx cpu|gpu]
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


def build_symbol(factor_size):
    user = mx.sym.var("user")
    item = mx.sym.var("item")
    score = mx.sym.var("score")
    with mx.AttrScope(ctx_group="embed_user"):
        user_w = mx.sym.var("user_weight")
        u = mx.sym.Embedding(user, weight=user_w, input_dim=0,
                             output_dim=factor_size, name="user_embed")
    with mx.AttrScope(ctx_group="embed_item"):
        item_w = mx.sym.var("item_weight")
        i = mx.sym.Embedding(item, weight=item_w, input_dim=0,
                             output_dim=factor_size, name="item_embed")
    pred = mx.sym.sum(u * i, axis=1)
    return mx.sym.LinearRegressionOutput(pred, score, name="lro")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-users", type=int, default=200)
    ap.add_argument("--num-items", type=int, default=150)
    ap.add_argument("--factor-size", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the executor's context: the card (default) or "
                         "the host")
    ap.add_argument("--user-ctx", choices=("cpu", "gpu"), default="cpu",
                    help="where embed_user lives (default: the host)")
    ap.add_argument("--item-ctx", choices=("cpu", "gpu"), default=None,
                    help="where embed_item lives (default: the card, or "
                         "cpu(1) under --device cpu)")
    return ap.parse_args(argv)


def group2ctx(args):
    """The groups' contexts: ``cpu`` is ``cpu(0)`` for the users and
    ``cpu(1)`` for the items (the JAX example's pair), ``gpu`` the card."""
    item = args.item_ctx or ("gpu" if args.device == "gpu" else "cpu")
    return {"embed_user": mx.gpu(0) if args.user_ctx == "gpu"
            else mx.cpu(0),
            "embed_item": mx.gpu(0) if item == "gpu" else mx.cpu(1)}


def run(args):
    """Train as the JAX example's ``main``; returns the rmse of each epoch,
    the verdict, and the steps and seconds of the training loop."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    # synthetic low-rank ratings
    rs = np.random.RandomState(0)
    true_u = rs.randn(args.num_users, 4).astype(np.float32)
    true_i = rs.randn(args.num_items, 4).astype(np.float32)
    n = 4096
    users = rs.randint(0, args.num_users, n).astype(np.float32)
    items = rs.randint(0, args.num_items, n).astype(np.float32)
    scores = np.einsum("nd,nd->n", true_u[users.astype(int)],
                       true_i[items.astype(int)]).astype(np.float32)

    net = build_symbol(args.factor_size)
    with ctx:
        ex = net.simple_bind(ctx, grad_req="write",
                             group2ctx=group2ctx(args),
                             user=(args.batch_size,),
                             item=(args.batch_size,),
                             score=(args.batch_size,),
                             user_weight=(args.num_users, args.factor_size),
                             item_weight=(args.num_items, args.factor_size))
        for name, arr in ex.arg_dict.items():
            if name.endswith("weight"):
                arr[:] = rs.rand(*arr.shape).astype(np.float32) * 0.1

        rmses, steps, seconds = [], 0, 0.0
        for epoch in range(args.epochs):
            perm = rs.permutation(n)
            total, nb = 0.0, 0
            tic = time.time()
            for s in range(0, n - args.batch_size + 1, args.batch_size):
                idx = perm[s:s + args.batch_size]
                out = ex.forward(is_train=True,
                                 user=mx.nd.array(users[idx]),
                                 item=mx.nd.array(items[idx]),
                                 score=mx.nd.array(scores[idx]))[0]
                ex.backward()
                for name, grad in ex.grad_dict.items():
                    if name.endswith("weight"):
                        ex.arg_dict[name][:] = \
                            ex.arg_dict[name] - args.lr * grad
                total += float(np.mean((out.asnumpy() - scores[idx]) ** 2))
                nb += 1
            if ctx.device_type == "gpu":
                torch.cuda.synchronize(ctx.torch_device())
            secs = time.time() - tic
            rmse = float(np.sqrt(total / nb))
            rmses.append(rmse)
            steps += nb
            seconds += secs
            print("[epoch %d] rmse %.4f (%.0f samples/s)"
                  % (epoch, rmse, nb * args.batch_size / secs), flush=True)
    return {"rmse": rmses, "improved": rmses[-1] < rmses[0],
            "steps": steps, "seconds": seconds}


def main(argv=None):
    res = run(parse_args(argv))
    first, last = res["rmse"][0], res["rmse"][-1]
    print("rmse %.4f -> %.4f (%s)" % (first, last, "improved"
                                      if res["improved"] else
                                      "NOT improved"))
    return 0 if res["improved"] else 1


if __name__ == "__main__":
    sys.exit(main())
