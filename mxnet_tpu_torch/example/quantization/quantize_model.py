#!/usr/bin/env python
"""INT8 post-training quantization walkthrough: the port of
``example/quantization/quantize_model.py`` (reference
``example/quantization/imagenet_gen_qsym.py``): take a float model, run
calibration batches through it, emit the quantized symbol and params,
and compare int8 against float under each calibration mode.

The data is synthetic, with injected activation outliers: the regime
where ``calib_mode='entropy'`` (the KL-divergence threshold search)
beats ``'naive'`` min/max calibration. The same arguments, defaults and
printed lines as the JAX example; ``--device`` picks the context, the
card by default (the int8 layers run ``torch._int_mm`` there), ``cpu``
for the host. Exit code 0 when entropy calibration is no worse than
naive in both relative error and top-1 agreement (ENTROPY_BEATS_NAIVE).

Run:  python3 mxnet_tpu_torch/example/quantization/quantize_model.py
          [--num-calib 256] [--device gpu|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import io as mxio  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch.contrib import quantization as q  # noqa: E402


def build_float_model(rs, in_dim, hidden, classes):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=hidden, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    arg = {
        "fc1_weight": nd.array(rs.randn(hidden, in_dim).astype(np.float32)
                               * 0.2),
        "fc1_bias": nd.zeros((hidden,)),
        "fc2_weight": nd.array(rs.randn(classes, hidden).astype(np.float32)
                               * 0.2),
        "fc2_bias": nd.zeros((classes,)),
    }
    return net, arg


def forward(sym, args_dict, x, ctx):
    ex = sym.simple_bind(ctx, data=tuple(x.shape), grad_req="null")
    ex.copy_params_from(args_dict)
    ex.copy_params_from({"data": nd.array(x)})
    return ex.forward(is_train=False)[0].asnumpy()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-calib", type=int, default=256)
    ap.add_argument("--in-dim", type=int, default=32)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def run(args):
    """The three calibration modes, as the JAX example's ``main``:
    {mode: (relative error, top-1 agreement)} against the float net."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    rs = np.random.RandomState(0)
    with ctx:
        sym, arg = build_float_model(rs, args.in_dim, 64, 10)

        # a calibration stream with rare huge outliers, the KL regime: a
        # min/max range is dominated by the outliers while the KL
        # threshold clips them and keeps resolution on the bulk
        calib_x = rs.randn(args.num_calib, args.in_dim).astype(np.float32)
        calib_x[::32] *= 25.0

        x_test = rs.randn(128, args.in_dim).astype(np.float32)
        ref = forward(sym, arg, x_test, ctx)

        results = {}
        for mode in ("none", "naive", "entropy"):
            kw = {}
            if mode != "none":
                kw = {"calib_data": mxio.NDArrayIter(
                          calib_x, np.zeros(args.num_calib), batch_size=64),
                      "num_calib_examples": args.num_calib}
            qsym, qarg, _ = q.quantize_model(sym, arg, {}, calib_mode=mode,
                                             ctx=ctx, **kw)
            got = forward(qsym, qarg, x_test, ctx)
            err = np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-9)
            agree = float((got.argmax(1) == ref.argmax(1)).mean())
            results[mode] = (err, agree)
            print("calib_mode=%-7s relative-error %.4f  top1-agreement %.3f"
                  % (mode, err, agree), flush=True)
    return results


def main(argv=None):
    results = run(parse_args(argv))
    # the point of KL calibration: better than naive min/max when the
    # calibration stream carries outliers ('none' keeps per-batch dynamic
    # ranges and is the in-graph min/max upper bound)
    ok = (results["entropy"][1] >= results["naive"][1]
          and results["entropy"][0] <= results["naive"][0])
    print("ENTROPY_BEATS_NAIVE" if ok else "ENTROPY_NOT_BETTER")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
