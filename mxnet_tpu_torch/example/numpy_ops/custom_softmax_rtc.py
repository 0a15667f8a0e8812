"""A custom operator whose forward and backward are CUDA-C kernels
compiled at run time, trained with ``Module.fit``: the reference MXNet's
``example/numpy-ops/custom_softmax_rtc.py`` on the port.

The symbolic MLP ``FullyConnected(128)`` -> ``relu`` ->
``FullyConnected(10)`` -> ``Custom(op_type=...)`` over the data of
``custom_softmax.py``, through ``io.NDArrayIter``, trained by
``Module.fit`` (2 epochs, ``eval_metric="acc"``, ``Speedometer``, SGD lr
0.2 with momentum 0.9), then ``score`` and ``predict`` on the test set.
Two ops fit the same graph:

* ``rtc_softmax_ce`` (this file): a row softmax forward and the
  (prob - onehot) / n backward, written in CUDA-C (:data:`SOURCE`) and
  launched through ``rtc.CudaModule``; on a CPU tensor each runs its
  plain PyTorch version beside it. No host round trip on the card.
* ``np_softmax_ce`` (``custom_softmax.py``): the same op in numpy, two
  host round trips a step.

What bounds the two kernels: bytes (the forward reads the logits and
writes the probabilities; the backward reads the probabilities and the
labels and writes the gradient; a few operations an element). The
forward keeps each row in one block, with warp-shuffle reductions for
the row's max and sum; it passes over the row three times (max, sum,
write), the second and third mostly from cache.

Run:  python -m mxnet_tpu_torch.example.numpy_ops.custom_softmax_rtc
      [--device cpu] [--op np_softmax_ce]
"""
import argparse
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.example.numpy_ops import custom_softmax

SOURCE = r"""
__device__ __forceinline__ float warp_reduce(float v, bool is_max) {
    for (int o = 16; o > 0; o >>= 1) {
        float u = __shfl_xor_sync(0xffffffffu, v, o);
        v = is_max ? fmaxf(v, u) : v + u;
    }
    return v;
}

// the block's max or sum of v; blockDim.x a multiple of 32, at most 1024
__device__ float block_reduce(float v, bool is_max, float *smem) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int warps = blockDim.x >> 5;
    v = warp_reduce(v, is_max);
    if (lane == 0) smem[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < warps ? smem[lane]
                         : (is_max ? __int_as_float(0xff800000) : 0.0f);
        v = warp_reduce(v, is_max);
        if (lane == 0) smem[32] = v;
    }
    __syncthreads();
    return smem[32];
}

// y[r, :] = softmax(x[r, :]); one block per row
extern "C" __global__ void softmax_fwd(const float *__restrict__ x,
                                       float *__restrict__ y, int cols) {
    __shared__ float smem[33];
    const float *xr = x + (size_t)blockIdx.x * cols;
    float *yr = y + (size_t)blockIdx.x * cols;
    float m = __int_as_float(0xff800000);
    for (int j = threadIdx.x; j < cols; j += blockDim.x) m = fmaxf(m, xr[j]);
    m = block_reduce(m, true, smem);
    float s = 0.0f;
    for (int j = threadIdx.x; j < cols; j += blockDim.x) s += expf(xr[j] - m);
    __syncthreads();  // every thread has read smem[32] before it is reused
    s = block_reduce(s, false, smem);
    for (int j = threadIdx.x; j < cols; j += blockDim.x)
        yr[j] = expf(xr[j] - m) / s;
}

// dx[r, c] = (prob[r, c] - (c == label[r])) / rows
extern "C" __global__ void softmax_ce_bwd(const float *__restrict__ prob,
                                          const float *__restrict__ label,
                                          float *__restrict__ dx, int rows,
                                          int cols) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows * cols) return;
    int r = i / cols, c = i - r * cols;
    float g = prob[i] - (c == (int)label[r] ? 1.0f : 0.0f);
    dx[i] = g / (float)rows;
}
"""

FWD_SIGNATURE = "const float *x, float *y, int cols"
BWD_SIGNATURE = ("const float *prob, const float *label, float *dx, "
                 "int rows, int cols")
BWD_BLOCK = 256


def softmax_forward_plain(x):
    """The forward kernel's plain version: the numpy op's arithmetic."""
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    return e / e.sum(dim=1, keepdim=True)


def softmax_ce_backward_plain(prob, label):
    """The backward kernel's plain version: (prob - onehot) / rows."""
    g = prob.clone()
    g[torch.arange(len(label), device=prob.device), label.long()] -= 1.0
    return g / len(label)


def fwd_block(cols):
    """Threads per row of the forward: a multiple of 32, at most 256."""
    return 32 * ((min(cols, 256) + 31) // 32)


_KERNELS = {}


def kernels(device):
    """The (forward, backward) kernels on ``device``, compiled at their
    first use there; one module per device for the life of the
    process."""
    if device not in _KERNELS:
        with torch.cuda.device(device):
            mod = mx.rtc.CudaModule(SOURCE)
        _KERNELS[device] = (mod.get_kernel("softmax_fwd", FWD_SIGNATURE),
                            mod.get_kernel("softmax_ce_bwd", BWD_SIGNATURE))
    return _KERNELS[device]


def softmax_forward(x, y):
    """``y = softmax(x)`` by rows, on ``x``'s device: the forward kernel
    on the card (writing ``y`` in place), the plain version on the
    host."""
    if x._data.device.type != "cuda":
        y._data = softmax_forward_plain(x._data)
        return y
    rows, cols = x.shape
    fwd, _ = kernels(x._data.device)
    return fwd.launch((x, y, cols), grid_dims=(rows, 1, 1),
                      block_dims=(fwd_block(cols), 1, 1))


def softmax_ce_backward(prob, label, dx):
    """``dx = (prob - onehot(label)) / rows`` on ``prob``'s device."""
    if prob._data.device.type != "cuda":
        dx._data = softmax_ce_backward_plain(prob._data, label._data)
        return dx
    rows, cols = prob.shape
    _, bwd = kernels(prob._data.device)
    return bwd.launch((prob, label, dx, rows, cols),
                      grid_dims=((rows * cols + BWD_BLOCK - 1) // BWD_BLOCK,
                                 1, 1), block_dims=(BWD_BLOCK, 1, 1))


@mx.operator.register("rtc_softmax_ce")
class RtcSoftmaxCEProp(custom_softmax.NpSoftmaxCEProp):
    """The numpy op's interface, with CUDA-C kernels inside."""

    def create_operator(self, ctx, shapes, dtypes):
        return RtcSoftmaxCE()


class RtcSoftmaxCE(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        if req[0] not in ("write", "inplace"):
            raise mx.MXNetError("rtc_softmax_ce writes its output; req %r"
                                % req[0])
        softmax_forward(in_data[0], out_data[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        # in_grad[1], the label's, stays zero
        softmax_ce_backward(out_data[0], in_data[1], in_grad[0])


def get_symbol(op_type):
    data = sym.var("data")
    label = sym.var("softmax_label")
    fc1 = sym.FullyConnected(data, num_hidden=128, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=10, name="fc2")
    return sym.Custom(fc2, label, op_type=op_type, name="softmax")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--train-size", type=int, default=2048)
    ap.add_argument("--op", choices=("rtc_softmax_ce", "np_softmax_ce"),
                    default="rtc_softmax_ce")
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="the card (default) or the host")
    return ap.parse_args(argv)


def run(args):
    """Fit, score and predict with ``args.op``; returns the readings,
    among them the outputs and weights after the first batch."""
    ctx = mx.gpu(0) if args.device == "gpu" else mx.cpu()
    first = {}

    def capture(param):
        if param.epoch == 0 and param.nbatch == 0:
            first["prob"] = mod.get_outputs()[0].asnumpy()
            arg_params, _ = mod.get_params()
            first["params"] = {k: v.asnumpy() for k, v in arg_params.items()}
            custom_softmax._sync(ctx)
            first["tic"] = time.perf_counter()

    with ctx:
        mx.random.seed(7)
        rs = np.random.RandomState(19)
        xtr, ytr = custom_softmax.make_data(args.train_size, rs)
        xte, yte = custom_softmax.make_data(512, rs)
        train = mx.io.NDArrayIter(xtr, ytr, args.batch_size, shuffle=True)
        test = mx.io.NDArrayIter(xte, yte, args.batch_size)
        mod = mx.module.Module(get_symbol(args.op), context=ctx)
        mod.fit(train, eval_metric="acc", optimizer="sgd",
                optimizer_params={"learning_rate": 0.2, "momentum": 0.9,
                                  "rescale_grad": 1.0},
                initializer=mx.initializer.Xavier(), num_epoch=args.epochs,
                batch_end_callback=[mx.callback.Speedometer(
                    args.batch_size, 16), capture])
        custom_softmax._sync(ctx)
        # the steady state: from the end of the first batch (bind, the
        # first step and one-time imports before it) to the end of fit
        steady_s = time.perf_counter() - first.pop("tic")
        score = dict(mod.score(test, "acc"))["accuracy"]
        pred = mod.predict(test).asnumpy()
    batches = args.epochs * ((len(xtr) + args.batch_size - 1)
                             // args.batch_size)
    arg_params, _ = mod.get_params()
    return {"op": args.op, "score": score, "pred": pred,
            "pred_acc": float((pred.argmax(1) == yte).mean()),
            "first": first, "train_batches": batches,
            "test_batches": (len(xte) + args.batch_size - 1)
            // args.batch_size, "step_ms": 1e3 * steady_s / (batches - 1),
            "params": {k: v.asnumpy() for k, v in arg_params.items()},
            "learned": score > 0.9}


def main(argv=None):
    res = run(parse_args(argv))
    print("%s: test accuracy %.3f (score), %.3f (predict), %.3f ms/step"
          % (res["op"], res["score"], res["pred_acc"], res["step_ms"]))
    print("custom-op training %s" % ("LEARNED" if res["learned"]
                                     else "failed"))
    return 0 if res["learned"] else 1


if __name__ == "__main__":
    sys.exit(main())
