"""The runtime-compilation spec in CUDA-C: the kernels of the JAX
package's ``tests/test_rtc.py`` (axpy, a grid over rows, two outputs)
written for ``rtc.CudaModule``, and the cases the reference's
``tests/python/gpu/test_rtc.py`` adds (by-value scalars over a grid of
blocks, a template kernel exported by its C++ name, 64 KiB of dynamic
shared memory), each with its plain PyTorch version.

:func:`cases` gives each case's kernel, signature, inputs, output
shapes and launch geometry; a runner builds the arrays on the card,
launches, and holds the outputs against ``plain(*inputs)``.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["SOURCE", "EXPORTS", "Case", "cases", "axpy_plain",
           "axpy_n_plain", "scale_rows_plain", "split_sign_plain",
           "relu_plain", "reverse_plain", "SMEM_FLOATS", "launch_case"]

#: floats the shared-memory case stages: 64 KiB, above the 48 KiB a
#: launch may use without opting in
SMEM_FLOATS = 16384

SOURCE = r"""
#include <cuda_fp16.h>

// out = a[0] * x + y, one element per thread of one block
extern "C" __global__ void axpy(const float *a, const float *x,
                                const float *y, float *out) {
    int i = threadIdx.x;
    out[i] = a[0] * x[i] + y[i];
}

// out = alpha * x + y over a grid of blocks, scalars by value
extern "C" __global__ void axpy_n(float alpha, const float *x,
                                  const float *y, float *out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = alpha * x[i] + y[i];
}

// block b scales row b by b + 1: the grid wiring through blockIdx
extern "C" __global__ void scale_rows(const float *x, float *out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    out[i] = x[i] * (float)(blockIdx.x + 1);
}

// two outputs: the positive and the negative part
extern "C" __global__ void split_sign(const float *x, float *pos,
                                      float *neg) {
    int i = threadIdx.x;
    pos[i] = fmaxf(x[i], 0.0f);
    neg[i] = fminf(x[i], 0.0f);
}

// a template, exported as fwd<float> and fwd<__half>: relu
template <typename T>
__global__ void fwd(const T *x, T *y, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) {
        float v = (float)x[i];
        y[i] = (T)(v > 0.0f ? v : 0.0f);
    }
}

// reverse n floats through dynamic shared memory (n * 4 bytes of it)
extern "C" __global__ void reverse_smem(const float *x, float *y, int n) {
    extern __shared__ float buf[];
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
}
"""

EXPORTS = ("fwd<float>", "fwd<__half>")


def axpy_plain(a, x, y):
    return (a[0] * x + y,)


def axpy_n_plain(alpha, x, y, n):
    return (alpha * x + y,)


def scale_rows_plain(x):
    rows = torch.arange(1, x.shape[0] + 1, dtype=x.dtype, device=x.device)
    return (x * rows[:, None],)


def split_sign_plain(x):
    return (torch.clamp_min(x, 0.0), torch.clamp_max(x, 0.0))


def relu_plain(x, n):
    return (torch.relu(x.float()).to(x.dtype),)


def reverse_plain(x, n):
    return (torch.flip(x, (0,)),)


class Case(NamedTuple):
    """One launch: ``inputs`` are the signature's inputs in its order
    (numpy arrays for pointers, numbers for scalars), ``outputs`` the
    (shape, numpy dtype) of each output pointer in its order."""
    name: str
    kernel: str
    signature: str
    inputs: Sequence
    outputs: Sequence
    grid: tuple
    block: tuple
    shared_mem: int
    plain: Callable


def cases(rng: np.random.RandomState) -> List[Case]:
    f32 = np.float32
    n = 10_000
    rows, cols = 4, 96
    x8 = np.arange(8, dtype=f32)
    return [
        Case("axpy", "axpy",
             "const float *a, const float *x, const float *y, float *out",
             [np.array([2.0], f32), x8, np.ones(8, f32)], [((8,), f32)],
             (1, 1, 1), (8, 1, 1), 0, axpy_plain),
        Case("axpy_scalars", "axpy_n",
             "float alpha, const float *x, const float *y, float *out, "
             "int n",
             [1.5, rng.randn(n).astype(f32), rng.randn(n).astype(f32), n],
             [((n,), f32)], ((n + 255) // 256, 1, 1), (256, 1, 1), 0,
             axpy_n_plain),
        Case("scale_rows", "scale_rows", "const float *x, float *out",
             [rng.randn(rows, cols).astype(f32)], [((rows, cols), f32)],
             (rows, 1, 1), (cols, 1, 1), 0, scale_rows_plain),
        Case("split_sign", "split_sign",
             "const float *x, float *pos, float *neg",
             [np.array([-2.0, 3.0, -4.0, 5.0], f32)], [((4,), f32)] * 2,
             (1, 1, 1), (4, 1, 1), 0, split_sign_plain),
        Case("template_float", "fwd<float>",
             "const float *x, float *y, int n",
             [rng.randn(n).astype(f32), n], [((n,), f32)],
             ((n + 255) // 256, 1, 1), (256, 1, 1), 0, relu_plain),
        Case("template_half", "fwd<__half>",
             "const half *x, half *y, int n",
             [rng.randn(n).astype(np.float16), n], [((n,), np.float16)],
             ((n + 255) // 256, 1, 1), (256, 1, 1), 0, relu_plain),
        Case("shared_64k", "reverse_smem",
             "const float *x, float *y, int n",
             [rng.randn(SMEM_FLOATS).astype(f32), SMEM_FLOATS],
             [((SMEM_FLOATS,), f32)], (1, 1, 1), (1024, 1, 1),
             SMEM_FLOATS * 4, reverse_plain),
    ]


def launch_case(module, case: Case, device):
    """Launch ``case`` on ``device`` through ``module`` (an
    ``rtc.CudaModule`` of :data:`SOURCE`); returns ``(outputs, plain
    outputs, kernel)`` as tensors on ``device``."""
    from ..base import torch_dtype
    from ..ndarray.ndarray import NDArray
    from ..rtc import _parse_signature

    on_dev = [torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
              else v for v in case.inputs]
    ins, shapes = iter(on_dev), iter(case.outputs)
    args, outs = [], []
    for p in _parse_signature(case.signature):
        if p.is_out:
            shape, dt = next(shapes)
            outs.append(NDArray(torch.zeros(shape, dtype=torch_dtype(dt),
                                            device=device)))
            args.append(outs[-1])
        else:
            v = next(ins)
            args.append(NDArray(v) if isinstance(v, torch.Tensor) else v)
    kernel = module.get_kernel(case.kernel, case.signature)
    kernel.launch(args, grid_dims=case.grid, block_dims=case.block,
                  shared_mem=case.shared_mem)
    return [o._data for o in outs], case.plain(*on_dev), kernel
