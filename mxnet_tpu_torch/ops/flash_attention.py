"""Fused attention forward: the training path's kernel and its plain
version.

The port of ``mxnet_tpu/ops/pallas_kernels.py:121-265`` and of the
registered op ``_contrib_flash_attention`` (``:710-723``). Layout
``(B, H, S, D)`` throughout.

* :func:`flash_attention_forward` — the wrapper of the hand-written CUDA
  kernel ``ops/csrc/flash_attention.cu`` (it replaces the Pallas
  ``_flash_kernel``). CUDA tensors, fp32 or bf16, all of one type; it
  checks device, dtype, shape and contiguity, allocates its output with
  ``torch.empty``, launches on the current stream, raises on a CUDA error
  and counts each launch in ``flash_attention_forward.launches``. A CPU
  tensor goes to the plain version; any other device raises. There is no
  fallback from the kernel to the plain version.
* :func:`flash_attention_reference` — the plain PyTorch version (the JAX
  ``_attention_reference``, line for line): the CPU path, the kernel's
  parity oracle on the card, and the backward's recompute.
* :func:`flash_attention` — the differentiable entry the op calls: a
  ``torch.autograd.Function`` whose forward is the wrapper above and whose
  backward recomputes the dense attention and differentiates it with
  ``torch.autograd.grad``, as the JAX ``_fa_bwd`` does with ``jax.vjp``.
  The backward is not a kernel: the TPU package has none to port (a
  hand-written one is new work), and it materialises the (S, S) scores,
  as the JAX backward does.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import _build
from .registry import register

__all__ = ["flash_attention_forward", "flash_attention_reference",
           "flash_attention", "flash_plan", "FlashPlan", "MAX_HEAD_DIM",
           "MAX_SHARED_BYTES"]

#: The largest head_dim the kernel takes.
MAX_HEAD_DIM = 256
#: Shared memory one block may use on an H100 (227 KB).
MAX_SHARED_BYTES = 232448
_LINE = 128  # bytes of one swizzled shared-memory row (TMA's 128B swizzle)
_STAGES = 2  # K/V tiles in flight: tile t+1 loads while tile t is computed


class FlashPlan(NamedTuple):
    """How the kernel tiles one call (``flash_plan``)."""
    d_pad: int        # head_dim zero-padded to a multiple of 8 (mma depth)
    d_max: int        # the kernel instance: d_pad <= d_max
    rows: int         # q rows a block (16 a warp)
    warps: int
    kv_tile: int      # kv tokens a stage
    stages: int       # K/V stages in the shared-memory ring
    line_blocks: int  # 128-byte column blocks a tile row spans
    vec: int          # bytes a staging copy moves: 0 = TMA; else cp.async
                      # (16, 8, 4) or plain loads (2)
    route: str        # "tma", "cp.async" or "ld.st"
    smem_bytes: int   # dynamic shared memory of a block


@functools.lru_cache(maxsize=None)
def flash_plan(d: int, itemsize: int, align: int = 16) -> FlashPlan:
    """The kernel's tiling for head_dim ``d`` and inputs of ``itemsize``
    bytes whose device pointers are ``align``-byte aligned. The wrapper
    passes it to the kernel, which checks it against its own constants.

    Each tile of Q, K and V lives in shared memory as 128-byte rows in
    TMA's 128B swizzle (a 16-byte chunk's index XOR the row's index mod
    8), ``line_blocks`` column blocks of ``rows`` (or ``kv_tile``) such
    rows each. A row stride ``d * itemsize`` that is a multiple of 16 (and
    16-byte aligned pointers) stages through TMA; any other through
    ``cp.async`` with zero fill, in the widest copy that divides it."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError("flash_attention: head_dim %d outside 1..%d"
                         % (d, MAX_HEAD_DIM))
    d_pad = -(-d // 8) * 8
    d_max = next(b for b in (16, 32, 64, 128, 256) if d_pad <= b)
    # registers: the accumulator is d_max / 2 floats a thread, so at 256
    # the block is 4 warps and the kv tile 32 tokens
    warps = 8 if d_max <= 128 else 4
    kv_tile = 64 if d_max <= 128 else 32
    line_blocks = -(-d_pad * itemsize // _LINE)
    row_bytes = d * itemsize
    vec = next(v for v in (16, 8, 4, 2, 1)
               if row_bytes % v == 0 and align % v == 0)
    if vec == 16:
        vec, route = 0, "tma"
    else:
        route = "cp.async" if vec >= 4 else "ld.st"
    # + 1024: the swizzle needs 1024-byte aligned tiles; + 64: the barriers
    smem = (16 * warps + 2 * _STAGES * kv_tile) * line_blocks * _LINE \
        + 1024 + 64
    return FlashPlan(d_pad, d_max, 16 * warps, warps, kv_tile, _STAGES,
                     line_blocks, vec, route, smem)

_NEG_BIG = -1e30  # the JAX reference's mask value
# the entry points' own codes, returned before any launch
_LAUNCH_ERRORS = {-1: "the plan does not match the built kernel",
                  -2: "cuTensorMapEncodeTiled refused the tensor map"}
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_SAME_DEVICE = contextlib.nullcontext()


def _default_scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def flash_attention_reference(q, k, v, scale=None, causal=False):
    """Plain PyTorch attention in fp32, cast back to ``q.dtype``."""
    if scale is None:
        scale = _default_scale(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = s.shape[-1]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=s.device))
        s = torch.where(mask, s, torch.full_like(s, _NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        # q, k, v, out, BH, S, D, causal, scale, stream, then the plan:
        # rows, kv_tile, stages, vec, smem_bytes
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise MXNetError("flash_attention: %s on %s, q on %s"
                             % (name, t.device, dev))
        if t.dtype != q.dtype:
            raise MXNetError("flash_attention: %s is %s, q is %s"
                             % (name, t.dtype, q.dtype))
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError("flash_attention: q, k, v of one shape (B, H, S, "
                         "D) expected, got %s / %s / %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    d = q.shape[-1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError("flash_attention: head_dim %d outside 1..%d"
                         % (d, MAX_HEAD_DIM))


def flash_attention_forward(q, k, v, scale=None, causal=False):
    """Attention forward on q, k, v ``(B, H, S, D)``: the CUDA kernel for
    CUDA tensors (contiguous, fp32 or bf16), the plain version for CPU
    tensors, an error for anything else."""
    _check(q, k, v)
    if scale is None:
        scale = _default_scale(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, causal)
    if not q.is_cuda:
        raise MXNetError("flash_attention: no kernel for device %s (cuda "
                         "or cpu)" % (q.device,))
    entry = _ENTRY.get(q.dtype)
    if entry is None:
        raise MXNetError("flash_attention: the kernel takes float32 or "
                         "bfloat16, got %s" % (q.dtype,))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise MXNetError("flash_attention: %s must be contiguous" % name)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    align = 16
    for ptr in ptrs:
        align = min(align, ptr & -ptr)
    plan = flash_plan(d, q.element_size(), align)
    fn = _bind(_build.load("flash_attention"), entry)
    index = q.device.index
    # the current stream as a raw handle (no Stream object), and the
    # device made current only where it is not: microseconds a call
    stream = torch._C._cuda_getCurrentRawStream(index)
    with (_SAME_DEVICE if torch.cuda.current_device() == index
          else torch.cuda.device(index)):
        err = fn(*ptrs, out.data_ptr(), b * h, s, d, int(bool(causal)),
                 float(scale), stream, plan.rows, plan.kv_tile, plan.stages,
                 plan.vec, plan.smem_bytes)
    if err != 0:
        raise MXNetError("flash_attention kernel launch failed: %s"
                         % _LAUNCH_ERRORS.get(err, "CUDA error %d" % err))
    flash_attention_forward.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention_forward.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_attention_forward`; backward by
    differentiating the dense recompute (the JAX ``_fa_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        return flash_attention_forward(q.contiguous(), k.contiguous(),
                                       v.contiguous(), scale, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attention_reference(*leaves, ctx.scale, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale=None, causal=False):
    """Differentiable fused attention, ``(B, H, S, D)``: the kernel
    forward (plain version on the CPU) and a dense-recompute backward."""
    if scale is None:
        scale = _default_scale(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal))


@register("_contrib_flash_attention",
          params={"scale": (float, None), "causal": (bool, False)},
          inputs=("query", "key", "value"), aliases=("flash_attention",))
def _flash_attention_op(attrs, q, k, v):
    """Fused multi-head attention on (B, H, S, D) query/key/value."""
    return flash_attention(q, k, v, attrs.scale, attrs.causal)
