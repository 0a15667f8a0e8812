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

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build
from .registry import register

__all__ = ["flash_attention_forward", "flash_attention_reference",
           "flash_attention", "MAX_HEAD_DIM"]

#: The largest head_dim the kernel takes.
MAX_HEAD_DIM = 256

_NEG_BIG = -1e30  # the JAX reference's mask value
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_void_p]
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
    fn = _bind(_build.load("flash_attention"), entry)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, s, d, int(bool(causal)), float(scale), stream)
    if err != 0:
        raise MXNetError("flash_attention kernel launch failed: CUDA error "
                         "%d" % err)
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
