"""INT8 quantization operators: the port of ``mxnet_tpu/ops/quantization.py``.

Reference ``src/operator/quantization/`` (quantize/dequantize/requantize,
quantized_conv, quantized_fully_connected, quantized_pooling,
quantized_flatten). The scheme is the reference's and the JAX package's:
int8 is SYMMETRIC (quantized range 127, real range max(|min|, |max|)),
uint8 is affine over [min, max]; the quantized compute ops take int8 data
and the float min/max pair of each input and return the int32
accumulator and its float range (the int32 extremes map onto the product
of the input scales).

The int32 accumulator is exact on every device, as
``preferred_element_type=int32`` makes it in JAX:

* on the card, the dense layer is ``torch._int_mm`` (cuBLASLt's int8 GEMM
  with int32 accumulation; operands padded with zeros to its shape rules:
  more than 16 rows, K and N multiples of 8) and the convolution is
  im2col (``F.unfold`` on the int8 values in float16, which holds them
  exactly, back to int8) into the same GEMM, one group at a time. There
  is no other route on the card: these raise rather than fall back;
* elsewhere (the CPU; ``meta`` tensors of shape inference), the plain
  version: the same product in float64, rounded to int32. Every partial
  sum is below 2^31 (at most K x 127^2), far inside float64's 2^53, so it
  is exact.

The scales divide as JAX does, truly, on the card too (``_common._div``:
CUDA divides by a Python scalar through its reciprocal, which can tip the
rounding of a bias or a requantized value).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ._common import _div
from .registry import OP_REGISTRY, REQUIRED, register

__all__ = ["int8_matmul", "INT8_RANGE", "UINT8_RANGE", "INT32_RANGE"]

INT8_RANGE = 127.0
UINT8_RANGE = 255.0
INT32_RANGE = float(2 ** 31 - 1)


def _scalar(t):
    return t.reshape(()).to(torch.float32)


def _real_range(mn, mx):
    return torch.maximum(torch.abs(mn), torch.abs(mx))


def _full(value, like):
    return torch.full((), value, dtype=torch.float32, device=like.device)


@register("_contrib_quantize",
          params={"out_type": (str, "uint8")},
          inputs=("data", "min_range", "max_range"), num_outputs=3)
def _quantize(attrs, data, min_range, max_range):
    """float -> int8/uint8 (reference quantize-inl.h QuantizeCompute)."""
    mn, mx = _scalar(min_range), _scalar(max_range)
    tiny = _full(1e-30, data)
    if attrs.out_type == "int8":
        r = _real_range(mn, mx)
        scale = INT8_RANGE / torch.maximum(r, tiny)
        q = torch.clamp(torch.round(data * scale), -INT8_RANGE, INT8_RANGE)
        return q.to(torch.int8), -r, r
    if attrs.out_type == "uint8":
        scale = UINT8_RANGE / torch.maximum(mx - mn, tiny)
        q = torch.clamp(torch.round((data - mn) * scale), 0.0, UINT8_RANGE)
        return q.to(torch.uint8), mn, mx
    raise ValueError("unsupported out_type %r" % attrs.out_type)


@register("_contrib_dequantize",
          params={"out_type": (str, "float32")},
          inputs=("data", "min_range", "max_range"))
def _dequantize(attrs, data, min_range, max_range):
    """int8/uint8/int32 -> float (reference dequantize-inl.h)."""
    mn, mx = _scalar(min_range), _scalar(max_range)
    if data.dtype == torch.uint8:
        scale = _div(mx - mn, UINT8_RANGE)
        return data.to(torch.float32) * scale + mn
    quant_range = INT8_RANGE if data.dtype == torch.int8 else INT32_RANGE
    scale = _div(_real_range(mn, mx), quant_range)
    return data.to(torch.float32) * scale


@register("_contrib_requantize",
          params={"min_calib_range": (float, None),
                  "max_calib_range": (float, None)},
          inputs=("data", "min_range", "max_range"), num_outputs=3)
def _requantize(attrs, data, min_range, max_range):
    """int32 accumulator -> int8 with a (calibrated) narrower range
    (reference requantize-inl.h)."""
    mn, mx = _scalar(min_range), _scalar(max_range)
    in_scale = _div(_real_range(mn, mx), INT32_RANGE)
    real = data.to(torch.float32) * in_scale
    if attrs.min_calib_range is not None and \
            attrs.max_calib_range is not None:
        out_r = _full(max(abs(attrs.min_calib_range),
                          abs(attrs.max_calib_range)), data)
    else:
        out_r = torch.maximum(torch.abs(real).amax(), _full(1e-30, data))
    q = torch.clamp(torch.round(real * (INT8_RANGE / out_r)),
                    -INT8_RANGE, INT8_RANGE)
    return q.to(torch.int8), -out_r, out_r


def _pad_to(t, rows, cols):
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    return F.pad(t, (0, cols - c, 0, rows - r))


def int8_matmul(a, w):
    """``a (M, K) @ w (N, K).T`` of int8 values as an exact int32 (M, N):
    ``torch._int_mm`` on a CUDA tensor, the float64 product rounded to
    int32 anywhere else."""
    if a.device.type != "cuda":
        return torch.round(a.to(torch.float64) @ w.to(torch.float64).t()) \
            .to(torch.int32)
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise MXNetError("int8_matmul: int8 operands expected on the card, "
                         "got %s and %s" % (a.dtype, w.dtype))
    m, k = a.shape
    n = w.shape[0]
    kp = -(-k // 8) * 8
    np_ = -(-n // 8) * 8
    a = _pad_to(a, max(m, 17), kp).contiguous()
    # the weight's (N, K) rows as the (K, N) column-major operand
    wt = _pad_to(w, np_, kp).contiguous().t()
    return torch._int_mm(a, wt)[:m, :n]


def _i8(x):
    return x if x.dtype == torch.int8 else x.to(torch.int8)


def _out_scale(min_d, max_d, min_w, max_w):
    d_scale = _div(_real_range(_scalar(min_d), _scalar(max_d)), INT8_RANGE)
    w_scale = _div(_real_range(_scalar(min_w), _scalar(max_w)), INT8_RANGE)
    return d_scale * w_scale


def _bias32(bias, min_b, max_b, out_scale):
    """Bias quanta rescaled into the accumulator's scale."""
    b_scale = _div(_real_range(_scalar(min_b), _scalar(max_b)), INT8_RANGE)
    return torch.round(bias.to(torch.float32) * b_scale
                       / torch.maximum(out_scale, _full(1e-30, bias))) \
        .to(torch.int32)


def _q_inputs(attrs):
    if attrs.get("no_bias"):
        return ["data", "weight", "min_data", "max_data",
                "min_weight", "max_weight"]
    return ["data", "weight", "bias", "min_data", "max_data",
            "min_weight", "max_weight", "min_bias", "max_bias"]


def _split(attrs, rest):
    if attrs.no_bias:
        min_d, max_d, min_w, max_w = rest
        return None, (min_d, max_d, min_w, max_w), None
    bias, min_d, max_d, min_w, max_w, min_b, max_b = rest
    return bias, (min_d, max_d, min_w, max_w), (min_b, max_b)


@register("_contrib_quantized_fully_connected",
          params={"num_hidden": (int, REQUIRED), "no_bias": (bool, False),
                  "flatten": (bool, True)},
          inputs=_q_inputs, num_outputs=3)
def _quantized_fc(attrs, data, weight, *rest):
    """int8 x int8 -> int32 fully connected layer (reference
    quantized_fully_connected.cc). Output range: the int32 extremes map to
    the product of the input scales."""
    bias, ranges, b_range = _split(attrs, rest)
    x = data.reshape(data.shape[0], -1) if attrs.flatten else data
    lead = tuple(x.shape[:-1])
    acc = int8_matmul(_i8(x).reshape(-1, x.shape[-1]), _i8(weight)) \
        .reshape(lead + (weight.shape[0],))
    out_scale = _out_scale(*ranges)
    if bias is not None:
        acc = acc + _bias32(bias, *b_range, out_scale)
    return acc, -INT32_RANGE * out_scale, INT32_RANGE * out_scale


def _conv_plain(x, w, stride, pad, dilate, groups):
    acc = F.conv2d(x.to(torch.float64), w.to(torch.float64), None, stride,
                   pad, dilate, groups)
    return torch.round(acc).to(torch.int32)


def _conv_int8_cuda(x, w, stride, pad, dilate, groups):
    """im2col into ``int8_matmul``, one group at a time: (B, F, OH, OW)
    int32."""
    b = x.shape[0]
    f, cg, kh, kw = w.shape
    oh = (x.shape[2] + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (x.shape[3] + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    cols = F.unfold(x.to(torch.float16), (kh, kw), dilation=dilate,
                    padding=pad, stride=stride).to(torch.int8)
    kk = cg * kh * kw
    fg = f // groups
    outs = []
    for g in range(groups):
        a = cols[:, g * kk:(g + 1) * kk].transpose(1, 2).reshape(-1, kk)
        acc = int8_matmul(a, w[g * fg:(g + 1) * fg].reshape(fg, kk))
        outs.append(acc.reshape(b, oh * ow, fg).transpose(1, 2))
    return torch.cat(outs, dim=1).reshape(b, f, oh, ow)


@register("_contrib_quantized_conv",
          params={"kernel": (tuple, REQUIRED), "stride": (tuple, None),
                  "pad": (tuple, None), "dilate": (tuple, None),
                  "num_filter": (int, REQUIRED), "num_group": (int, 1),
                  "no_bias": (bool, False), "layout": (str, "NCHW")},
          inputs=_q_inputs, num_outputs=3)
def _quantized_conv(attrs, data, weight, *rest):
    """int8 convolution with int32 accumulation (reference
    quantized_conv.cc)."""
    bias, ranges, b_range = _split(attrs, rest)
    k = len(attrs.kernel)
    if k != 2:
        raise ValueError("quantized_conv supports 2D kernels only")
    stride = tuple(attrs.stride or (1,) * k)
    pad = tuple(attrs.pad or (0,) * k)
    dilate = tuple(attrs.dilate or (1,) * k)
    if data.device.type == "cuda":
        acc = _conv_int8_cuda(_i8(data), _i8(weight), stride, pad, dilate,
                              attrs.num_group)
    else:
        acc = _conv_plain(_i8(data), _i8(weight), stride, pad, dilate,
                          attrs.num_group)
    out_scale = _out_scale(*ranges)
    if bias is not None:
        acc = acc + _bias32(bias, *b_range, out_scale).reshape(
            1, -1, *([1] * (acc.dim() - 2)))
    return acc, -INT32_RANGE * out_scale, INT32_RANGE * out_scale


@register("_contrib_quantized_pooling",
          params={"kernel": (tuple, None), "pool_type": (str, "max"),
                  "stride": (tuple, None), "pad": (tuple, None),
                  "global_pool": (bool, False),
                  "pooling_convention": (str, "valid")},
          inputs=("data", "min_data", "max_data"), num_outputs=3)
def _quantized_pooling(attrs, data, min_data, max_data):
    """int8 pooling; the ranges pass through (reference
    quantized_pooling.cc: max and average pooling are scale-invariant)."""
    pool = OP_REGISTRY["Pooling"]
    p_attrs = pool.parse_attrs({
        "kernel": attrs.kernel, "pool_type": attrs.pool_type,
        "stride": attrs.stride, "pad": attrs.pad,
        "global_pool": attrs.global_pool,
        "pooling_convention": attrs.pooling_convention})
    out = pool.fcompute(p_attrs, data.to(torch.float32))
    if isinstance(out, (tuple, list)):
        out = out[0]
    if attrs.pool_type != "max":
        out = torch.round(out)
    return out.to(data.dtype), _scalar(min_data), _scalar(max_data)


@register("_contrib_quantized_flatten",
          inputs=("data", "min_data", "max_data"), num_outputs=3)
def _quantized_flatten(attrs, data, min_data, max_data):
    return (data.reshape(data.shape[0], -1), _scalar(min_data),
            _scalar(max_data))
