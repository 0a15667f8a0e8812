"""Neural-network ops: the part of ``mxnet_tpu/ops/nn.py`` the GPT and
SSD training paths call, in PyTorch.

``FullyConnected`` (its product stays ``F.linear``: the JAX package leaves
it to XLA outside any kernel), ``LayerNorm`` (three outputs: the result,
the mean and the variance), ``Activation``, ``softmax`` and
``log_softmax``; for the SSD path ``Convolution`` and ``Pooling``
(channels-first; ``F.conv*d`` and ``F.*_pool*d``, where the JAX package
leaves them to XLA) and ``SoftmaxOutput``, a ``torch.autograd.Function``
with the reference's backward. The other ops of the JAX module are not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .registry import REQUIRED, register

__all__ = []


@register("FullyConnected",
          params={"num_hidden": (int, REQUIRED), "no_bias": (bool, False),
                  "flatten": (bool, True)},
          inputs=lambda attrs: ["data", "weight"] if attrs.get("no_bias")
          else ["data", "weight", "bias"])
def fully_connected(attrs, data, weight, *rest):
    """out = data @ weight.T + bias; weight is (num_hidden, in_units)."""
    if attrs.flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    bias = rest[0] if rest else None
    return F.linear(data, weight, bias)


@register("LayerNorm",
          params={"axis": (int, -1), "eps": (float, 1e-5),
                  "output_mean_var": (bool, False)},
          inputs=("data", "gamma", "beta"), num_outputs=3)
def layer_norm(attrs, data, gamma, beta):
    ax = attrs.axis % data.dim()
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + attrs.eps)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    out = (data - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)
    return out, mean.squeeze(ax), var.squeeze(ax)


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation", params={"act_type": (str, REQUIRED)})
def activation(attrs, data):
    try:
        return _ACTS[attrs.act_type](data)
    except KeyError:
        raise MXNetError("unknown act_type %r" % attrs.act_type)


_SOFTMAX_PARAMS = {"axis": (int, -1), "temperature": (float, None),
                   "dtype": ("dtype", None)}


def _softmax_impl(attrs, data, log):
    x = data
    if attrs.temperature is not None and attrs.temperature != 1.0:
        x = x / attrs.temperature
    out = (torch.log_softmax if log else torch.softmax)(x, dim=attrs.axis)
    if attrs.dtype is not None:
        out = out.to(torch_dtype(attrs.dtype))
    return out


@register("softmax", params=dict(_SOFTMAX_PARAMS))
def softmax(attrs, data):
    return _softmax_impl(attrs, data, log=False)


@register("log_softmax", params=dict(_SOFTMAX_PARAMS))
def log_softmax(attrs, data):
    return _softmax_impl(attrs, data, log=True)


# ---------------------------------------------------------------------------
# convolution and pooling (channels-first, as the SSD symbol uses them)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _channels_first(layout, nd):
    if layout and not layout.startswith("NC"):
        raise MXNetError("layout %r is not ported yet (channels-first "
                         "only)" % (layout,))
    if nd not in _CONV:
        raise MXNetError("%d spatial dims: 1, 2 or 3 expected" % nd)


@register("Convolution",
          params={"kernel": (tuple, REQUIRED), "stride": (tuple, None),
                  "dilate": (tuple, None), "pad": (tuple, None),
                  "num_filter": (int, REQUIRED), "num_group": (int, 1),
                  "workspace": (int, 1024), "no_bias": (bool, False),
                  "cudnn_tune": (str, None), "cudnn_off": (bool, False),
                  "layout": (str, None)},
          inputs=lambda attrs: ["data", "weight"] if attrs.get("no_bias")
          else ["data", "weight", "bias"])
def convolution(attrs, data, weight, *rest):
    """N-d convolution, weight (num_filter, C / num_group, *kernel)."""
    nd = len(attrs.kernel)
    _channels_first(attrs.layout, nd)
    bias = rest[0] if rest else None
    return _CONV[nd](data, weight, bias, stride=attrs.stride or (1,) * nd,
                     padding=attrs.pad or (0,) * nd,
                     dilation=attrs.dilate or (1,) * nd,
                     groups=attrs.num_group)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling",
          params={"kernel": (tuple, None), "pool_type": (str, "max"),
                  "global_pool": (bool, False), "cudnn_off": (bool, False),
                  "pooling_convention": (str, "valid"),
                  "stride": (tuple, None), "pad": (tuple, None),
                  "p_value": (int, 2), "count_include_pad": (bool, True),
                  "layout": (str, None)})
def pooling(attrs, data):
    """Max, average and sum pooling. The padding is applied here (-inf
    for max, 0 otherwise) and the pool runs unpadded, so the windows and
    divisors are the JAX ``reduce_window``'s: ``pooling_convention=
    'full'`` pads the high side up to a whole stride, and an average with
    ``count_include_pad`` divides by the kernel size."""
    nd = data.dim() - 2
    _channels_first(attrs.layout, nd)
    spatial = tuple(range(2, 2 + nd))
    if attrs.global_pool:
        if attrs.pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        if attrs.pool_type == "avg":
            return data.mean(dim=spatial, keepdim=True)
        if attrs.pool_type == "sum":
            return data.sum(dim=spatial, keepdim=True)
        raise MXNetError("global pool_type %r is not ported yet"
                         % attrs.pool_type)
    if attrs.pool_type not in ("max", "avg", "sum"):
        raise MXNetError("pool_type %r is not ported yet" % attrs.pool_type)
    kernel = tuple(attrs.kernel)
    stride = tuple(attrs.stride or (1,) * nd)
    pad = tuple(attrs.pad or (0,) * nd)
    widths = []  # F.pad order: last spatial dim first, (low, high)
    for i in reversed(range(nd)):
        hi = pad[i]
        if attrs.pooling_convention == "full":
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi += stride[i] - rem
        widths += [pad[i], hi]
    padded = any(widths)
    if attrs.pool_type == "max":
        x = F.pad(data, widths, value=-float("inf")) if padded else data
        return _MAX_POOL[nd](x, kernel, stride)
    x = F.pad(data, widths) if padded else data
    if attrs.pool_type == "avg" and attrs.count_include_pad:
        return _AVG_POOL[nd](x, kernel, stride)
    summed = _window_sum(x, kernel, stride)
    if attrs.pool_type == "sum":
        return summed
    ones = torch.ones_like(data[:1, :1])
    return summed / _window_sum(F.pad(ones, widths) if padded else ones,
                                kernel, stride)


def _window_sum(x, kernel, stride):
    if len(kernel) == 1:  # avg_pool1d has no divisor_override
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    return _AVG_POOL[len(kernel)](x, kernel, stride, divisor_override=1)


# ---------------------------------------------------------------------------
# SoftmaxOutput
# ---------------------------------------------------------------------------


def _onehot(label, k, dim):
    """One-hot along ``dim`` with ``k`` classes; an out-of-range label
    (the ignore label -1) gives an all-zero row, as ``jax.nn.one_hot``."""
    lab = label.to(torch.int64).unsqueeze(dim)
    shape = [1] * lab.dim()
    shape[dim] = k
    classes = torch.arange(k, device=label.device).reshape(shape)
    return (lab == classes)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward ignores the incoming gradient and
    emits ``(prob - smoothed_onehot(label)) * grad_scale``, masked where
    the label is ``ignore_label`` and normalized: the JAX ``_so_bwd``
    (``mxnet_tpu/ops/nn.py:461-519``, reference softmax_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        if attrs.multi_output:
            prob = torch.softmax(data, dim=1)
        elif attrs.preserve_shape:
            prob = torch.softmax(data, dim=-1)
        else:
            prob = torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
                .reshape(data.shape)
        ctx.save_for_backward(prob, label)
        ctx.attrs = attrs
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        a = ctx.attrs

        def smoothed(onehot, k):
            onehot = onehot.to(prob.dtype)
            if a.smooth_alpha > 0:
                return onehot * (1.0 - a.smooth_alpha) + \
                    (1.0 - onehot) * (a.smooth_alpha / (k - 1))
            return onehot

        ignore = (label != a.ignore_label).to(prob.dtype)
        if a.multi_output:
            k = prob.shape[1]
            grad = prob - smoothed(_onehot(label, k, 1), k)
            if a.use_ignore:
                grad = grad * ignore.unsqueeze(1)
        elif a.preserve_shape:
            k = prob.shape[-1]
            grad = prob - smoothed(_onehot(label, k, -1), k)
            if a.use_ignore:
                grad = grad * ignore[..., None]
        else:
            flat = prob.reshape(prob.shape[0], -1)
            k = flat.shape[-1]
            grad = (flat - smoothed(_onehot(label.reshape(-1), k, -1), k)) \
                .reshape(prob.shape)
            if a.use_ignore:
                grad = grad * ignore.reshape(
                    (-1,) + (1,) * (prob.dim() - 1))
        scale = torch.tensor(a.grad_scale, dtype=prob.dtype,
                             device=prob.device)
        if a.normalization == "batch":
            scale = scale / prob.shape[0]
        elif a.normalization == "valid" and a.use_ignore:
            scale = scale / torch.clamp_min(ignore.sum(), 1.0)
        return grad * scale, None, None


@register("SoftmaxOutput",
          params={"grad_scale": (float, 1.0), "ignore_label": (float, -1.0),
                  "multi_output": (bool, False), "use_ignore": (bool, False),
                  "preserve_shape": (bool, False),
                  "normalization": (str, "null"), "out_grad": (bool, False),
                  "smooth_alpha": (float, 0.0)},
          inputs=("data", "label"), aliases=("Softmax",))
def softmax_output(attrs, data, label):
    """Softmax with a built-in cross-entropy gradient; no gradient to the
    label."""
    return _SoftmaxOutput.apply(data, label.detach(), attrs)
