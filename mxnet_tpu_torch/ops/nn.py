"""Neural-network ops: the part of ``mxnet_tpu/ops/nn.py`` the GPT
training path calls, in PyTorch.

``FullyConnected`` (its product stays ``F.linear``: the JAX package leaves
it to XLA outside any kernel), ``LayerNorm`` (three outputs: the result,
the mean and the variance), ``Activation``, ``softmax`` and
``log_softmax``. The other ops of the JAX module are not ported yet.
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
