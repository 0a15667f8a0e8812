"""The fused optimizer-update operators, the port of
``mxnet_tpu/ops/optimizer_ops.py`` (reference ``src/operator/
optimizer_op.cc``): ``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update``, ``mp_sgd_mom_update``, ``adam_update``,
``ftml_update``, ``ftrl_update``, ``rmsprop_update``,
``rmspropalex_update``, ``signsgd_update``, ``signum_update`` and
``_sparse_adagrad_update`` (alias ``adagrad_update``), with the JAX
package's inputs, attributes and outputs.

They are functional, as there: a state-carrying op returns ``(weight',
state', ...)`` as new tensors and writes nothing. The order of weight
decay and clipping is the JAX package's: the sgd family, ftrl and the
sign ops clip the bare gradient and apply the weight decay outside
(:func:`_prep`); adam, ftml, rmsprop and rmspropalex fold ``wd * weight``
into the gradient before clipping (:func:`_prep_wd`).
"""
from __future__ import annotations

import torch

from .registry import REQUIRED, register

__all__ = []


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _prep_wd(grad, weight, attrs, clip=None):
    """``clip(rescale * grad + wd * weight)``: adam, ftml, rmsprop and
    rmspropalex."""
    g = grad * attrs.rescale_grad + attrs.wd * weight
    clip = attrs.clip_gradient if clip is None else clip
    if clip is not None and clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g


_COMMON = {
    "lr": (float, REQUIRED),
    "wd": (float, 0.0),
    "rescale_grad": (float, 1.0),
    "clip_gradient": (float, -1.0),
}


@register("sgd_update", params=dict(_COMMON, lazy_update=(bool, True)),
          inputs=("weight", "grad"))
def _sgd_update(attrs, weight, grad):
    g = _prep(grad, attrs.rescale_grad, attrs.clip_gradient)
    return weight - attrs.lr * (g + attrs.wd * weight)


@register("sgd_mom_update",
          params=dict(_COMMON, momentum=(float, 0.0),
                      lazy_update=(bool, True)),
          inputs=("weight", "grad", "mom"), num_outputs=2)
def _sgd_mom_update(attrs, weight, grad, mom):
    g = _prep(grad, attrs.rescale_grad, attrs.clip_gradient)
    mom_new = attrs.momentum * mom - attrs.lr * (g + attrs.wd * weight)
    return weight + mom_new, mom_new


@register("mp_sgd_update", params=dict(_COMMON, lazy_update=(bool, True)),
          inputs=("weight", "grad", "weight32"), num_outputs=2)
def _mp_sgd_update(attrs, weight, grad, weight32):
    """The float32 master updated from the low-precision gradient; the
    weight is the master cast back."""
    g = _prep(grad.to(torch.float32), attrs.rescale_grad,
              attrs.clip_gradient)
    w32 = weight32 - attrs.lr * (g + attrs.wd * weight32)
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update",
          params=dict(_COMMON, momentum=(float, 0.0),
                      lazy_update=(bool, True)),
          inputs=("weight", "grad", "mom", "weight32"), num_outputs=3)
def _mp_sgd_mom_update(attrs, weight, grad, mom, weight32):
    g = _prep(grad.to(torch.float32), attrs.rescale_grad,
              attrs.clip_gradient)
    mom_new = attrs.momentum * mom - attrs.lr * (g + attrs.wd * weight32)
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


@register("adam_update",
          params=dict(_COMMON, beta1=(float, 0.9), beta2=(float, 0.999),
                      epsilon=(float, 1e-8), lazy_update=(bool, True)),
          inputs=("weight", "grad", "mean", "var"), num_outputs=3)
def _adam_update(attrs, weight, grad, mean, var):
    """No bias correction: the Python optimizer folds it into ``lr``."""
    g = _prep_wd(grad, weight, attrs)
    m = attrs.beta1 * mean + (1 - attrs.beta1) * g
    v = attrs.beta2 * var + (1 - attrs.beta2) * g * g
    w = weight - attrs.lr * m / (torch.sqrt(v) + attrs.epsilon)
    return w, m, v


@register("ftml_update",
          params=dict(_COMMON, beta1=(float, 0.6), beta2=(float, 0.999),
                      epsilon=(float, 1e-8), t=(int, REQUIRED),
                      clip_grad=(float, -1.0)),
          inputs=("weight", "grad", "d", "v", "z"), num_outputs=4)
def _ftml_update(attrs, weight, grad, d, v, z):
    clip = attrs.clip_grad if attrs.clip_grad > 0 else attrs.clip_gradient
    g = _prep_wd(grad, weight, attrs, clip=clip)
    t = attrs.t
    v_new = attrs.beta2 * v + (1 - attrs.beta2) * g * g
    d_new = (1 - attrs.beta1 ** t) / attrs.lr * (
        torch.sqrt(v_new / (1 - attrs.beta2 ** t)) + attrs.epsilon)
    sigma = d_new - attrs.beta1 * d
    z_new = attrs.beta1 * z + (1 - attrs.beta1) * g - sigma * weight
    w = -z_new / d_new
    return w, d_new, v_new, z_new


@register("ftrl_update",
          params=dict(_COMMON, lamda1=(float, 0.01), beta=(float, 1.0)),
          inputs=("weight", "grad", "z", "n"), num_outputs=3)
def _ftrl_update(attrs, weight, grad, z, n):
    g = _prep(grad, attrs.rescale_grad, attrs.clip_gradient)
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / attrs.lr
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) <= attrs.lamda1,
        torch.zeros_like(weight),
        -(z_new - torch.sign(z_new) * attrs.lamda1)
        / ((attrs.beta + torch.sqrt(n_new)) / attrs.lr + attrs.wd))
    return w, z_new, n_new


@register("rmsprop_update",
          params=dict(_COMMON, gamma1=(float, 0.95), epsilon=(float, 1e-8)),
          inputs=("weight", "grad", "n"), num_outputs=2)
def _rmsprop_update(attrs, weight, grad, n):
    g = _prep_wd(grad, weight, attrs)
    n_new = attrs.gamma1 * n + (1 - attrs.gamma1) * g * g
    w = weight - attrs.lr * g / torch.sqrt(n_new + attrs.epsilon)
    return w, n_new


@register("rmspropalex_update",
          params=dict(_COMMON, gamma1=(float, 0.95), gamma2=(float, 0.9),
                      epsilon=(float, 1e-8)),
          inputs=("weight", "grad", "n", "g", "delta"), num_outputs=4)
def _rmspropalex_update(attrs, weight, grad, n, g_state, delta):
    g = _prep_wd(grad, weight, attrs)
    n_new = attrs.gamma1 * n + (1 - attrs.gamma1) * g * g
    g_new = attrs.gamma1 * g_state + (1 - attrs.gamma1) * g
    delta_new = attrs.gamma2 * delta - attrs.lr * g / torch.sqrt(
        n_new - g_new * g_new + attrs.epsilon)
    return weight + delta_new, n_new, g_new, delta_new


@register("signsgd_update", params=dict(_COMMON),
          inputs=("weight", "grad"))
def _signsgd_update(attrs, weight, grad):
    g = _prep(grad, attrs.rescale_grad, attrs.clip_gradient)
    return weight - attrs.lr * (torch.sign(g) + attrs.wd * weight)


@register("signum_update",
          params=dict(_COMMON, momentum=(float, 0.0), wd_lh=(float, 0.0)),
          inputs=("weight", "grad", "mom"), num_outputs=2)
def _signum_update(attrs, weight, grad, mom):
    g = _prep(grad, attrs.rescale_grad, attrs.clip_gradient)
    mom_new = attrs.momentum * mom - (1 - attrs.momentum) * (
        g + attrs.wd * weight)
    w = (1 - attrs.lr * attrs.wd_lh) * weight \
        + attrs.lr * torch.sign(mom_new)
    return w, mom_new


@register("_sparse_adagrad_update",
          params=dict(_COMMON, epsilon=(float, 1e-7)),
          inputs=("weight", "grad", "history"), num_outputs=2,
          aliases=("adagrad_update",))
def _sparse_adagrad_update(attrs, weight, grad, history):
    """AdaGrad with implicit row sparsity: a row whose gradient is all
    zero keeps its weight and history exactly."""
    g = _prep(grad, attrs.rescale_grad, attrs.clip_gradient)
    if g.dim() >= 2:
        row_active = torch.any(g != 0, dim=tuple(range(1, g.dim())),
                               keepdim=True)
    else:
        row_active = g != 0
    hist_new = torch.where(row_active, history + g * g, history)
    upd = attrs.lr * (g / (torch.sqrt(hist_new) + attrs.epsilon)
                      + attrs.wd * weight)
    w = torch.where(row_active, weight - upd, weight)
    return w, hist_new
