"""Random sampling ops: the port of ``mxnet_tpu/ops/random_ops.py``
(reference ``src/operator/random/sample_op.cc``, ``multisample_op.cc``,
``unique_sample_op.h``).

Every draw takes the port's explicit generator of the output's device
(``random.generator``), never torch's global one: ``mx.random.seed``
seeds it and ``get_state``/``set_state`` replay it. The draws differ from
the JAX package's PRNG keys for the same seed; the distributions, shapes,
dtypes and parameter broadcasting are the JAX ops'.

* ``_random_*`` take scalar parameters and a ``shape``; their result goes
  on the device of ``ctx`` or the current context (``out_device``).
* ``_sample_*`` take parameter arrays and draw ``shape`` values for each
  element: the output's shape is the first parameter's shape plus
  ``shape``.
* Gamma draws use ``torch._standard_gamma`` (Marsaglia-Tsang on the
  device), whose gradient with respect to alpha is the implicit one, as
  ``jax.random.gamma``'s; Poisson draws ``torch.poisson``; the negative
  binomials are Poisson draws at Gamma-drawn rates, as in the JAX ops.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import torch_dtype
from .registry import REQUIRED, register
from .tensor import out_device

__all__ = []

_SHAPE_PARAMS = {"shape": (tuple, None), "dtype": ("dtype", None),
                 "ctx": (str, "")}


def _shape_dtype(attrs):
    dtype = torch.float32 if attrs.dtype is None else torch_dtype(
        attrs.dtype)
    return tuple(attrs.shape or ()), dtype


def _gen(device):
    return _random.generator(device)


def _uniform(shape, dtype, device):
    return torch.rand(shape, dtype=dtype, device=device,
                      generator=_gen(device))


def _normal(shape, dtype, device):
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=_gen(device))


def _exponential(shape, dtype, device):
    """Unit-rate exponential draws, ``-log1p(-u)`` of uniform ones."""
    return -torch.log1p(-_uniform(shape, dtype, device))


def _gamma(alpha):
    """Unit-scale Gamma(alpha) draws, one for each element of ``alpha``."""
    return torch._standard_gamma(alpha.contiguous(),
                                 generator=_gen(alpha.device))


def _poisson(lam):
    return torch.poisson(lam.contiguous(), generator=_gen(lam.device))


@register("_random_uniform",
          params={"low": (float, 0.0), "high": (float, 1.0),
                  **_SHAPE_PARAMS}, inputs=())
def random_uniform(attrs):
    shape, dtype = _shape_dtype(attrs)
    u = _uniform(shape, dtype, out_device(attrs))
    return attrs.low + (attrs.high - attrs.low) * u


@register("_random_normal",
          params={"loc": (float, 0.0), "scale": (float, 1.0),
                  **_SHAPE_PARAMS}, inputs=())
def random_normal(attrs):
    shape, dtype = _shape_dtype(attrs)
    return attrs.loc + attrs.scale * _normal(shape, dtype,
                                             out_device(attrs))


@register("_random_exponential", params={"lam": (float, 1.0),
                                         **_SHAPE_PARAMS}, inputs=())
def random_exponential(attrs):
    shape, dtype = _shape_dtype(attrs)
    return _exponential(shape, dtype, out_device(attrs)) / attrs.lam


@register("_random_gamma",
          params={"alpha": (float, 1.0), "beta": (float, 1.0),
                  **_SHAPE_PARAMS}, inputs=())
def random_gamma(attrs):
    shape, dtype = _shape_dtype(attrs)
    alpha = torch.full(shape, attrs.alpha, dtype=dtype,
                       device=out_device(attrs))
    return _gamma(alpha) * attrs.beta


@register("_random_poisson", params={"lam": (float, 1.0), **_SHAPE_PARAMS},
          inputs=())
def random_poisson(attrs):
    shape, dtype = _shape_dtype(attrs)
    lam = torch.full(shape, attrs.lam, dtype=torch.float32,
                     device=out_device(attrs))
    return _poisson(lam).to(dtype)


def _neg_binomial(k, p, dtype):
    """NB(k, p) = Poisson(Gamma(k) * (1 - p) / p)."""
    return _poisson(_gamma(k) * ((1 - p) / p)).to(dtype)


@register("_random_negative_binomial",
          params={"k": (int, 1), "p": (float, 1.0), **_SHAPE_PARAMS},
          inputs=())
def random_negative_binomial(attrs):
    shape, dtype = _shape_dtype(attrs)
    k = torch.full(shape, float(attrs.k), device=out_device(attrs))
    return _neg_binomial(k, attrs.p, dtype)


@register("_random_generalized_negative_binomial",
          params={"mu": (float, 1.0), "alpha": (float, 1.0),
                  **_SHAPE_PARAMS}, inputs=())
def random_gen_negative_binomial(attrs):
    shape, dtype = _shape_dtype(attrs)
    dev = out_device(attrs)
    if attrs.alpha <= 0:
        return _poisson(torch.full(shape, attrs.mu, device=dev)).to(dtype)
    k = 1.0 / attrs.alpha
    return _neg_binomial(torch.full(shape, k, device=dev),
                         k / (k + attrs.mu), dtype)


@register("_random_randint",
          params={"low": (int, 0), "high": (int, REQUIRED),
                  **_SHAPE_PARAMS}, inputs=())
def random_randint(attrs):
    shape, dtype = _shape_dtype(attrs)
    if dtype == torch.float32:
        dtype = torch.int32
    dev = out_device(attrs)
    return torch.randint(attrs.low, attrs.high, shape, dtype=dtype,
                         device=dev, generator=_gen(dev))


# the tensor-parameter forms (reference multisample_op.cc): `shape` draws
# for each element of the parameter arrays


def _multisample(name, inputs, fn):
    @register(name, params={"shape": (tuple, None),
                            "dtype": ("dtype", None)}, inputs=inputs)
    def op(attrs, *params):
        shape = tuple(attrs.shape or ())
        out_shape = tuple(params[0].shape) + shape
        dtype = torch.float32 if attrs.dtype is None else torch_dtype(
            attrs.dtype)
        ps = [torch.broadcast_to(p.reshape(tuple(p.shape)
                                           + (1,) * len(shape)), out_shape)
              for p in params]
        return fn(out_shape, dtype, params[0].device, *ps)

    return op


_multisample("_sample_uniform", ("low", "high"),
             lambda s, d, dev, lo, hi: lo + (hi - lo) * _uniform(s, d, dev))
_multisample("_sample_normal", ("mu", "sigma"),
             lambda s, d, dev, mu, sg: mu + sg * _normal(s, d, dev))
_multisample("_sample_exponential", ("lam",),
             lambda s, d, dev, lam: _exponential(s, d, dev) / lam)
_multisample("_sample_gamma", ("alpha", "beta"),
             lambda s, d, dev, a, b: _gamma(a.to(d)) * b)
_multisample("_sample_poisson", ("lam",),
             lambda s, d, dev, lam: _poisson(lam.float()).to(d))
_multisample("_sample_negative_binomial", ("k", "p"),
             lambda s, d, dev, k, p: _neg_binomial(k.float(), p, d))
_multisample(
    "_sample_generalized_negative_binomial", ("mu", "alpha"),
    lambda s, d, dev, mu, alpha: _poisson(
        _gamma(1.0 / torch.clamp_min(alpha.float(), 1e-12))
        * (mu * alpha)).to(d))


@register("_sample_multinomial",
          params={"shape": (tuple, None), "get_prob": (bool, False),
                  "dtype": ("dtype", None)},
          inputs=("data",),
          num_outputs=lambda attrs: 2 if attrs.get("get_prob") else 1)
def sample_multinomial(attrs, data):
    """data: (..., k) probabilities; ``shape`` draws per distribution,
    with the log-probability of each draw when ``get_prob``."""
    n = 1
    for s in attrs.shape or (1,):
        n *= s
    flat = data.reshape(-1, data.shape[-1])
    draws = torch.multinomial(flat, n, replacement=True,
                              generator=_gen(data.device))
    out_shape = tuple(data.shape[:-1]) + tuple(attrs.shape or ())
    dtype = torch.int32 if attrs.dtype is None else torch_dtype(attrs.dtype)
    samples = draws.reshape(out_shape or (1,)).to(dtype)
    if attrs.get_prob:
        logp = torch.log_softmax(torch.log(torch.clamp_min(flat, 1e-30)),
                                 dim=-1)
        lp = torch.gather(logp, 1, draws).reshape(samples.shape)
        return samples, lp
    return samples


@register("_shuffle", inputs=("data",))
def shuffle(attrs, data):
    """A random permutation along the first axis."""
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_gen(data.device))
    return data.index_select(0, perm)


@register("_sample_unique_zipfian",
          params={"range_max": (int, REQUIRED), "shape": (tuple, None)},
          inputs=(), num_outputs=2)
def sample_unique_zipfian(attrs):
    """The log-uniform (Zipfian) candidate sampler of sampled softmax, as
    the JAX op draws it: ``floor(exp(u * log(range_max + 1)) - 1)``
    clipped into range, each with a count of 1 (no rejection of
    repeats)."""
    shape = tuple(attrs.shape or (1,))
    dev = out_device(attrs)
    u = _uniform((math.prod(shape),), torch.float32, dev)
    rng = attrs.range_max
    samples = (torch.exp(u * math.log(rng + 1.0)) - 1.0).to(torch.int64)
    samples = samples.clamp(0, rng - 1)
    counts = torch.ones_like(samples)
    return samples.reshape(shape), counts.reshape(shape)
