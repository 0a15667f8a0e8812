"""``mx.nd.random``: the samplers, the port of
``mxnet_tpu/ndarray/random.py``. Each calls a ``_random_*`` op (scalar
parameters; the result on ``ctx`` or the current context) or, when its
first parameter is an NDArray, the ``_sample_*`` op that draws for each
element of the parameter arrays. Every draw takes the port's generator of
the device (``mx.random.generator``)."""
from __future__ import annotations

from ..base import dtype_name
from .ndarray import NDArray, invoke

__all__ = [
    "uniform", "normal", "randn", "exponential", "gamma", "poisson",
    "negative_binomial", "generalized_negative_binomial", "multinomial",
    "shuffle", "randint",
]


def _sample(op, shape, dtype, ctx, out=None, **kw):
    kwargs = dict(kw)
    if shape is not None:
        kwargs["shape"] = shape if isinstance(shape, (tuple, list)) \
            else (shape,)
    if dtype is not None:
        kwargs["dtype"] = dtype if isinstance(dtype, str) \
            else dtype_name(dtype)
    if ctx is not None:
        kwargs["ctx"] = ctx
    return invoke(op, out=out, **kwargs)


def _per_element(op, params, shape, out):
    return invoke(op, *params, shape=None if shape == (1,) else shape,
                  out=out)


def uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None, out=None,
            **kw):
    if isinstance(low, NDArray):
        return _per_element("_sample_uniform", (low, high), shape, out)
    return _sample("_random_uniform", shape, dtype, ctx, out, low=low,
                   high=high)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None, out=None,
           **kw):
    if isinstance(loc, NDArray):
        return _per_element("_sample_normal", (loc, scale), shape, out)
    return _sample("_random_normal", shape, dtype, ctx, out, loc=loc,
                   scale=scale)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None):
    return _sample("_random_normal", shape or (1,), dtype, ctx, loc=loc,
                   scale=scale)


def exponential(scale=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    return _sample("_random_exponential", shape, dtype, ctx, out,
                   lam=1.0 / scale)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    if isinstance(alpha, NDArray):
        return _per_element("_sample_gamma", (alpha, beta), shape, out)
    return _sample("_random_gamma", shape, dtype, ctx, out, alpha=alpha,
                   beta=beta)


def poisson(lam=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    if isinstance(lam, NDArray):
        return _per_element("_sample_poisson", (lam,), shape, out)
    return _sample("_random_poisson", shape, dtype, ctx, out, lam=lam)


def negative_binomial(k=1, p=1.0, shape=(1,), dtype=None, ctx=None,
                      out=None):
    return _sample("_random_negative_binomial", shape, dtype, ctx, out,
                   k=k, p=p)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                  dtype=None, ctx=None, out=None):
    return _sample("_random_generalized_negative_binomial", shape, dtype,
                   ctx, out, mu=mu, alpha=alpha)


def multinomial(data, shape=(1,), get_prob=False, dtype="int32", out=None):
    return invoke("_sample_multinomial", data, shape=shape,
                  get_prob=get_prob, dtype=dtype, out=out)


def shuffle(data, out=None):
    return invoke("_shuffle", data, out=out)


def randint(low, high, shape=(1,), dtype=None, ctx=None, out=None):
    return _sample("_random_randint", shape, dtype, ctx, out, low=low,
                   high=high)
