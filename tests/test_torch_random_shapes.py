"""The port's samplers against the JAX package's shapes and dtypes (CPU):
the ``nd.random`` functions with scalar parameters, and the ``_sample_*``
ops' broadcasting of array parameters, at each ``shape`` (the draws
differ by construction; ``test_torch_random.py`` holds their moments and
replay).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd


def _draw(pkg, op, arrays, attrs, shape):
    params = [pkg.nd.array(a, ctx=pkg.cpu()) for a in arrays]
    kw = dict(attrs, shape=shape)
    out = pkg.nd.invoke(op, *params, **kw) if params \
        else pkg.nd.invoke(op, ctx=pkg.cpu(), **kw)
    return out[0] if isinstance(out, (list, tuple)) else out


@pytest.mark.parametrize("name,args", [
    ("uniform", dict(low=-1.0, high=1.0, shape=(3, 4))),
    ("normal", dict(loc=0.5, scale=2.0, shape=(3, 4))),
    ("exponential", dict(scale=2.0, shape=(5,))),
    ("gamma", dict(alpha=2.0, beta=0.5, shape=(2, 2))),
    ("poisson", dict(lam=3.0, shape=(4,))),
    ("negative_binomial", dict(k=3, p=0.4, shape=(4,))),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.3, shape=(4,))),
    ("randint", dict(low=0, high=7, shape=(3, 3))),
    ("uniform", dict(low=-1.0, high=1.0, shape=(2,), dtype="float16")),
])
def test_nd_random_functions_match_the_jax_shapes_and_dtypes(name, args):
    got = getattr(nd.random, name)(ctx=mx.cpu(), **args)
    want = getattr(jmx.nd.random, name)(ctx=jmx.cpu(), **args)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.context == mx.cpu()
    randn = nd.random.randn(2, 3, ctx=mx.cpu())
    assert randn.shape == jmx.nd.random.randn(2, 3).shape


@pytest.mark.parametrize("op,arrays", [
    ("_sample_uniform", [np.zeros((2, 3), np.float32),
                         np.ones((2, 3), np.float32)]),
    ("_sample_normal", [np.zeros((4,), np.float32),
                        np.ones((4,), np.float32)]),
    ("_sample_gamma", [np.ones((2, 1), np.float32),
                       np.ones((2, 1), np.float32)]),
    ("_sample_poisson", [np.full((3,), 2.0, np.float32)]),
    ("_sample_exponential", [np.full((2, 2), 2.0, np.float32)]),
    ("_sample_negative_binomial", [np.full((2,), 2.0, np.float32),
                                   np.full((2,), 0.5, np.float32)]),
    ("_sample_generalized_negative_binomial",
     [np.full((2,), 2.0, np.float32), np.full((2,), 0.5, np.float32)]),
])
@pytest.mark.parametrize("shape", [None, (2, 3)])
def test_sample_ops_broadcast_as_jax(op, arrays, shape):
    got = _draw(mx, op, arrays, {}, shape)
    want = _draw(jmx, op, arrays, {}, shape)
    assert got.shape == want.shape and got.dtype == want.dtype


def test_nd_random_array_parameters_take_the_sample_ops():
    with mx.cpu():
        lo, hi = nd.array([0.0, 10.0]), nd.array([1.0, 11.0])
        u = nd.random.uniform(lo, hi, shape=(100,)).asnumpy()
    assert u.shape == (2, 100)
    assert (u[0] < 1).all() and (u[1] >= 10).all()
    jl, jh = jmx.nd.array([0.0, 10.0]), jmx.nd.array([1.0, 11.0])
    assert jmx.nd.random.uniform(jl, jh, shape=(100,)).shape == u.shape
