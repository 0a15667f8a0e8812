"""The ops and layers the vision zoo slice adds to the port, against the
JAX package (CPU), fp32 within ``TOL`` unless stated; forwards and
gradients (of the input and of every parameter) through the helpers of
``test_torch_nn_layers.py``.

* The ``clip`` op (MobileNet v2's ReLU6) and its gradient, on inputs
  away from the bounds (at a bound torch's clamp passes the gradient,
  jnp.clip halves it); ``SwapAxis``.
* The ``InstanceNorm`` op (eps 1e-3) and its gradients; the
  ``InstanceNorm`` layer over axis 1 and over another axis, with and
  without ``scale``/``center``; a symbolic ``InstanceNorm`` infers its
  parameter shapes.
* ``Lambda`` and ``HybridLambda`` from a function and from an ``nd``
  function's name (an unknown name raises).
* ``gluon.contrib.nn``: ``Concurrent`` and ``HybridConcurrent`` (with the
  JAX parameter names), ``Identity``, ``SparseEmbedding`` (a dense
  gradient, as in the JAX package) and ``SyncBatchNorm`` (BatchNorm on
  one device).
* ``benchmark_score.score`` on the CPU for one small net, and ``build``
  in bfloat16 (``Block.cast``).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.contrib import nn as jcnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from test_torch_nn_layers import TOL, _compare, _x
from test_torch_nn_layers import _one_torch_thread  # noqa: F401


def _op_grads(pkg, op, arrays, hg, **kw):
    """Output and input gradients of ``sum(op(*arrays, **kw) * hg)``."""
    xs = [pkg.nd.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, op)(*xs, **kw)
        loss = (out * pkg.nd.array(hg)).sum()
    loss.backward()
    return [out.asnumpy()] + [x.grad.asnumpy() for x in xs]


def _ops_match(op, arrays, **kw):
    out_shape = getattr(jmx.nd, op)(*[jmx.nd.array(a) for a in arrays],
                                    **kw).shape
    hg = np.random.RandomState(9).randn(*out_shape).astype(np.float32)
    want = _op_grads(jmx, op, arrays, hg, **kw)
    with mx.cpu():
        got = _op_grads(mx, op, arrays, hg, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    return got


def test_clip_op_and_gradient_match_jax():
    x = _x(4, 7, scale=4.0, shift=2.0)
    x = np.where(np.abs(x) < 0.05, 0.3, x)  # away from the bound 0
    x = np.where(np.abs(x - 6) < 0.05, 5.7, x)  # and from 6
    out, grad = _ops_match("clip", [x], a_min=0.0, a_max=6.0)
    assert out.min() == 0.0 and out.max() == 6.0
    np.testing.assert_array_equal(grad != 0, (x > 0) & (x < 6))
    with mx.cpu():
        assert nd.clip(nd.array(x), 0, 6).asnumpy().max() == 6.0


def test_swapaxes_matches_jax():
    x = _x(2, 3, 4)
    with mx.cpu():
        got = nd.array(x).swapaxes(0, 2).asnumpy()
    np.testing.assert_array_equal(got,
                                  jmx.nd.array(x).swapaxes(0, 2).asnumpy())


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (3, 2, 7)])
def test_instance_norm_op_and_gradients_match_jax(shape):
    x = _x(*shape, scale=2.0, shift=1.0)
    gamma = _x(shape[1], seed=1, shift=1.0)
    beta = _x(shape[1], seed=2)
    _ops_match("InstanceNorm", [x, gamma, beta])
    _ops_match("InstanceNorm", [x, gamma, beta], eps=1e-5)


INSTANCE_NORMS = {
    "default": (lambda m: m.InstanceNorm(), (2, 3, 4, 5)),
    "scale_no_center": (lambda m: m.InstanceNorm(scale=True, center=False),
                        (2, 3, 4, 5)),
    "axis_2": (lambda m: m.InstanceNorm(axis=2, scale=True, epsilon=1e-3),
               (2, 3, 4, 5)),
}


@pytest.mark.parametrize("name", sorted(INSTANCE_NORMS))
def test_instance_norm_layer_matches_jax(name):
    make, shape = INSTANCE_NORMS[name]
    _compare(make, _x(*shape, scale=2.0, shift=1.0))


def test_symbolic_instance_norm_infers_its_parameter_shapes():
    s = mx.sym.InstanceNorm(mx.sym.var("data"), name="inorm")
    args, outs, _ = s.infer_shape(data=(2, 3, 4, 5))
    assert dict(zip(s.list_arguments(), args)) == {
        "data": (2, 3, 4, 5), "inorm_gamma": (3,), "inorm_beta": (3,)}
    assert outs == [(2, 3, 4, 5)]


def test_lambda_and_hybrid_lambda_match_jax():
    x = _x(3, 4)
    for make in (lambda m: m.Lambda("relu"),
                 lambda m: m.Lambda(lambda a: a * 2),
                 lambda m: m.HybridLambda("sigmoid"),
                 lambda m: m.HybridLambda(lambda F, a: F.relu(a) + 1)):
        _compare(make, x)
    assert repr(nn.Lambda("relu")) == "Lambda(relu)"
    assert repr(nn.HybridLambda(lambda F, a: a)) == "HybridLambda(<lambda>)"
    with pytest.raises(MXNetError, match="not found"):
        nn.Lambda("no_such_function")
    with pytest.raises(MXNetError, match="not found"):
        nn.HybridLambda("no_such_function")
    with pytest.raises(ValueError, match="Unrecognized"):
        nn.Lambda(3)


def _concurrent(m, c):
    block = c.HybridConcurrent(axis=1)
    with block.name_scope():
        block.add(m.Dense(4))
        block.add(c.Identity())
        block.add(m.Dense(3, activation="relu"))
    return block


def test_hybrid_concurrent_and_identity_match_jax():
    got = _compare(lambda m: _concurrent(
        m, cnn if m is nn else jcnn), _x(2, 5))
    assert got[0].shape == (2, 12)
    assert sorted(k.split("_", 1)[1] for k in got[2]) == [
        "dense0_bias", "dense0_weight", "dense1_bias", "dense1_weight"]


def test_concurrent_runs_every_child_on_the_input():
    with mx.cpu():
        block = cnn.Concurrent(axis=-1)
        block.add(nn.Dense(2, in_units=3), cnn.Identity())
        block.initialize()
        x = nd.array(_x(4, 3))
        out = block(x)
    assert out.shape == (4, 5)
    np.testing.assert_array_equal(out.asnumpy()[:, 2:], x.asnumpy())


def test_sparse_embedding_has_a_dense_gradient():
    with mx.cpu():
        emb = cnn.SparseEmbedding(10, 4)
        emb.initialize()
        idx = nd.array(np.array([1, 3, 3], np.float32))
        with autograd.record():
            out = emb(idx)
        out.backward()
        grad = emb.weight.grad().asnumpy()
    np.testing.assert_array_equal(out.asnumpy(),
                                  emb.weight.data().asnumpy()[[1, 3, 3]])
    assert grad.shape == (10, 4)
    np.testing.assert_array_equal(grad.sum(1), [0, 4, 0, 8] + [0] * 6)
    assert repr(emb) == "SparseEmbedding(10 -> 4, float32)"


def test_sync_batch_norm_is_batch_norm_on_one_device():
    got = _compare(lambda m: (cnn if m is nn else jcnn).SyncBatchNorm(
        num_devices=1), _x(4, 3, 5, 5, scale=2.0, shift=1.0))
    assert isinstance(cnn.SyncBatchNorm(), nn.BatchNorm)
    assert len(got[2]) == 4


def test_benchmark_score_on_the_cpu():
    from mxnet_tpu_torch.example.image_classification import (
        benchmark_score as bs)

    rate = bs.score("mobilenet0_25", 2, (3, 32, 32), "float32", 0.05,
                    ctx=mx.cpu())
    assert np.isfinite(rate) and rate > 0
    net, x = bs.build("mobilenet0_25", 1, (3, 32, 32), "bfloat16", mx.cpu())
    assert x._data.dtype == torch.bfloat16
    assert all(p.data()._data.dtype == torch.bfloat16
               for p in net.collect_params().values())
    assert net._active  # hybridized
    args = bs.parse_args([])
    assert args.device == "gpu" and args.networks.split(",") == list(
        bs.DEFAULT_NETS)
