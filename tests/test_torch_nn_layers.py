"""The port's new layers and ops against the JAX package (CPU): forward
and gradient (of the input and of every parameter) of each layer, from
the same weights (``params_from_jax``) on the same numpy inputs, fp32
within 2e-5 (``tests/test_gluon.py:130-186`` are the JAX package's specs).

* BatchNorm in train mode (``record()``) and inference mode, with
  ``scale=False`` (``fix_gamma``), ``use_global_stats``, ``axis``, and the
  moving variance updated with the *biased* variance of a 4-value
  reduction; the ``BatchNorm`` op's three outputs and ``fix_gamma``;
* every conv, transposed conv and pool class, ``ReflectionPad2D``,
  ``Flatten`` and the activations; the ``Pad`` op's three modes and the
  ``LeakyReLU`` op's act types;
* Dropout (whose masks come from a ``torch.Generator``, so they differ
  from the JAX package's): the identity at p = 0 and in inference mode,
  ``mode='always'``, the 1 / (1 - p) scale, the kept share within a
  binomial bound, ``axes`` broadcasting one draw, and its gradient.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # these small CPU shapes gain nothing from torch's thread pool, and
    # under a parallel test run its spinning threads slow every worker
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(layer, x, hg, train, pkg):
    """Forward (recorded) and backward of ``sum(layer(x) * hg)``: the
    output, the input's gradient and {param name: (value, grad)}."""
    xa = pkg.nd.array(x)
    xa.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = layer(xa)
        loss = (out * pkg.nd.array(hg)).sum()
    loss.backward()
    params = {}
    for k, p in layer.collect_params().items():
        grad = p.grad().asnumpy() if p.grad_req != "null" else None
        params[k] = (p.data().asnumpy(), grad)
    return out.asnumpy(), xa.grad.asnumpy(), params


def _compare(make, x, train=True, materialize=None):
    """Build the layer in both packages (``make(nn)``), carry the JAX
    weights over, and compare forward and gradients."""
    x = np.asarray(x, np.float32)
    jlayer = make(jnn)
    jlayer.initialize()
    jlayer(jmx.nd.array(x if materialize is None else materialize))
    arrays = {k: p.data().asnumpy()
              for k, p in jlayer.collect_params().items()}
    with mx.cpu():
        player = make(nn)
        player.initialize()
        gluon.params_from_jax(player, arrays)
        shape = jlayer(jmx.nd.array(x)).shape
        hg = np.random.RandomState(9).randn(*shape).astype(np.float32)
        got = _run(player, x, hg, train, mx)
    want = _run(jlayer, x, hg, train, jmx)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
    assert len(got[2]) == len(want[2])
    for (pk, (pv, pg)), (jk, (jv, jg)) in zip(sorted(got[2].items()),
                                              sorted(want[2].items())):
        assert pk.split("_")[-1] == jk.split("_")[-1]
        np.testing.assert_allclose(pv, jv, rtol=TOL, atol=TOL, err_msg=pk)
        assert (pg is None) == (jg is None), pk
        if pg is not None:
            np.testing.assert_allclose(pg, jg, rtol=TOL, atol=TOL,
                                       err_msg=pk)
    return got


def _x(*shape, seed=0, scale=1.0, shift=0.0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) \
        * scale + shift


LAYERS = {
    "conv1d": (lambda m: m.Conv1D(4, 3, strides=2, padding=1), (2, 3, 9)),
    "conv2d": (lambda m: m.Conv2D(4, 3, strides=(2, 1), padding=1,
                                  dilation=(1, 2)), (2, 3, 8, 8)),
    "conv2d_groups_nobias": (lambda m: m.Conv2D(6, (3, 1), groups=2,
                                                use_bias=False,
                                                activation="relu"),
                             (2, 4, 6, 5)),
    "conv3d": (lambda m: m.Conv3D(2, 2, padding=(1, 0, 1)), (1, 2, 4, 4, 4)),
    "conv1d_transpose": (lambda m: m.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), (2, 4, 5)),
    "conv2d_transpose": (lambda m: m.Conv2DTranspose(
        3, (3, 2), strides=2, padding=(1, 0), output_padding=1),
        (2, 4, 4, 4)),
    "conv2d_transpose_groups": (lambda m: m.Conv2DTranspose(
        4, 3, groups=2, dilation=2), (1, 4, 3, 3)),
    "conv3d_transpose": (lambda m: m.Conv3DTranspose(2, 2, strides=2),
                         (1, 2, 3, 3, 3)),
    "maxpool1d": (lambda m: m.MaxPool1D(3, 2, 1), (2, 3, 9)),
    "maxpool2d_ceil": (lambda m: m.MaxPool2D(3, 2, ceil_mode=True),
                       (2, 3, 8, 8)),
    "maxpool3d": (lambda m: m.MaxPool3D(2), (1, 2, 4, 4, 4)),
    "avgpool1d": (lambda m: m.AvgPool1D(3, 2, 1, count_include_pad=False),
                  (2, 3, 9)),
    "avgpool2d": (lambda m: m.AvgPool2D(3, 2, 1), (2, 3, 7, 7)),
    "avgpool3d": (lambda m: m.AvgPool3D(2, ceil_mode=True),
                  (1, 2, 5, 4, 4)),
    "globalmaxpool1d": (lambda m: m.GlobalMaxPool1D(), (2, 3, 9)),
    "globalmaxpool2d": (lambda m: m.GlobalMaxPool2D(), (2, 3, 5, 6)),
    "globalmaxpool3d": (lambda m: m.GlobalMaxPool3D(), (1, 2, 3, 4, 4)),
    "globalavgpool1d": (lambda m: m.GlobalAvgPool1D(), (2, 3, 9)),
    "globalavgpool2d": (lambda m: m.GlobalAvgPool2D(), (2, 3, 5, 6)),
    "globalavgpool3d": (lambda m: m.GlobalAvgPool3D(), (1, 2, 3, 4, 4)),
    "reflectionpad2d": (lambda m: m.ReflectionPad2D(2), (2, 3, 5, 6)),
    "flatten": (lambda m: m.Flatten(), (2, 3, 4, 5)),
    "leakyrelu": (lambda m: m.LeakyReLU(0.1), (4, 7)),
    "prelu": (lambda m: m.PReLU(alpha_initializer="ones"), (4, 7)),
    "elu": (lambda m: m.ELU(0.7), (4, 7)),
    "selu": (lambda m: m.SELU(), (4, 7)),
    "gelu": (lambda m: m.GELU(), (4, 7)),
    "swish": (lambda m: m.Swish(1.5), (4, 7)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name):
    make, shape = LAYERS[name]
    _compare(make, _x(*shape))


BATCHNORMS = {
    "default": (lambda m: m.BatchNorm(), (4, 3, 5, 5), 1),
    "no_scale_fix_gamma": (lambda m: m.BatchNorm(scale=False), (4, 3, 5, 5),
                           1),
    "no_center_no_scale": (lambda m: m.BatchNorm(scale=False, center=False),
                           (4, 3, 5, 5), 1),
    "use_global_stats": (lambda m: m.BatchNorm(use_global_stats=True),
                         (4, 3, 5, 5), 1),
    "axis_last": (lambda m: m.BatchNorm(axis=-1, momentum=0.5), (4, 5, 3),
                  -1),
    "axis_2_of_4": (lambda m: m.BatchNorm(axis=2, epsilon=1e-3),
                    (2, 3, 4, 5), 2),
    # one value a channel: train mode normalises it to beta (the port's
    # kernel computes x * a + (beta - mean * a), a = gamma / sqrt(var +
    # eps), whose rounding a multiplies where var is 0: epsilon 1e-3
    # keeps that under 2e-5, where 1e-5 reads 4.6e-5 off the JAX's 0)
    "batch_1": (lambda m: m.BatchNorm(epsilon=1e-3), (1, 3), 1),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("name", sorted(BATCHNORMS))
def test_batchnorm_matches_jax(name, train):
    make, shape, axis = BATCHNORMS[name]
    got = _compare(make, _x(*shape, scale=2.0, shift=1.0), train=train)
    params = {k.rsplit("_", 1)[-1] if "running" not in k
              else k.rsplit("_", 2)[-2] + "_" + k.rsplit("_", 1)[-1]: v
              for k, (v, _g) in got[2].items()}
    moved = not np.allclose(params["running_var"], 1.0)
    assert moved == (train and name != "use_global_stats")


def test_batchnorm_running_variance_is_biased_at_a_4_value_reduction():
    # (4, 3): each channel's statistics reduce over 4 values, where the
    # unbiased variance is 4/3 of the biased one
    x = _x(4, 3, scale=3.0)
    got = _compare(lambda m: m.BatchNorm(in_channels=3), x)
    var = {k: v for k, (v, _g) in got[2].items()}
    running_var = next(v for k, v in var.items() if k.endswith("var"))
    biased = x.var(axis=0)
    np.testing.assert_allclose(running_var, 0.9 + 0.1 * biased, rtol=TOL,
                               atol=TOL)
    assert not np.allclose(running_var, 0.9 + 0.1 * x.var(axis=0, ddof=1),
                           rtol=1e-3)


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_op_outputs_and_fix_gamma(fix_gamma):
    x = _x(4, 3, 2, scale=2.0)
    gamma = _x(3, seed=1)
    beta = _x(3, seed=2)
    mean, var = _x(3, seed=3), np.abs(_x(3, seed=4)) + 0.5
    outs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            args = [pkg.nd.array(a) for a in (x, gamma, beta, mean, var)]
            args[0].attach_grad()
            args[1].attach_grad()
            with pkg.autograd.record():
                res = pkg.nd.BatchNorm(*args, fix_gamma=fix_gamma, eps=1e-3)
                loss = (res[0] * res[0]).sum()
            loss.backward()
        outs.append([r.asnumpy() for r in res]
                    + [args[1].grad.asnumpy(), args[0].grad.asnumpy()])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if fix_gamma:
        assert not outs[1][3].any()  # gamma is pinned to 1


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad_op_matches_jax(mode):
    x = _x(2, 3, 4, 5)
    width = (0, 0, 0, 0, 1, 2, 2, 1)
    want = jmx.nd.Pad(jmx.nd.array(x), mode=mode, pad_width=width,
                      constant_value=1.5).asnumpy()
    with mx.cpu():
        got = nd.Pad(nd.array(x), mode=mode, pad_width=width,
                     constant_value=1.5).asnumpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("act", ["leaky", "elu", "selu", "gelu", "rrelu"])
def test_leaky_relu_op_matches_jax(act):
    # rrelu outside train mode uses the bounds' mean slope
    x = _x(3, 8)
    want = jmx.nd.LeakyReLU(jmx.nd.array(x), act_type=act,
                            slope=0.3).asnumpy()
    with mx.cpu():
        got = nd.LeakyReLU(nd.array(x), act_type=act, slope=0.3).asnumpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_rrelu_in_train_mode_draws_slopes_between_the_bounds():
    x = -np.ones((64, 64), np.float32)
    with mx.cpu(), autograd.train_mode():
        y = nd.LeakyReLU(nd.array(x), act_type="rrelu", lower_bound=0.1,
                         upper_bound=0.3).asnumpy()
    slopes = -y
    assert slopes.min() >= 0.1 and slopes.max() <= 0.3
    assert slopes.std() > 0.03  # drawn, not the bounds' mean


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


def _dropout(x, rate, train, axes=(), record=False):
    with mx.cpu():
        layer = nn.Dropout(rate, axes=axes)
        xa = nd.array(x)
        if record:
            xa.attach_grad()
            with autograd.record(train_mode=train):
                y = layer(xa)
                loss = y.sum()
            loss.backward()
            return y.asnumpy(), xa.grad.asnumpy()
        with autograd.train_mode() if train else autograd.predict_mode():
            return layer(xa).asnumpy()


def test_dropout_identity_at_p0_and_in_inference_mode():
    x = _x(8, 16)
    for rate, train in ((0.0, True), (0.5, False)):
        got = _dropout(x, rate, train)
        want = jnn.Dropout(rate)
        with (jmx.autograd.train_mode() if train
              else jmx.autograd.predict_mode()):
            want = want(jmx.nd.array(x)).asnumpy()
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(got, want)


def test_dropout_mode_always_drops_in_inference_mode():
    x = np.ones((64, 64), np.float32)
    with mx.cpu(), autograd.predict_mode():
        y = nd.Dropout(nd.array(x), p=0.5, mode="always").asnumpy()
    assert 0 < (y == 0).sum() < y.size


def test_dropout_scale_share_and_gradient():
    rate, n = 0.3, 20000
    x = np.arange(1, n + 1, dtype=np.float32).reshape(100, 200)
    y, g = _dropout(x, rate, True, record=True)
    kept = y != 0
    np.testing.assert_allclose(y[kept], x[kept] / (1 - rate), rtol=1e-6)
    # kept share ~ Binomial(n, 0.7) / n: within 5 standard deviations
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(kept.mean() - (1 - rate)) < 5 * sigma
    # d(sum y) / dx = mask / (1 - p)
    np.testing.assert_allclose(g, kept / (1 - rate), rtol=1e-6)


def test_dropout_axes_share_one_draw():
    x = np.ones((8, 16, 4), np.float32)
    y = _dropout(x, 0.5, True, axes=(1,))
    for b in range(8):
        for c in range(4):
            col = y[b, :, c]
            assert (col == col[0]).all()
    assert 0 < (y == 0).sum() < y.size
