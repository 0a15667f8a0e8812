"""The port's Symbol and Executor against the JAX package (CPU), on the
SSD example's training symbol built by each package's
``example/ssd/train_ssd.py`` (the JAX one loaded by file).

* ``list_arguments/outputs/auxiliary_states`` and ``infer_shape`` equal;
  ``tojson`` equal between the packages and round-tripping;
* ``simple_bind`` forward and backward on the same weights and batch:
  every output within 1e-4 (the detection output's suppressed rows
  exactly), every weight gradient within 1e-4 (fp32; the convolution
  backward sums in another order);
* the executor's ``grad_req``: ``add`` accumulates, ``null`` leaves no
  gradient, and a second backward without a forward raises;
* the operator sugar builds the ops the JAX package names;
* ``Convolution`` and ``Pooling`` (max, avg, sum, global, ``full``
  convention, ``count_include_pad``) against the JAX ops (1e-5: the
  convolutions sum in another order).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.example.ssd import train_ssd as port_ssd

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = dict(data=(2, 3, 32, 32), label=(2, 2, 5))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_ssd", REPO / "example" / "ssd" / "train_ssd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def symbols():
    # each under a fresh NameManager: the unnamed ops' names (transpose0,
    # ...) count from 0 whatever symbols the process made before
    with jmx.name.NameManager():
        jsym = _jax_example().get_symbol_train(3)
    with mx.name.NameManager():
        tsym = port_ssd.get_symbol_train(3)
    return jsym, tsym


def test_ssd_symbol_lists_shapes_and_json_match(symbols):
    jsym, tsym = symbols
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert "conv1_weight" in tsym.list_arguments()
    assert tsym.infer_shape(**SHAPES) == jsym.infer_shape(**SHAPES)
    js = tsym.tojson()
    assert json.loads(js) == json.loads(jsym.tojson())
    again = mx.sym.load_json(js)
    assert again.tojson() == js
    assert again.infer_shape(**SHAPES) == tsym.infer_shape(**SHAPES)
    # and a graph the JAX package wrote loads here
    assert mx.sym.load_json(jsym.tojson()).tojson() == js


def _inputs(sym):
    rs = np.random.RandomState(0)
    args = {n: (rs.randn(*s) * 0.1).astype(np.float32) for n, s in
            zip(sym.list_arguments(), sym.infer_shape(**SHAPES)[0])}
    args["data"] = rs.randn(*SHAPES["data"]).astype(np.float32)
    args["label"] = np.array(
        [[[0, .1, .1, .5, .5], [2, .4, .3, .9, .8]],
         [[1, .2, .2, .6, .7], [-1, -1, -1, -1, -1]]], np.float32)
    return args


def test_ssd_forward_backward_matches_jax(symbols):
    jsym, tsym = symbols
    args = _inputs(jsym)
    jex = jsym.simple_bind(jmx.cpu(), **SHAPES)
    tex = tsym.simple_bind(mx.cpu(), grad_req={
        n: "null" if n in ("data", "label") else "write"
        for n in tsym.list_arguments()}, **SHAPES)
    for name, value in args.items():
        jex.arg_dict[name][:] = value
        tex.arg_dict[name]._data = mx.nd.array(value, ctx=mx.cpu())._data
    jout = [o.asnumpy() for o in jex.forward(is_train=True)]
    jex.backward()
    tout = [o.asnumpy() for o in tex.forward(is_train=True)]
    tex.backward()
    for name, got, want in zip(tsym.list_outputs(), tout, jout):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    det, jdet = tout[3], jout[3]
    np.testing.assert_array_equal(det[..., 0] == -1, jdet[..., 0] == -1)
    weights = [n for n in tsym.list_arguments()
               if n not in ("data", "label")]
    assert set(tex.grad_dict) == set(weights)
    for name in weights:
        np.testing.assert_allclose(tex.grad_dict[name].asnumpy(),
                                   jex.grad_dict[name].asnumpy(),
                                   err_msg=name, **TOL)
    assert np.abs(tex.grad_dict["conv1_weight"].asnumpy()).max() > 0


def test_executor_grad_req_write_add_null():
    x, w = mx.sym.var("x"), mx.sym.var("w")
    y = mx.sym.MakeLoss(mx.sym.smooth_l1(x * w, scalar=1.0))
    xv = np.array([0.5, -2.0, 3.0], np.float32)
    wv = np.array([1.0, 0.5, -0.1], np.float32)
    with mx.cpu():
        ex = y.simple_bind(mx.cpu(), grad_req={"x": "null", "w": "add"},
                           x=(3,), w=(3,))
        ex.arg_dict["x"]._data = mx.nd.array(xv)._data
        ex.arg_dict["w"]._data = mx.nd.array(wv)._data
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
    assert set(ex.grad_dict) == {"w"}
    z = xv * wv  # d smooth_l1(z) / dz is z inside 1, sign(z) outside
    dz = np.where(np.abs(z) < 1, z, np.sign(z))
    np.testing.assert_allclose(ex.grad_dict["w"].asnumpy(), 2 * dz * xv,
                               rtol=1e-6)
    with pytest.raises(MXNetError, match="fresh forward"):
        ex.backward()
    ex.forward(is_train=False)
    with pytest.raises(MXNetError, match="fresh forward"):
        ex.backward()


def test_operator_sugar_names_the_jax_ops():
    a, b = mx.sym.var("a"), mx.sym.var("b")
    cases = [(a + b, "elemwise_add"), (a - 1, "_minus_scalar"),
             (1 - a, "_rminus_scalar"), (a * 2, "_mul_scalar"),
             (a / b, "elemwise_div"), (2 / a, "_rdiv_scalar"),
             (a ** 2, "_power_scalar"), (a > 0, "_greater_scalar"),
             (a == b, "broadcast_equal"), (a % 3, "_mod_scalar"),
             (-a, "negative")]
    av = np.array([1.0, -2.0, 3.0], np.float32)
    bv = np.array([2.0, -2.0, 0.5], np.float32)
    for s, op in cases:
        assert s._outputs[0][0].op == op
        feed = {k: v for k, v in (("a", av), ("b", bv))
                if k in s.list_arguments()}
        with mx.cpu():
            got = s.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in
                                    feed.items()}).forward()[0].asnumpy()
        jsym = {"a": jmx.sym.var("a"), "b": jmx.sym.var("b")}
        want = eval_jax(op, jsym, feed)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=op)


def eval_jax(op, jsym, feed):
    """The same expression built and run by the JAX package."""
    a, b = jsym["a"], jsym["b"]
    s = {"elemwise_add": a + b, "_minus_scalar": a - 1,
         "_rminus_scalar": 1 - a, "_mul_scalar": a * 2,
         "elemwise_div": a / b, "_rdiv_scalar": 2 / a,
         "_power_scalar": a ** 2, "_greater_scalar": a > 0,
         "broadcast_equal": a == b, "_mod_scalar": a % 3,
         "negative": -a}[op]
    ex = s.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in feed.items()})
    return ex.forward()[0].asnumpy()


@pytest.mark.parametrize("kw", [
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False, pooling_convention="full"),
    dict(kernel=(2, 3), stride=(1, 2), pool_type="sum"),
    dict(global_pool=True, pool_type="avg"),
    dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="avg"),
])
def test_pooling_matches_jax(kw):
    shape = (2, 3, 7) if len(kw.get("kernel", (0, 0))) == 1 \
        else (2, 3, 7, 9)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = jmx.nd.Pooling(jmx.nd.array(x), **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.Pooling(mx.nd.array(x), **kw).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), pad=(1, 1), num_filter=4),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=4,
         no_bias=True),
    dict(kernel=(3, 3), dilate=(2, 2), num_filter=6, num_group=3),
])
def test_convolution_matches_jax(kw):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 8, 8).astype(np.float32)
    w = rs.randn(kw["num_filter"], 3 // kw.get("num_group", 1),
                 3, 3).astype(np.float32)
    args = [x, w] if kw.get("no_bias") else \
        [x, w, rs.randn(kw["num_filter"]).astype(np.float32)]
    want = jmx.nd.Convolution(*[jmx.nd.array(a) for a in args],
                              **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.Convolution(*[mx.nd.array(a) for a in args],
                                **kw).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _param_op(pkg, which):
    data = pkg.sym.var("data")
    if which == "deconv":
        out = pkg.sym.Deconvolution(data, kernel=(2, 2), stride=(2, 2),
                                    num_filter=2, name="dc")
    else:
        out = pkg.sym.LeakyReLU(data, act_type="prelu", name="pr")
    return out, pkg.sym.make_loss(pkg.sym.sum(pkg.sym.square(out)))


def _module_step(pkg, which, x, weights, ctx):
    out, net = _param_op(pkg, which)
    mod = pkg.mod.Module(net, data_names=("data",), label_names=None,
                         context=ctx)
    mod.bind(data_shapes=[("data", x.shape)])
    mod.init_params()
    mod.set_params({k: pkg.nd.array(v, ctx=ctx) for k, v in weights.items()},
                   {})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01})
    mod.forward_backward(pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=ctx)],
                                          label=None))
    mod.update()
    loss = mod.get_outputs()[0].asnumpy()
    return loss, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("which,param,shape,out_shape", [
    ("deconv", "dc_weight", (3, 2, 2, 2), (2, 2, 12, 12)),
    ("prelu", "pr_gamma", (3,), (2, 3, 6, 6)),
])
def test_deconvolution_and_prelu_shapes_fill_as_in_jax(which, param, shape,
                                                       out_shape):
    # the port's _fill_param_shapes left both unfilled, so simple_bind and
    # Module.bind failed on any symbol holding either op
    out, _ = _param_op(mx, which)
    jout, _ = _param_op(jmx, which)
    got = out.infer_shape(data=(2, 3, 6, 6))
    want = jout.infer_shape(data=(2, 3, 6, 6))
    assert got == want
    args = dict(zip(out.list_arguments(), got[0]))
    assert args[param] == shape and got[1] == [out_shape]
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3, 6, 6).astype(np.float32)
    weights = {param: rs.uniform(0.1, 0.5, shape).astype(np.float32)}
    want_loss, want_params = _module_step(jmx, which, x, weights, jmx.cpu())
    got_loss, got_params = _module_step(mx, which, x, weights, mx.cpu())
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-5, atol=2e-5)
    assert sorted(got_params) == sorted(want_params) == [param]
    np.testing.assert_allclose(got_params[param], want_params[param],
                               rtol=2e-5, atol=2e-5)
    assert not np.allclose(got_params[param], weights[param])  # it moved
