"""Custom operators, autograd.Function and the torch bridge against the
JAX package (CPU).

* the three Custom-op tests of ``tests/test_vision_ops.py`` (eager
  forward and backward, ``sym.Custom`` through ``simple_bind``, an
  unregistered op) run in both packages on the same numbers: results
  equal within 1e-6 (fp32, the same arithmetic);
* ``infer_shape`` of a Custom loss node back-fills its label from the
  prop (``custom_softmax.py``'s ``[in_shape[0][0]]``); the JAX package
  cannot (it raises "insufficient information"), so the shapes are held
  against the JAX package's with the label given;
* ``autograd.Function`` (the Sigmoid of ``tests/test_autograd.py``)
  against the JAX package's, 1e-6;
* ``contrib.torch_bridge.TorchFunction`` around one ``torch.nn.Linear``
  against the JAX package's bridge: outputs, the input's gradient and
  the Linear's parameter gradients, 1e-6.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.example.numpy_ops import custom_softmax as port_cs

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-6, atol=1e-6)
OP = "torch_parity_square"


def _square_op(pkg):
    class Square(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2.0 * in_data[0] * out_grad[0])

    @pkg.operator.register(OP)
    class SquareProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Square()


_square_op(jmx)
_square_op(mx)


def test_custom_op_eager_forward_backward_matches_jax():
    xn = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    res = []
    for pkg, scope in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        with scope:
            x = pkg.nd.array(xn)
            x.attach_grad()
            with pkg.autograd.record():
                y = pkg.nd.Custom(x, op_type=OP)
                loss = pkg.nd.sum(y)
            loss.backward()
        res.append((y.asnumpy(), x.grad.asnumpy()))
    (jy, jg), (ty, tg) = res
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    np.testing.assert_allclose(tg, 2 * xn, **TOL)


def test_custom_op_symbolic_simple_bind_matches_jax():
    dn = np.array([[1, 2], [3, 4]], np.float32)
    res = []
    for pkg in (jmx, mx):
        d = pkg.sym.var("d")
        s = pkg.sym.Custom(d, op_type=OP)
        ex = s.simple_bind(pkg.cpu(), d=(2, 2))
        ex.arg_dict["d"][:] = dn
        out = ex.forward(is_train=True)[0]
        ex.backward()
        res.append((out.asnumpy(), ex.grad_dict["d"].asnumpy()))
    (jo, jg), (to, tg) = res
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    np.testing.assert_allclose(to, dn * dn, **TOL)


def test_custom_op_unregistered_raises_like_jax():
    with pytest.raises(jmx.MXNetError, match="not registered"):
        jmx.nd.Custom(jmx.nd.ones((2,)), op_type="nope")
    with mx.cpu(), pytest.raises(MXNetError, match="not registered"):
        mx.nd.Custom(mx.nd.ones((2,)), op_type="nope")


def _jax_custom_softmax():
    spec = importlib.util.spec_from_file_location(
        "jax_custom_softmax",
        REPO / "example" / "numpy-ops" / "custom_softmax.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # registers np_softmax_ce with the JAX one
    return mod


def _mlp(pkg):
    data, label = pkg.sym.var("data"), pkg.sym.var("softmax_label")
    fc = pkg.sym.FullyConnected(data, num_hidden=10, name="fc")
    return pkg.sym.Custom(fc, label, op_type="np_softmax_ce", name="sm")


def test_custom_infer_shape_backfills_the_label():
    _jax_custom_softmax()
    assert port_cs.NpSoftmaxCEProp  # registered with the port
    ours = _mlp(mx).infer_shape(data=(6, 7))
    with pytest.raises(jmx.MXNetError, match="insufficient"):
        _mlp(jmx).infer_shape(data=(6, 7))
    theirs = _mlp(jmx).infer_shape(data=(6, 7), softmax_label=(6,))
    assert _mlp(mx).list_arguments() == _mlp(jmx).list_arguments()
    assert _mlp(mx).list_outputs() == _mlp(jmx).list_outputs()
    assert [list(map(tuple, x)) for x in ours] == \
        [list(map(tuple, x)) for x in theirs]
    assert ours[0][-1] == (6,)  # the label, from the prop


def test_autograd_function_matches_jax():
    xn = np.random.RandomState(2).uniform(-1, 1, (5,)).astype(np.float32)
    res = []
    for pkg, scope in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = pkg.nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        with scope:
            x = pkg.nd.array(xn)
            x.attach_grad()
            with pkg.autograd.record():
                y = Sigmoid()(x)
            y.backward()
            # outside record() the forward runs alone
            z = Sigmoid()(pkg.nd.array(xn))
        res.append((y.asnumpy(), x.grad.asnumpy(), z.asnumpy()))
    for ours, theirs in zip(res[1], res[0]):
        np.testing.assert_allclose(ours, theirs, **TOL)
    s = 1 / (1 + np.exp(-xn))
    np.testing.assert_allclose(res[1][1], s * (1 - s), rtol=1e-5, atol=1e-6)


def test_torch_function_matches_jax_bridge():
    from mxnet_tpu.contrib import torch_bridge as jtb
    from mxnet_tpu_torch.contrib import torch_bridge as ttb

    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    lin_j = torch.nn.Linear(4, 3)
    lin_j.load_state_dict(lin.state_dict())
    xn = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    res = []
    for pkg, bridge, module, scope in ((jmx, jtb, lin_j, jmx.cpu()),
                                       (mx, ttb, lin, mx.cpu())):
        with scope:
            x = pkg.nd.array(xn)
            x.attach_grad()
            block = bridge.TorchBlock(module)
            with pkg.autograd.record():
                y = block(x)
                loss = pkg.nd.sum(y * y)
            loss.backward()
        res.append((y.asnumpy(), x.grad.asnumpy(),
                    [p.grad.numpy().copy() for p in module.parameters()]))
    (jy, jg, jp), (ty, tg, tp) = res
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    for ours, theirs in zip(tp, jp):
        np.testing.assert_allclose(ours, theirs, **TOL)
    with pytest.raises(MXNetError, match="torch.nn.Module"):
        ttb.TorchBlock(lambda v: v)
