"""The port's graph features of slice 20 against the JAX package (CPU):

* ``Executor.reshape``: every array whose shape holds is the old
  executor's own NDArray, the rest new; the outputs on the new shapes
  equal JAX's reshaped executor's; ``output_dict`` and ``debug_str``;
* ``Module.reshape`` keeps the trained weights: outputs equal JAX's on
  the new batch size;
* ``get_states``/``set_states`` (no states) and ``state_names``: a state
  is an input the caller sets, not a parameter, in both packages, and
  the forward with a state set equals JAX's;
* ``simple_bind(shared_exec=)``: the shared arrays are the same objects;
* ``Symbol.grad`` raises, ``copy``/``deepcopy`` give a new graph with the
  same JSON; ``group2ctx`` and ``group2ctxs`` still raise.

fp32 within ``atol=rtol=2e-5``.
"""
import copy

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.module import Module

TOL = dict(rtol=2e-5, atol=2e-5)


def _net(pkg):
    data = pkg.sym.var("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=6, name="fc")
    bn = pkg.sym.BatchNorm(fc, name="bn")
    return pkg.sym.SoftmaxOutput(pkg.sym.Activation(bn, act_type="relu"),
                                 name="softmax")


def _bind(pkg, sym, batch):
    with pkg.name.NameManager():
        ex = sym.simple_bind(pkg.cpu(), data=(batch, 5),
                             softmax_label=(batch,))
    rs = np.random.RandomState(0)
    for name in ("fc_weight", "fc_bias", "bn_gamma", "bn_beta"):
        ex.arg_dict[name][:] = rs.randn(*ex.arg_dict[name].shape).astype(
            np.float32)
    ex.aux_dict["bn_moving_var"][:] = 1.0
    return ex


def test_executor_reshape_keeps_unchanged_arrays():
    jex, tex = _bind(jmx, _net(jmx), 4), _bind(mx, _net(mx), 4)
    jnew, tnew = jex.reshape(data=(7, 5), softmax_label=(7,)), \
        tex.reshape(data=(7, 5), softmax_label=(7,))
    for name in ("fc_weight", "fc_bias", "bn_gamma", "bn_beta"):
        assert tnew.arg_dict[name] is tex.arg_dict[name]
        assert tnew.grad_dict[name] is tex.grad_dict[name]
    for name in tex.aux_names:
        assert tnew.aux_dict[name] is tex.aux_dict[name]
    for name in ("data", "softmax_label"):
        assert tnew.arg_dict[name] is not tex.arg_dict[name]
        assert tnew.arg_dict[name].shape == jnew.arg_dict[name].shape
    x = np.random.RandomState(1).randn(7, 5).astype(np.float32)
    y = np.arange(7, dtype=np.float32) % 6
    outs = []
    for pkg, ex in ((jmx, jnew), (mx, tnew)):
        ex.arg_dict["data"][:] = x
        ex.arg_dict["softmax_label"][:] = y
        ex.forward(is_train=True)
        ex.backward()
        outs.append([ex.outputs[0].asnumpy(),
                     ex.output_dict["softmax_output"].asnumpy(),
                     ex.grad_dict["fc_weight"].asnumpy(),
                     ex.aux_dict["bn_moving_mean"].asnumpy()])
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, **TOL)
    assert sorted(tnew.output_dict) == sorted(jnew.output_dict)
    assert "6 args, 1 outputs" in tnew.debug_str()
    assert "6 args, 1 outputs" in jnew.debug_str()


def test_module_reshape_keeps_trained_weights():
    rs = np.random.RandomState(2)
    x8, y8 = rs.randn(8, 5).astype(np.float32), rs.randint(0, 6, 8)
    x3 = rs.randn(3, 5).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        mod = pkg.module.Module(_net(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[("data", (8, 5))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(pkg.initializer.Xavier())
        if pkg is jmx:  # copies: the JAX dicts follow the training
            start = [{k: v.asnumpy() for k, v in d.items()}
                     for d in mod.get_params()]
        else:
            mod.set_params(*mx.module.params_from_jax(mod, *start))
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
        batch = pkg.io.DataBatch(
            data=[pkg.nd.array(x8, ctx=pkg.cpu())],
            label=[pkg.nd.array(y8.astype(np.float32), ctx=pkg.cpu())])
        mod.forward_backward(batch)
        mod.update()
        mod.get_params()  # the JAX reshape keeps what get_params saw
        mod.reshape(data_shapes=[("data", (3, 5))],
                    label_shapes=[("softmax_label", (3,))])
        assert mod.data_shapes[0][1] == (3, 5)
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x3,
                                                        ctx=pkg.cpu())],
                                     label=None), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    assert outs[1].shape == (3, 6)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_module_reshape_reads_the_executor_first():
    """The port syncs the updated weights before binding anew, with no
    get_params between update and reshape."""
    with mx.cpu():
        mod = Module(_net(mx))
        mod.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.ones((4, 5))], label=[mx.nd.zeros((4,))]))
        mod.update()
        trained = mod._exec_group.execs[0].arg_dict["fc_weight"].asnumpy()
        mod.reshape(data_shapes=[("data", (2, 5))],
                    label_shapes=[("softmax_label", (2,))])
        np.testing.assert_array_equal(
            mod._exec_group.execs[0].arg_dict["fc_weight"].asnumpy(),
            trained)


def _state_net(pkg):
    data, state = pkg.sym.var("data"), pkg.sym.var("state", shape=(2, 4))
    fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
    return pkg.sym.tanh(fc + state)


def test_state_names_and_states():
    x = np.random.RandomState(3).randn(2, 3).astype(np.float32)
    s = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        mod = pkg.module.Module(_state_net(pkg), label_names=None,
                                state_names=["state"], context=pkg.cpu())
        assert mod._param_names == ["fc_weight", "fc_bias"]
        mod.bind(data_shapes=[("data", (2, 3))], for_training=False)
        mod.init_params(pkg.initializer.One())
        assert sorted(mod.get_params()[0]) == ["fc_bias", "fc_weight"]
        assert mod.get_states(merge_multi_context=False) == []
        mod.set_states()
        mod._exec_group.execs[0].arg_dict["state"][:] = s
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                                     label=None))
        outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], np.tanh(x.sum(1, keepdims=True)
                                                + s), **TOL)
    with pytest.raises(MXNetError):
        mod.get_states()
    with pytest.raises(MXNetError):
        mod.set_states(states=[mx.nd.zeros((2, 4), ctx=mx.cpu())])
    with pytest.raises(ValueError):
        Module(_state_net(mx), label_names=None, state_names=["nope"],
               context=mx.cpu())


def test_simple_bind_shared_exec():
    sym = _net(mx)
    base = sym.simple_bind(mx.cpu(), data=(4, 5), softmax_label=(4,))
    other = sym.simple_bind(mx.cpu(), data=(2, 5), softmax_label=(2,),
                            shared_exec=base,
                            shared_arg_names=["fc_weight", "fc_bias"])
    assert other.arg_dict["fc_weight"] is base.arg_dict["fc_weight"]
    assert other.grad_dict["fc_bias"] is base.grad_dict["fc_bias"]
    assert other.arg_dict["bn_gamma"] is not base.arg_dict["bn_gamma"]
    assert other.aux_dict["bn_moving_mean"] is base.aux_dict["bn_moving_mean"]
    assert other.arg_dict["data"] is not base.arg_dict["data"]


def test_symbol_grad_copy_and_group2ctx():
    sym = _net(mx)
    with pytest.raises(MXNetError, match="not supported"):
        sym.grad(["fc_weight"])
    with pytest.raises(jmx.MXNetError, match="not supported"):
        _net(jmx).grad(["fc_weight"])
    for dup in (copy.copy(sym), copy.deepcopy(sym)):
        assert dup.tojson() == sym.tojson()
        assert {id(n) for n in dup._topo_nodes()}.isdisjoint(
            id(n) for n in sym._topo_nodes())
    with pytest.raises(MXNetError, match="group2ctx"):
        sym.simple_bind(mx.cpu(), data=(4, 5), softmax_label=(4,),
                        group2ctx={"a": mx.cpu()})
    with pytest.raises(MXNetError, match="group2ctxs"):
        Module(sym, context=mx.cpu(), group2ctxs={"a": mx.cpu()})
