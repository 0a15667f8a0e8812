"""The port's ``SequentialModule`` against the JAX package (CPU): the
``tests/test_module.py`` case (two modules, the second taking the labels
and wired to the first's outputs), then on the same weights and batches
forward, backward through the chain (the second module's input gradients
seeding the first) and ``update`` (SGD with momentum) for 3 steps: every
output, the chain's input gradients and every weight equal to JAX's
within ``atol=rtol=2e-5`` (fp32); and the chain's own checks."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.module import Module, SequentialModule

TOL = dict(rtol=2e-5, atol=2e-5)


def _chain(pkg, inputs_need_grad=False, optimizer=True):
    sym = pkg.sym
    net1 = sym.Activation(sym.FullyConnected(sym.var("data"), name="fc1",
                                             num_hidden=8),
                          act_type="tanh", name="act1")
    net2 = sym.SoftmaxOutput(sym.FullyConnected(sym.var("data"), name="fc2",
                                                num_hidden=4),
                             name="softmax")
    mod = pkg.module.SequentialModule()
    mod.add(pkg.module.Module(net1, label_names=None, context=pkg.cpu()))
    mod.add(pkg.module.Module(net2, context=pkg.cpu()),
            take_labels=True, auto_wiring=True)
    mod.bind(data_shapes=[("data", (8, 16))],
             label_shapes=[("softmax_label", (8,))],
             inputs_need_grad=inputs_need_grad)
    mod.init_params(pkg.initializer.Xavier())
    if optimizer:
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
    return mod


def _carry(jmod, tmod):
    """The JAX chain's weights into the port's."""
    for jm, tm in zip(jmod._modules, tmod._modules):
        tm.set_params(*mx.module.params_from_jax(tm, *jm.get_params()))


def _batch(pkg, x, y):
    return pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                            label=[pkg.nd.array(y, ctx=pkg.cpu())])


def test_sequential_module():
    """tests/test_module.py:254 in both packages, on the same weights."""
    jmod = _chain(jmx, optimizer=False)
    tmod = _chain(mx, optimizer=False)
    _carry(jmod, tmod)
    assert tmod.output_shapes == [("softmax_output", (8, 4))]
    assert [m.data_names for m in tmod._modules] == [["data"], ["data"]]
    outs = []
    for pkg, mod in ((jmx, jmod), (mx, tmod)):
        mod.forward(_batch(pkg, np.ones((8, 16), np.float32),
                           np.zeros(8, np.float32)), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    assert outs[1].shape == (8, 4)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_sequential_backward_and_update_match_jax():
    jmod = _chain(jmx, inputs_need_grad=True)
    tmod = _chain(mx, inputs_need_grad=True)
    _carry(jmod, tmod)
    rs = np.random.RandomState(0)
    for _ in range(3):
        x = rs.randn(8, 16).astype(np.float32)
        y = rs.randint(0, 4, 8).astype(np.float32)
        got = []
        for pkg, mod in ((jmx, jmod), (mx, tmod)):
            mod.forward(_batch(pkg, x, y), is_train=True)
            mod.backward()
            # the JAX chain never sets inputs_need_grad, so its own
            # get_input_grads raises AttributeError: read its first
            # module's (the port's chain answers itself)
            first = mod if mod is tmod else mod._modules[0]
            got.append([mod.get_outputs()[0].asnumpy(),
                        first.get_input_grads()[0].asnumpy()])
            mod.update()
        for a, b in zip(got[1], got[0]):
            np.testing.assert_allclose(a, b, **TOL)
        assert np.abs(got[1][1]).sum() > 0
    jarg, _ = jmod.get_params()
    targ, _ = tmod.get_params()
    assert sorted(targ) == sorted(jarg) == [
        "fc1_bias", "fc1_weight", "fc2_bias", "fc2_weight"]
    for k in jarg:
        np.testing.assert_allclose(targ[k].asnumpy(), jarg[k].asnumpy(),
                                   err_msg=k, **TOL)
    metric = mx.metric.Accuracy()
    tmod.update_metric(metric, [mx.nd.array(y, ctx=mx.cpu())])
    assert metric.num_inst == 8


def test_sequential_checks():
    mod = SequentialModule()
    with pytest.raises(MXNetError, match="empty"):
        mod.bind(data_shapes=[("data", (2, 3))])
    with pytest.raises(MXNetError, match="Unknown meta"):
        mod.add(Module(mx.sym.var("data"), label_names=None,
                       context=mx.cpu()), take_label=True)
    net = mx.sym.FullyConnected(mx.sym.var("data"), name="fc", num_hidden=2)
    mod = SequentialModule()
    for _ in range(2):
        mod.add(Module(net, label_names=None, context=mx.cpu()),
                auto_wiring=True)
    mod.bind(data_shapes=[("data", (2, 2))], for_training=False)
    with pytest.raises(MXNetError, match="Duplicated parameter names"):
        mod.init_params()
