"""The numpy-op example's whole slice in both packages (CPU).

The JAX example (``example/numpy-ops/custom_softmax.py``, loaded by
file) and the port's (``mxnet_tpu_torch/example/numpy_ops/``) at a test
size (batch 64, three steps), seeded alike (``mx.random.seed(7)``,
``RandomState(19)``): the same data and permutation, the JAX net's
initial weights carried into the port's by ``gluon.params_from_jax``,
SGD lr 0.2 with momentum 0.9. Each step's ``prob`` and every weight
after it agree within 1e-5 (fp32 on the CPU; the dense layers sum in
other orders, and the momentum carries those differences on).

Then the port's ``run()`` at a small size on the CPU: it learns.
"""
import importlib.util
from pathlib import Path

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.example.numpy_ops import custom_softmax as port_cs

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_custom_softmax",
        REPO / "example" / "numpy-ops" / "custom_softmax.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # registers np_softmax_ce with the JAX one
    return mod


def test_three_steps_match_jax():
    jex = _jax_example()
    rs = np.random.RandomState(19)
    xtr, ytr = port_cs.make_data(256, rs)
    np.testing.assert_array_equal(
        xtr, jex.make_data(256, np.random.RandomState(19))[0])
    perm = rs.permutation(len(xtr))

    jmx.random.seed(7)
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(128, activation="relu"),
             jmx.gluon.nn.Dense(10))
    jnet.initialize(jmx.initializer.Xavier())
    jtrainer = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                 {"learning_rate": 0.2, "momentum": 0.9})
    jnet(jmx.nd.array(xtr[:2]))  # resolve the deferred shapes

    with mx.cpu():
        mx.random.seed(7)
        tnet, ttrainer = port_cs.build()
        tnet(mx.nd.array(xtr[:2]))
        mx.gluon.params_from_jax(tnet, {
            k: p.data().asnumpy()
            for k, p in jnet.collect_params().items()})
        for step in range(3):
            idx = perm[step * 64:(step + 1) * 64]
            data, label = jmx.nd.array(xtr[idx]), jmx.nd.array(ytr[idx])
            with jmx.autograd.record():
                jprob = jmx.nd.Custom(jnet(data), label,
                                      op_type="np_softmax_ce")
            jprob.backward()
            jtrainer.step(1)
            tprob = port_cs.train_step(tnet, ttrainer, xtr[idx], ytr[idx])
            np.testing.assert_allclose(tprob.asnumpy(), jprob.asnumpy(),
                                       **TOL)
            for tp, jp in zip(tnet.collect_params().values(),
                              jnet.collect_params().values()):
                np.testing.assert_allclose(tp.data().asnumpy(),
                                           jp.data().asnumpy(), **TOL)


def test_run_learns_on_the_cpu():
    res = port_cs.run(port_cs.parse_args(
        ["--device", "cpu", "--epochs", "1", "--train-size", "512"]))
    assert res["steps"] == 8
    assert res["learned"] and res["test_acc"] > 0.9
    assert len(res["train_acc"]) == 1 and res["step_ms"] > 0
