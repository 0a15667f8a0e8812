"""The port's SVM example (``example/svm_mnist/svm_mnist.py``) against
the JAX example (CPU).

For each head (L2-SVM through ``SquaredHingeLoss``, L1-SVM through
``HingeLoss``, softmax): the same data (the JAX module's ``make_data``),
the same weights (the JAX net's, through ``params_from_jax``), then 3
SGD steps of the port's ``train_step`` against the JAX example's loop
body: each step's mean loss and every weight after the last step within
``rtol=atol=1e-5`` (fp32). Then the port's example at its defaults
reaches its own bar, ``svm heads ALL LEARNED`` (every test accuracy
above 0.8).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.example.svm_mnist import svm_mnist as port

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, STEPS = 32, 3


def _jax_example():
    path = REPO / "example" / "svm_mnist" / "svm_mnist.py"
    spec = importlib.util.spec_from_file_location("jax_svm_mnist", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_SVM = _jax_example()
_LOSS = {"l2svm": "SquaredHingeLoss", "l1svm": "HingeLoss",
         "softmax": "SoftmaxCrossEntropyLoss"}


@pytest.mark.parametrize("kind", port.KINDS)
def test_svm_head_3_steps_match_jax(kind):
    torch.set_num_threads(1)  # a fixed order of the CPU's sums
    rs = np.random.RandomState(31)
    xtr, ytr = JAX_SVM.make_data(BATCH * STEPS, rs)
    pm1 = kind != "softmax"
    batches = [(xtr[i:i + BATCH],
                JAX_SVM.one_hot_pm1(ytr[i:i + BATCH]) if pm1
                else ytr[i:i + BATCH]) for i in range(0, len(xtr), BATCH)]

    jmx.random.seed(7)
    jnet = JAX_SVM.build_net()
    jnet.initialize(jmx.initializer.Xavier())
    jnet(jmx.nd.array(xtr[:1]))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    lossfn = getattr(jmx.gluon.loss, _LOSS[kind])()
    trainer = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-5})
    want = []
    for data, label in batches:  # the JAX example's loop body
        data, label = jmx.nd.array(data), jmx.nd.array(label)
        with jmx.autograd.record():
            loss = lossfn(jnet(data), label)
        loss.backward()
        trainer.step(len(data))
        want.append(float(loss.mean().asscalar()))
    want_params = [p.data().asnumpy()
                   for p in jnet.collect_params().values()]

    with mx.cpu():
        net, lossfn, _, trainer = port.build(kind)
        net(nd.array(xtr[:1]))
        gluon.params_from_jax(net, arrays)
        got = [float(port.train_step(net, lossfn, trainer, nd.array(d),
                                     nd.array(lab)).mean().asscalar())
               for d, lab in batches]
        got_params = [p.data().asnumpy()
                      for p in net.collect_params().values()]
    np.testing.assert_allclose(got, want, **TOL)
    for g, w in zip(got_params, want_params):
        np.testing.assert_allclose(g, w, **TOL)


def test_svm_heads_learn_at_the_defaults(capsys):
    assert port.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("svm heads ALL LEARNED")
