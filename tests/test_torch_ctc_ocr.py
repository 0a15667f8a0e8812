"""The port's CTC OCR example (``example/ctc/lstm_ocr.py``) against the
JAX example (CPU).

The same data (the JAX module's ``make_data``) and the same weights (the
JAX net's, through ``params_from_jax``); then 3 Adam steps of the port's
``train_step`` against the JAX example's loop body at batch 16: each
step's mean loss and every weight after the last step within
``rtol=atol=1e-5`` (fp32), and the best-path decode of the test batch
equal. The example at its defaults is in
``test_torch_ctc_ocr_defaults.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.example.ctc import lstm_ocr as port

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, STEPS = 16, 3


def _jax_example():
    path = REPO / "example" / "ctc" / "lstm_ocr.py"
    spec = importlib.util.spec_from_file_location("jax_lstm_ocr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_OCR = _jax_example()


def test_ocr_3_steps_match_jax():
    torch.set_num_threads(1)  # a fixed order of the CPU's sums
    rs = np.random.RandomState(21)
    xtr, ytr = JAX_OCR.make_data(BATCH * STEPS, rs)
    xte, _ = JAX_OCR.make_data(8, rs)
    batches = [(xtr[i:i + BATCH], ytr[i:i + BATCH])
               for i in range(0, len(xtr), BATCH)]

    jmx.random.seed(7)
    jnet = JAX_OCR.OCRNet()
    jnet.initialize(jmx.initializer.Xavier())
    jnet(jmx.nd.array(xtr[:1]))  # the deferred shapes
    arrays = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    lossfn = jmx.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
    trainer = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                                {"learning_rate": 3e-3})
    want = []
    for data, label in batches:  # the JAX example's loop body
        data, label = jmx.nd.array(data), jmx.nd.array(label)
        with jmx.autograd.record():
            loss = lossfn(jnet(data), label)
        loss.backward()
        trainer.step(data.shape[0])
        want.append(float(loss.mean().asscalar()))
    want_params = [p.data().asnumpy()
                   for p in jnet.collect_params().values()]
    want_decode = JAX_OCR.best_path_decode(
        jnet(jmx.nd.array(xte)).asnumpy())

    with mx.cpu():
        net, lossfn, trainer = port.build()
        net(nd.array(xtr[:1]))
        gluon.params_from_jax(net, arrays)
        got = [float(port.train_step(net, lossfn, trainer, nd.array(d),
                                     nd.array(lab)).mean().asscalar())
               for d, lab in batches]
        got_params = [p.data().asnumpy()
                      for p in net.collect_params().values()]
        got_decode = port.best_path_decode(net(nd.array(xte)).asnumpy())
    np.testing.assert_allclose(got, want, **TOL)
    assert len(got_params) == len(want_params)
    for g, w in zip(got_params, want_params):
        np.testing.assert_allclose(g, w, **TOL)
    assert got_decode == want_decode
