"""The port's sparse examples (``example/sparse/linear_classification.py``
and ``fm.py``) against the JAX examples (CPU).

3 steps of each from the same data: the port's ``run(args,
max_steps=3)`` against the JAX example's loop body (its ``main``), built
from the JAX module's own data functions: every step's loss and the
weights after the last step within ``rtol=atol=1e-5`` (fp32); FM with
SGD, AdaGrad and Adam. Then each runs on the CPU at its defaults and
reaches its own bar (``IMPROVED``; FM with SGD at the JAX package's own
test arguments, ``tests/test_sparse_ops.py::test_fm_training_converges``:
at the defaults SGD with momentum diverges in both packages).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu_torch.example.sparse import fm as port_fm
from mxnet_tpu_torch.example.sparse import linear_classification as port_lc

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_example(name):
    path = REPO / "example" / "sparse" / (name + ".py")
    spec = importlib.util.spec_from_file_location("jax_sparse_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_LC = _jax_example("linear_classification")
JAX_FM = _jax_example("fm")


def _jax_lc_steps(path, dim, batch_size, lr, steps):
    """The JAX example's loop body, verbatim but for the step count."""
    mxs = jmx.nd.sparse
    it = jmx.io.LibSVMIter(data_libsvm=path, data_shape=dim,
                           batch_size=batch_size)
    w = jmx.nd.zeros((dim, 1))
    b = jmx.nd.zeros((1,))
    w.attach_grad()
    b.attach_grad()
    opt = jmx.optimizer.create("sgd", learning_rate=lr,
                               rescale_grad=1.0 / batch_size)
    states = {i: opt.create_state(i, p) for i, p in enumerate((w, b))}
    losses = []
    for batch in it:
        x = batch.data[0]
        y = batch.label[0].reshape((-1, 1))
        with jmx.autograd.record():
            score = mxs.dot(x, w) + b
            loss = (jmx.nd.relu(score) - score * y
                    + jmx.nd.log(1 + jmx.nd.exp(-jmx.nd.abs(score)))).sum()
        loss.backward()
        for i, p in enumerate((w, b)):
            states[i] = opt.update(i, p, p.grad, states[i])
        losses.append(float(loss.asnumpy()))
        if len(losses) == steps:
            break
    return losses, w.asnumpy(), b.asnumpy()


def test_linear_classification_3_steps_match_jax(tmp_path):
    path = str(tmp_path / "train.libsvm")
    JAX_LC.make_libsvm(path, 192, 300, 0.02, np.random.RandomState(7))
    want = _jax_lc_steps(path, 300, 64, 3.0, 3)
    args = port_lc.parse_args(["--device", "cpu", "--data", path,
                               "--feature-dim", "300", "--epochs", "1"])
    res = port_lc.run(args, max_steps=3)
    np.testing.assert_allclose(res["losses"], want[0], **TOL)
    np.testing.assert_allclose(res["model"].w.asnumpy(), want[1], **TOL)
    np.testing.assert_allclose(res["model"].b.asnumpy(), want[2], **TOL)


def _jax_fm_steps(args, steps):
    """The JAX example's loop body, verbatim but for the step count."""
    mxs, nd = jmx.nd.sparse, jmx.nd
    rs = np.random.RandomState(42)
    x_np, y_np = JAX_FM.make_data(args.num_samples, args.feature_dim,
                                  args.density, rs)
    w1 = nd.array(0.01 * rs.randn(args.feature_dim, 1).astype(np.float32))
    b = nd.zeros((1,))
    v = nd.array(0.01 * rs.randn(args.feature_dim,
                                 args.factor_size).astype(np.float32))
    for p in (w1, b, v):
        p.attach_grad()
    lr = {"sgd": 0.05, "adam": 0.02, "adagrad": 0.1}[args.optimizer]
    kw = {"momentum": 0.9} if args.optimizer == "sgd" else {}
    opt = jmx.optimizer.create(args.optimizer, learning_rate=lr,
                               clip_gradient=5.0,
                               rescale_grad=1.0 / args.batch_size, **kw)
    states = {i: opt.create_state(i, p) for i, p in enumerate((w1, b, v))}
    losses = []
    for k in range(steps):
        sl = slice(k * args.batch_size, (k + 1) * args.batch_size)
        x_csr = mxs.cast_storage(nd.array(x_np[sl]), "csr")
        y = nd.array(y_np[sl])
        with jmx.autograd.record():
            pred = JAX_FM.fm_forward(x_csr, w1, b, v)
            loss = ((pred - y) ** 2).sum()
        loss.backward()
        for i, p in enumerate((w1, b, v)):
            states[i] = opt.update(i, p, p.grad, states[i])
        losses.append(float(loss.asnumpy()))
    return losses, [p.asnumpy() for p in (w1, b, v)]


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_fm_3_steps_match_jax(optimizer):
    args = port_fm.parse_args(["--device", "cpu", "--optimizer", optimizer,
                               "--num-samples", "192", "--feature-dim",
                               "200", "--epochs", "1"])
    want_losses, want_params = _jax_fm_steps(args, 3)
    res = port_fm.run(args, max_steps=3)
    np.testing.assert_allclose(res["losses"], want_losses, **TOL)
    for got, want in zip(res["model"].params, want_params):
        np.testing.assert_allclose(got.asnumpy(), want, **TOL)


@pytest.mark.parametrize("argv", [
    ["--optimizer", "adagrad"],
    ["--optimizer", "sgd", "--epochs", "12", "--num-samples", "192",
     "--feature-dim", "300"]])
def test_fm_reaches_its_bar(argv, capsys):
    assert port_fm.main(["--device", "cpu"] + argv) == 0
    assert "IMPROVED" in capsys.readouterr().out


def test_linear_classification_reaches_its_bar_at_defaults(capsys):
    assert port_lc.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("IMPROVED")
