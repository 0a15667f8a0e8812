"""The port's MNIST example (``example/image_classification/
train_mnist.py`` through ``common/fit.py``) against the JAX example
(CPU), seeded alike: the same logged accuracies and final weights within
1e-4 for the mlp and LeNet at 640 examples and 1 epoch, with 2-bit
gradient compression, and after a ``--load-epoch`` resume; the kvstore
object demotes the module plane once (``module-config``) and every batch
pushes and pulls each parameter once; ``gluon.Trainer`` with a
``KVStore`` object, with and without ``update_on_kvstore``, steps as the
JAX Trainer does; ``main`` runs on the CPU.
"""
import importlib.util
import logging
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.example.image_classification import train_mnist
from mxnet_tpu_torch.example.image_classification.common import fit
from mxnet_tpu_torch.kvstore import OPS
from mxnet_tpu_torch.trainplane import FALLBACKS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLE = os.path.join(REPO, "example", "image-classification")
TOL = 1e-4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_example():
    """The JAX example's ``fit``, ``get_mnist_iter`` and symbols."""
    sys.path.insert(0, JAX_EXAMPLE)
    try:
        tm = _load("_jax_train_mnist", os.path.join(JAX_EXAMPLE,
                                                    "train_mnist.py"))
        jfit = sys.modules["common.fit"]
        nets = {n: _load("_jax_" + n, os.path.join(JAX_EXAMPLE, "symbols",
                                                   n + ".py"))
                for n in ("mlp", "lenet")}
    finally:
        sys.path.remove(JAX_EXAMPLE)
    return jfit, tm, nets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Log(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run(package, argv, example, seed=3):
    """``fit.fit`` of the port (``package == "port"``) or the JAX example
    on ``argv``; returns (module, accuracy lines, monitor lines)."""
    args = train_mnist.parse_args(argv)
    log = _Log()
    root = logging.getLogger()
    root.addHandler(log)
    level = root.level
    root.setLevel(logging.INFO)
    try:
        if package == "port":
            mx.random.seed(seed)
            with mx.cpu():
                mod = fit.fit(args, train_mnist.get_symbol(args),
                              train_mnist.get_mnist_iter)
        else:
            jfit, tm, nets = example
            jmx.random.seed(seed)
            mod = jfit.fit(args, nets[args.network].get_symbol(
                num_classes=10), tm.get_mnist_iter)
    finally:
        root.removeHandler(log)
        root.setLevel(level)
    acc = [line.split("=")[-1] for line in log.lines if "accuracy=" in line
           and "Epoch[" in line and "Batch" not in line]
    mon = [line.split()[-1] for line in log.lines if line.startswith("Batch:")]
    return mod, [float(a) for a in acc], [float(v) for v in mon]


def _same_params(mod, jmod, tol=TOL):
    args, _ = mod.get_params()
    jargs, _ = jmod.get_params()
    assert sorted(args) == sorted(jargs)
    for name in args:
        np.testing.assert_allclose(args[name].asnumpy(),
                                   jargs[name].asnumpy(), rtol=tol, atol=tol,
                                   err_msg=name)


BASE = ["--num-examples", "640", "--num-epochs", "1"]


@pytest.mark.parametrize("extra", [
    ["--network", "mlp"], ["--network", "lenet"],
    ["--network", "mlp", "--gc-type", "2bit", "--monitor", "3"],
    ["--network", "mlp", "--optimizer", "adam", "--lr", "0.001"],
], ids=["mlp", "lenet", "mlp_2bit_monitor", "mlp_adam"])
def test_fit_matches_the_jax_example(jax_example, extra):
    push, pull = OPS.value(op="push"), OPS.value(op="pull")
    demoted = FALLBACKS.value(reason="module-config")
    mod, acc, mon = _run("port", BASE + extra, jax_example)
    steps = 10  # 640 examples, batch 64
    n_params = len(mod._exec_group.param_names)
    assert OPS.value(op="push") - push == steps * n_params
    assert OPS.value(op="pull") - pull == steps * n_params
    if "--monitor" not in extra:
        # the kvstore object keeps the step off the module plane
        assert FALLBACKS.value(reason="module-config") - demoted == 1
    assert mod._update_on_kvstore and mod._updater is None
    jmod, jacc, jmon = _run("jax", BASE + extra, jax_example)
    assert len(acc) == len(jacc) == 2  # train and validation
    np.testing.assert_allclose(acc, jacc, atol=TOL)
    np.testing.assert_allclose(mon, jmon, rtol=1e-5, atol=1e-5)
    _same_params(mod, jmod)


def test_load_epoch_resume_matches_the_jax_example(jax_example, tmp_path):
    out = {}
    for package in ("port", "jax"):
        prefix = str(tmp_path / package / "mnist")
        # epoch 1's checkpoint, then a resumed second epoch
        _run(package, BASE + ["--model-prefix", prefix], jax_example)
        assert os.path.exists(prefix + "-0001.params")
        out[package] = _run(package, [
            "--num-examples", "640", "--num-epochs", "2",
            "--model-prefix", prefix, "--load-epoch", "1"], jax_example)
    (mod, acc, _), (jmod, jacc, _) = out["port"], out["jax"]
    assert len(acc) == 2  # one epoch run: train and validation
    np.testing.assert_allclose(acc, jacc, atol=TOL)
    _same_params(mod, jmod)


def test_resume_starts_where_the_run_left_off(jax_example, tmp_path):
    """The resumed run's first batch sees the weights the uninterrupted
    run had at the start of its second epoch."""
    prefix = str(tmp_path / "mnist")
    per_epoch = 10
    monitor = ["--monitor", str(per_epoch)]
    _, _, whole = _run("port", ["--num-examples", "640", "--num-epochs",
                                "2", "--model-prefix", prefix] + monitor,
                       jax_example)
    _, _, resumed = _run("port", ["--num-examples", "640", "--num-epochs",
                                  "2", "--model-prefix", prefix,
                                  "--load-epoch", "1"] + monitor,
                         jax_example)
    assert len(whole) == 2 and len(resumed) == 1
    assert resumed[0] == whole[1]


def test_test_io_reads_batches_only(jax_example):
    before = OPS.value(op="push")
    mod, _, _ = _run("port", BASE + ["--test-io", "1"], jax_example)
    assert mod is None and OPS.value(op="push") == before


def test_not_ported_options_raise():
    for argv in (["--devices", "2"], ["--kv-store", "dist_sync"],
                 ["--kv-store", "tpu"]):
        with pytest.raises(mx.MXNetError, match="not ported yet"):
            train_mnist.main(["--device", "cpu", "--num-examples", "128"]
                             + argv)


def test_main_on_the_cpu():
    mod = train_mnist.main(["--device", "cpu", "--num-examples", "640",
                            "--num-epochs", "2"])
    with mx.cpu():
        _, val = train_mnist.get_mnist_iter(
            train_mnist.parse_args(["--num-examples", "640"]), None)
        (name, acc), = mod.score(val, "acc")
    assert acc > 0.9


def _dense(package, seed):
    m = mx if package == "port" else jmx
    rs = np.random.RandomState(seed)
    net = m.gluon.nn.Dense(3, in_units=5)
    net.initialize()
    net.weight.set_data(m.nd.array(rs.randn(3, 5).astype(np.float32)))
    net.bias.set_data(m.nd.array(rs.randn(3).astype(np.float32)))
    return net


@pytest.mark.parametrize("update_on_kvstore", [True, False])
@pytest.mark.parametrize("compression", [None, {"type": "2bit",
                                                "threshold": 0.1}],
                         ids=["plain", "2bit"])
def test_trainer_with_a_kvstore_object_matches_jax(update_on_kvstore,
                                                   compression):
    rs = np.random.RandomState(6)
    xs = rs.randn(3, 8, 5).astype(np.float32)
    ys = rs.randn(3, 8, 3).astype(np.float32)
    out = {}
    for package, m, ag in (("port", mx, autograd), ("jax", jmx, None)):
        ctx = mx.cpu() if package == "port" else jmx.cpu()
        with ctx:
            net = _dense(package, 0)
            kv = m.kv.create("local")
            trainer = m.gluon.Trainer(
                net.collect_params(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01},
                kvstore=kv, update_on_kvstore=update_on_kvstore,
                compression_params=compression)
            loss_fn = m.gluon.loss.L2Loss()
            for x, y in zip(xs, ys):
                with m.autograd.record():
                    loss = loss_fn(net(m.nd.array(x)), m.nd.array(y))
                loss.backward()
                trainer.step(8)
            assert trainer._kvstore is kv
            assert trainer._update_on_kvstore == update_on_kvstore
            out[package] = [p.data().asnumpy()
                            for p in net.collect_params().values()]
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_trainer_refusals_under_update_on_kvstore():
    with mx.cpu():
        net = _dense("port", 1)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                kvstore=mx.kv.create("local"),
                                update_on_kvstore=True)
        with autograd.record():
            loss = gluon.loss.L2Loss()(net(nd.ones((2, 5))), nd.zeros((2, 3)))
        loss.backward()
        with pytest.raises(mx.MXNetError, match="update_on_kvstore"):
            trainer.allreduce_grads()
        with pytest.raises(mx.MXNetError, match="update_on_kvstore"):
            trainer.update(2)
        trainer.step(2)


def test_feedforward_fit_through_a_kvstore_object_matches_jax(jax_example):
    from mxnet_tpu.model import FeedForward as JFeedForward
    from mxnet_tpu_torch.model import FeedForward
    from mxnet_tpu_torch.example.image_classification.symbols import mlp

    _, _, nets = jax_example
    img, lab = train_mnist._synthetic_mnist(128, 5)
    jmx.random.seed(2)
    jff = JFeedForward(nets["mlp"].get_symbol(num_classes=10), num_epoch=1,
                       optimizer="sgd", learning_rate=0.1, momentum=0.9)
    jff.fit(jmx.io.NDArrayIter(img, lab, batch_size=32),
            kvstore=jmx.kv.create("local"))
    push = OPS.value(op="push")
    with mx.cpu():
        mx.random.seed(2)
        ff = FeedForward(mlp.get_symbol(10), num_epoch=1, optimizer="sgd",
                         learning_rate=0.1, momentum=0.9)
        ff.fit(mx.io.NDArrayIter(img, lab, batch_size=32),
               kvstore=mx.kv.create("local"))
    assert OPS.value(op="push") - push == 4 * 6  # 4 batches x 6 keys
    for name, v in ff.arg_params.items():
        np.testing.assert_allclose(v.asnumpy(),
                                   jff.arg_params[name].asnumpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kw,reason", [
    ({"update_on_kvstore": True}, "update_on_kvstore"),
    ({"compression_params": {"type": "2bit", "threshold": 0.1}},
     "gradient compression"),
])
def test_train_plane_demotes_for_a_store_it_would_skip(kw, reason):
    from mxnet_tpu_torch import trainplane

    before = FALLBACKS.value(reason=reason)
    with mx.cpu():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(3, in_units=5))
        net.initialize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                kvstore=mx.kv.create("local"), **kw)
        plane = trainplane.TrainPlane(net, gluon.loss.L2Loss(), trainer)
        plane.step(nd.ones((4, 5)), nd.zeros((4, 3)))
    assert plane.plane == "eager"
    assert FALLBACKS.value(reason=reason) - before == 1
