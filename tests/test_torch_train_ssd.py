"""The SSD example's whole slice trained by both packages (CPU).

The JAX example (``example/ssd/train_ssd.py``, loaded by file) and the
port's (``mxnet_tpu_torch/example/ssd/train_ssd.py``) at a test size
(side 32, batch 4, 2 steps) on one dataset: the same .rec, the same seed
for the iterators' shuffles and flips, the JAX module's initial weights
carried into the port's by ``module.params_from_jax``, and SGD with
momentum 0.9 and wd 5e-4 in both. Tolerances, fp32 on the CPU, where the
convolutions sum in other orders: each step's ``cls_prob`` and
``loc_loss`` within 1e-4, the parameters after 2 steps within 1e-4,
``cls_label`` and the detection output's kept rows exactly.

Then the port's ``run()`` for one epoch on the CPU: finite losses and a
detection output of shape (4, N, 6).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.example.ssd import train_ssd as port_ssd

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4}


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_ssd", REPO / "example" / "ssd" / "train_ssd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modules(rec):
    kw = dict(batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec,
              shuffle=True, mean=True, std=True, rand_mirror=True)
    jmx.random.seed(0)
    jit = jmx.image.ImageDetIter(**kw)
    jmod = jmx.module.Module(_jax_example().get_symbol_train(3),
                             data_names=("data",), label_names=("label",),
                             context=jmx.cpu())
    jmod.bind(data_shapes=jit.provide_data, label_shapes=jit.provide_label)
    jmod.init_params(jmx.initializer.Xavier())
    jmod.init_optimizer(optimizer="sgd", optimizer_params=SGD)

    mx.random.seed(0)
    with mx.cpu():
        tit = mx.image.ImageDetIter(**kw)
        tmod = mx.module.Module(port_ssd.get_symbol_train(3),
                                data_names=("data",), label_names=("label",))
    tmod.bind(data_shapes=tit.provide_data, label_shapes=tit.provide_label)
    # the port draws the same Xavier weights from the same seed; the JAX
    # ones are carried over all the same, as a user would
    tmod.init_params(mx.initializer.Xavier())
    jargs, jaux = jmod.get_params()
    tmod.set_params(*mx.module.params_from_jax(
        tmod, {k: v.asnumpy() for k, v in jargs.items()}, jaux))
    tmod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    return (jit, jmod), (tit, tmod)


def test_two_sgd_steps_match_jax(tmp_path):
    rec = _jax_example().make_dataset(str(tmp_path / "shapes"), n=8,
                                      side=32)
    (jit, jmod), (tit, tmod) = _modules(rec)
    jit.reset()
    tit.reset()
    for step, (jb, tb) in enumerate(zip(jit, tit)):
        np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                      jb.data[0].asnumpy())
        for mod, batch in ((jmod, jb), (tmod, tb)):
            mod.forward_backward(batch)
            mod.update()
        jo = [o.asnumpy() for o in jmod.get_outputs()]
        to = [o.asnumpy() for o in tmod.get_outputs()]
        np.testing.assert_allclose(to[0], jo[0], err_msg="cls_prob", **TOL)
        np.testing.assert_allclose(to[1], jo[1], err_msg="loc_loss", **TOL)
        np.testing.assert_array_equal(to[2], jo[2])
        np.testing.assert_array_equal(to[3][..., 0] == -1,
                                      jo[3][..., 0] == -1)
    assert step == 1
    jargs, _ = jmod.get_params()
    targs, _ = tmod.get_params()
    assert set(targs) == set(jargs)
    for name, value in jargs.items():
        np.testing.assert_allclose(targs[name].asnumpy(), value.asnumpy(),
                                   err_msg=name, **TOL)


def test_params_from_jax_checks_names_and_shapes(tmp_path):
    rec = port_ssd.make_dataset(str(tmp_path / "s"), n=4, side=32)
    with mx.cpu():
        it = mx.image.ImageDetIter(batch_size=4, data_shape=(3, 32, 32),
                                   path_imgrec=rec)
        mod = mx.module.Module(port_ssd.get_symbol_train(3),
                               data_names=("data",), label_names=("label",))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    shapes = dict(mod._param_shapes)
    good = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    args, aux = mx.module.params_from_jax(mod, good, {})
    assert set(args) == set(shapes) and aux == {}
    with pytest.raises(MXNetError, match="missing"):
        mx.module.params_from_jax(
            mod, {k: v for k, v in good.items() if k != "conv1_bias"}, {})
    bad = dict(good, conv1_weight=np.zeros((1, 2), np.float32))
    with pytest.raises(MXNetError, match="conv1_weight"):
        mx.module.params_from_jax(mod, bad, {})


def test_run_one_epoch_on_the_cpu(tmp_path):
    args = port_ssd.parse_args(["--device", "cpu", "--epochs", "1",
                                "--side", "32", "--batch-size", "4",
                                "--data-dir", str(tmp_path)])
    res = port_ssd.run(args)
    assert res["steps"] == 16  # 64 images / batch 4
    ep = res["epochs"][0]
    assert np.isfinite(ep["cls_loss"]) and np.isfinite(ep["loc_loss"])
    assert res["det_shape"] == (4, 3 * (16 * 16 + 8 * 8), 6)
