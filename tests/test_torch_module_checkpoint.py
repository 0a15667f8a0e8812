"""Module and model checkpoints of the port (``Module.save_checkpoint``/
``Module.load``, ``save_optimizer_states``/``load_optimizer_states``,
``model.save_checkpoint``/``load_checkpoint``, ``FeedForward``, the
checkpoint callbacks) against the JAX package's, on the CPU.

* ``save_checkpoint`` in either package, then ``Module.load`` in the
  other, gives the same ``predict`` (a LeNet-style net with BatchNorm,
  its moving statistics in the ``aux:`` entries) within ``TOL``.
* A JAX ``save_optimizer_states`` file loads in the port (states equal
  the JAX file's arrays) and a port one in the JAX package.
* The kept deviation: the port's ``Module.load(...,
  load_optimizer_states=True)`` followed by ``fit`` applies the states
  (MXNet 1.3), and equals the JAX package's ``Module.load``,
  ``init_optimizer``, an explicit ``load_optimizer_states`` and ``fit``
  within ``TOL``; the JAX ``Module.load`` alone records the file and
  never reads it.
* Within the port, a fit of one epoch with ``module_checkpoint(...,
  save_optimizer_states=True)`` resumed by ``Module.load`` and
  ``fit(begin_epoch=1, num_epoch=2)`` equals an uninterrupted 2-epoch fit
  bit for bit, on the module plane.
* ``FeedForward``'s ``fit``/``save``/``load``/``predict`` against the
  JAX class's, as ``tests/test_trainplane.py:439`` drives it.
* ``do_checkpoint``/``module_checkpoint`` write the JAX package's file
  names at every period.
* ``Module.load_params`` into a bound module whose plane captured writes
  the executor's tensors in place: the same ``data_ptr()``s, the same
  ``compile_count``, and the next steps repeat bit for bit; a file of
  other names goes through ``set_params`` (a rebind).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.model import FeedForward as JFeedForward

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import trainplane
from mxnet_tpu_torch.model import FeedForward

B = 16
TOL = 2e-5  # fp32, two packages
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lenet(pkg):
    s = pkg.sym
    net = s.Convolution(s.var("data"), kernel=(3, 3), num_filter=4,
                        name="conv1")
    net = s.BatchNorm(net, name="bn1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool1")
    net = s.FullyConnected(net, num_hidden=4, name="fc1")
    return s.SoftmaxOutput(net, name="softmax")


def _mlp(pkg, classes=4):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=classes, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _data(seed=5, n=4 * B):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 1, 8, 8).astype(np.float32),
            rs.randint(0, 4, (n,)).astype(np.float32))


def _trained(pkg, prefix, epochs=1):
    """A LeNet module of ``pkg`` fitted ``epochs`` epochs from seed 7,
    checkpointed with its states at every epoch to ``prefix``."""
    xs, ys = _data()
    with pkg.cpu():
        pkg.random.seed(7)
        it = pkg.io.NDArrayIter(xs, ys, B)
        mod = pkg.module.Module(_lenet(pkg), context=pkg.cpu())
        mod.fit(it, optimizer="sgd", optimizer_params=dict(SGD),
                initializer=pkg.initializer.Xavier(), num_epoch=epochs,
                epoch_end_callback=pkg.callback.module_checkpoint(
                    mod, prefix, save_optimizer_states=True))
    return mod


def _predict(pkg, prefix, epoch):
    xs, ys = _data(seed=9)
    with pkg.cpu():
        it = pkg.io.NDArrayIter(xs, ys, B)
        mod = pkg.module.Module.load(prefix, epoch, context=pkg.cpu())
        mod.bind(data_shapes=it.provide_data, for_training=False)
        return mod.predict(it).asnumpy()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_predicts_alike_across_packages(tmp_path, writer):
    src, dst = (jmx, mx) if writer == "jax" else (mx, jmx)
    prefix = str(tmp_path / "lenet")
    _trained(src, prefix)
    assert sorted(os.listdir(tmp_path)) == [
        "lenet-0001.params", "lenet-0001.states", "lenet-symbol.json"]
    got, want = _predict(dst, prefix, 1), _predict(src, prefix, 1)
    assert got.shape == (4 * B, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with mx.cpu():
        _, _, aux = mx.load_checkpoint(prefix, 1)
    assert sorted(aux) == ["bn1_moving_mean", "bn1_moving_var"]
    assert np.abs(aux["bn1_moving_var"].asnumpy() - 1).max() > 1e-3


def _states(pkg_mod):
    """An updater's states as numpy, by index."""
    return {i: np.asarray(s.asnumpy() if hasattr(s, "asnumpy") else
                          (s.detach().numpy() if isinstance(s, torch.Tensor)
                           else s))
            for i, s in pkg_mod._updater.states.items()}


def _bound(pkg, prefix, epoch):
    """``pkg``'s ``Module.load`` of the checkpoint, bound with its
    optimizer, and the file's states applied explicitly."""
    xs, ys = _data()
    with pkg.cpu():
        it = pkg.io.NDArrayIter(xs, ys, B)
        mod = pkg.module.Module.load(prefix, epoch, context=pkg.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
        mod.load_optimizer_states("%s-%04d.states" % (prefix, epoch))
    return mod, it


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_optimizer_states_files_cross_packages(tmp_path, writer):
    src, dst = (jmx, mx) if writer == "jax" else (mx, jmx)
    prefix = str(tmp_path / "lenet")
    _trained(src, prefix)
    with open(prefix + "-0001.states", "rb") as f:
        saved = pickle.loads(f.read())
    assert isinstance(saved, dict) and len(saved) == 6
    mod, _ = _bound(dst, prefix, 1)
    got = _states(mod)
    assert sorted(got) == sorted(saved)
    for i in saved:
        np.testing.assert_array_equal(got[i], np.asarray(saved[i]))


def test_preloaded_states_apply_in_init_optimizer(tmp_path):
    """The kept deviation: the port's Module.load(load_optimizer_states=
    True) + fit equals the JAX package's Module.load + init_optimizer +
    load_optimizer_states + fit."""
    prefix = str(tmp_path / "lenet")
    _trained(jmx, prefix)
    xs, ys = _data()
    jmod, jit = _bound(jmx, prefix, 1)
    with jmx.cpu():
        jmod.fit(jit, optimizer="sgd", optimizer_params=dict(SGD),
                 begin_epoch=1, num_epoch=2)
    with mx.cpu():
        it = mx.io.NDArrayIter(xs, ys, B)
        mod = mx.module.Module.load(prefix, 1, load_optimizer_states=True,
                                    context=mx.cpu())
        mod.fit(it, optimizer="sgd", optimizer_params=dict(SGD),
                begin_epoch=1, num_epoch=2)
    jargs, jaux = jmod.get_params()
    args, aux = mod.get_params()
    for ours, theirs in ((args, jargs), (aux, jaux)):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_allclose(ours[k].asnumpy(),
                                       theirs[k].asnumpy(), rtol=TOL,
                                       atol=TOL, err_msg=k)
    # without the states the port's momentum starts from zero: different
    with mx.cpu():
        it = mx.io.NDArrayIter(xs, ys, B)
        cold = mx.module.Module.load(prefix, 1, context=mx.cpu())
        cold.fit(it, optimizer="sgd", optimizer_params=dict(SGD),
                 begin_epoch=1, num_epoch=2)
    assert np.abs(cold.get_params()[0]["fc1_weight"].asnumpy()
                  - args["fc1_weight"].asnumpy()).max() > 1e-4


def _module_tensors(mod):
    args, aux = mod.get_params()
    out = [args[k]._data for k in sorted(args)]
    out += [aux[k]._data for k in sorted(aux)]
    return out + [mod._updater.states[i] for i in sorted(mod._updater.states)]


def test_resume_equals_uninterrupted_fit_on_the_plane(tmp_path):
    prefix = str(tmp_path / "lenet")
    made, orig = [], trainplane.module_plane

    def keep(module):
        made.append(orig(module))
        return made[-1]

    trainplane.module_plane = keep
    try:
        whole = _trained(mx, str(tmp_path / "whole"), epochs=2)
        _trained(mx, prefix, epochs=1)
        xs, ys = _data()
        with mx.cpu():
            mx.random.seed(7)
            it = mx.io.NDArrayIter(xs, ys, B)
            resumed = mx.module.Module.load(prefix, 1, context=mx.cpu(),
                                            load_optimizer_states=True)
            resumed.fit(it, optimizer="sgd", optimizer_params=dict(SGD),
                        begin_epoch=1, num_epoch=2)
    finally:
        trainplane.module_plane = orig
    assert len(made) == 3 and all(p is not None for p in made)
    assert made[-1].compile_count == 1
    a, b = _module_tensors(whole), _module_tensors(resumed)
    assert len(a) == len(b) == 14  # 6 weights, 2 statistics, 6 states
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _ff_symbol(pkg):
    return _mlp(pkg, classes=2)


def _ff_data():
    rs = np.random.RandomState(61)
    xs = rs.rand(4 * B, 6).astype(np.float32)
    return xs, (xs.sum(axis=1) > 3.0).astype(np.float32)


def test_feedforward_against_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    xs, ys = _ff_data()
    jmx.random.seed(3)
    jff = JFeedForward(_ff_symbol(jmx), num_epoch=2, optimizer="sgd",
                       learning_rate=0.5)
    jff.fit(jmx.io.NDArrayIter(xs, ys, batch_size=B))
    want = jff.predict(jmx.io.NDArrayIter(xs, ys, batch_size=B))
    with mx.cpu():
        mx.random.seed(3)
        ff = FeedForward(_ff_symbol(mx), num_epoch=2, optimizer="sgd",
                         learning_rate=0.5)
        assert ff.ctx == [mx.cpu()]
        ff.fit(mx.io.NDArrayIter(xs, ys, batch_size=B))
        got = ff.predict(mx.io.NDArrayIter(xs, ys, batch_size=B))
    assert got.shape == (4 * B, 2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    for src, dst_load, name in ((ff, JFeedForward.load, "port"),
                                (jff, FeedForward.load, "jax")):
        prefix = str(tmp_path / name)
        src.save(prefix)  # epoch = num_epoch
        assert os.path.isfile(prefix + "-0002.params")
        with mx.cpu(), jmx.cpu():
            loaded = dst_load(prefix, 2, ctx=None)
            out = loaded.predict((mx if dst_load is FeedForward.load
                                  else jmx).io.NDArrayIter(xs, ys,
                                                           batch_size=B))
        assert loaded.begin_epoch == 2
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("period", [1, 2, 3])
def test_checkpoint_callbacks_write_jax_file_names(tmp_path, period):
    dirs = {}
    for pkg in (jmx, mx):
        d = tmp_path / pkg.__name__
        d.mkdir()
        with pkg.cpu():
            xs, ys = _data()
            it = pkg.io.NDArrayIter(xs, ys, B)
            mod = pkg.module.Module(_lenet(pkg), context=pkg.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(pkg.initializer.Xavier())
            mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
            do = pkg.callback.do_checkpoint(str(d / "do"), period)
            mc = pkg.callback.module_checkpoint(mod, str(d / "mc"), period,
                                                save_optimizer_states=True)
            args, aux = mod.get_params()
            for epoch in range(5):
                do(epoch, mod.symbol, args, aux)
                mc(epoch)
        dirs[pkg] = sorted(os.listdir(d))
    assert dirs[mx] == dirs[jmx]
    assert ("do-%04d.params" % period) in dirs[mx]
    assert len([n for n in dirs[mx] if n.startswith("mc-")
                and n.endswith(".states")]) == 5 // period


def test_load_params_writes_the_captured_plane_in_place(tmp_path):
    xs, ys = _data()
    with mx.cpu():
        mx.random.seed(7)
        it = mx.io.NDArrayIter(xs, ys, B)
        mod = mx.module.Module(_lenet(mx), context=mx.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
        plane = trainplane.module_plane(mod)
        batches = list(it)
        for b in batches[:2]:
            plane.step(b)
        pfile, sfile = str(tmp_path / "m.params"), str(tmp_path / "m.states")
        mod.save_params(pfile)
        mod.save_optimizer_states(sfile)
        after = [plane.step(b)[0]._data.clone() for b in batches[2:]]
        want = [t.clone() for t in plane._held()]
        ptrs = [t.data_ptr() for t in plane._held()]
        mod.load_params(pfile)
        mod.load_optimizer_states(sfile)
        assert [t.data_ptr() for t in plane._held()] == ptrs
        again = [plane.step(b)[0]._data.clone() for b in batches[2:]]
        assert plane.compile_count == 1
        for x, y in zip(after + want, again + list(plane._held())):
            assert torch.equal(x, y)
        # a file that names other parameters: set_params, a rebind
        args, aux = mod.get_params()
        mx.nd.save(pfile, {"arg:" + k: v for k, v in args.items()})
        with pytest.raises(RuntimeError, match="is not presented"):
            mod.load_params(pfile)
