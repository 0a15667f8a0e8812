"""Gluon checkpoints of the port (``Block.save_parameters``/
``load_parameters``, ``ParameterDict.save``/``load``,
``Trainer.save_states``/``load_states``) against the JAX package's, on
the CPU.

* A JAX ``resnet18_v1(classes=10)``'s ``save_parameters`` file loaded by
  the port's net (other weights before) gives the JAX net's forward on a
  seeded batch within ``TOL``, and the same the other way round.
* The legacy file of full names (``collect_params().save(...,
  strip_prefix=net.prefix)``) loads through ``load_parameters`` in both
  directions; a missing or an extra name raises the JAX package's
  ``MXNetError`` text in either path, and ``allow_missing``/
  ``ignore_extra`` let it pass.
* ``Trainer``: SGD with momentum, Adam, and a bfloat16 net with
  ``multi_precision``: 3 steps, save both files, a fresh net of other
  weights and a fresh Trainer load them, 3 steps; weights, moving
  statistics, states and masters equal an uninterrupted 6-step run bit
  for bit, and the optimizer's counters come back.
* The states file holds no ``torch`` global (a ``pickletools`` scan),
  only numpy arrays and plain Python, and unpickles to them; a JAX
  Trainer states file, which names the JAX optimizer's class, is refused.
* In-place restore: after ``load_parameters`` and ``load_states`` into a
  live net, every tensor the training plane holds keeps its
  ``data_ptr()``, the plane's ``compile_count`` stays flat, and its next
  steps equal the steps after the save bit for bit (fp32 and bf16 mode).
"""
import os
import pickle
import pickletools

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd, trainplane
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

TOL = 2e-5  # fp32, two packages
B, CLASSES = 8, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed=0):
    return np.random.RandomState(seed).rand(2, 3, 32, 32).astype(np.float32)


def _jax_resnet(seed):
    jmx.random.seed(seed)
    net = jvision.resnet18_v1(classes=CLASSES)
    net.initialize()
    net(jmx.nd.array(_x()))  # finishes deferred init; predict mode
    return net


def _port_resnet(seed):
    with mx.cpu():
        mx.random.seed(seed)
        net = vision.resnet18_v1(classes=CLASSES)
        net.initialize()
        net(nd.array(_x()))
    return net


def _port_forward(net, x):
    with mx.cpu():
        return net(nd.array(x)).asnumpy()


def test_block_params_cross_the_packages(tmp_path):
    x = _x(1)
    jnet, tnet = _jax_resnet(0), _port_resnet(5)
    path = str(tmp_path / "jax.params")
    jnet.save_parameters(path)
    with mx.cpu():
        tnet.load_parameters(path)
    want = jnet(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(_port_forward(tnet, x), want, rtol=TOL,
                               atol=TOL)

    tnet, jnet = _port_resnet(7), _jax_resnet(3)
    path = str(tmp_path / "port.params")
    tnet.save_parameters(path)
    jnet.load_parameters(path)
    np.testing.assert_allclose(jnet(jmx.nd.array(x)).asnumpy(),
                               _port_forward(tnet, x), rtol=TOL, atol=TOL)
    assert sorted(jnet._collect_params_with_prefix()) == sorted(
        tnet._collect_params_with_prefix())


def test_legacy_full_name_files_load_both_ways(tmp_path):
    x = _x(2)
    jnet, tnet = _jax_resnet(0), _port_resnet(9)
    path = str(tmp_path / "legacy_jax.params")
    jnet.collect_params().save(path, strip_prefix=jnet.prefix)
    with mx.cpu():
        tnet.load_parameters(path)
    np.testing.assert_allclose(_port_forward(tnet, x),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=TOL,
                               atol=TOL)
    tnet, jnet = _port_resnet(4), _jax_resnet(8)
    path = str(tmp_path / "legacy_port.params")
    tnet.collect_params().save(path, strip_prefix=tnet.prefix)
    jnet.load_parameters(path)
    np.testing.assert_allclose(jnet(jmx.nd.array(x)).asnumpy(),
                               _port_forward(tnet, x), rtol=TOL, atol=TOL)


def _message(fn, err_type, *names):
    with pytest.raises(err_type) as info:
        fn()
    text = str(info.value)
    for name in names:  # file names and the nets' top prefixes differ
        text = text.replace(name, "<name>")
    return text


@pytest.mark.parametrize("fault", ["missing", "extra"])
@pytest.mark.parametrize("legacy", [False, True], ids=["path", "legacy"])
def test_missing_and_extra_names_raise_as_in_jax(tmp_path, fault, legacy):
    jnet, tnet = _jax_resnet(0), _port_resnet(0)
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    if legacy:
        arrays = {k[len(jnet.prefix):]: p.data().asnumpy()
                  for k, p in jnet.collect_params().items()}
    else:
        arrays = {k: p.data().asnumpy()
                  for k, p in jnet._collect_params_with_prefix().items()}
    dropped = sorted(arrays)[3]
    if fault == "missing":
        del arrays[dropped]
    else:
        arrays["stray_weight" if legacy else "stray.weight"] = np.zeros(2)
    jmx.nd.save(jpath, {k: jmx.nd.array(v) for k, v in arrays.items()})
    with mx.cpu():
        mx.nd.save(tpath, {k: mx.nd.array(v) for k, v in arrays.items()})

    def port():
        with mx.cpu():
            tnet.load_parameters(tpath)

    want = _message(lambda: jnet.load_parameters(jpath),
                    jmx.base.MXNetError, jpath, jnet.prefix)
    got = _message(port, MXNetError, tpath, tnet.prefix)
    assert got == want
    # allowed, the load goes through and the other names are taken
    kw = {"allow_missing": True} if fault == "missing" else {
        "ignore_extra": True}
    with mx.cpu():
        tnet.load_parameters(tpath, **kw)
    jnet.load_parameters(jpath, **kw)
    x = _x(3)
    np.testing.assert_allclose(_port_forward(tnet, x),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=TOL,
                               atol=TOL)


def _mlp(seed, bf16=False):
    """Dense, BatchNorm, relu, Dense, on the CPU, seeded weights."""
    with mx.cpu():
        mx.random.seed(seed)
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16), nn.BatchNorm(), nn.Activation("relu"),
                    nn.Dense(8))
        net.initialize()
        net(nd.array(np.zeros((2, 6), np.float32)))
        if bf16:
            net.cast("bfloat16")
    return net


def _batches(n=6):
    rs = np.random.RandomState(11)
    return [(rs.rand(B, 6).astype(np.float32), rs.randint(0, 8, (B,)))
            for _ in range(n)]


def _eager_steps(net, trainer, batches, bf16=False):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.cpu():
        for x, y in batches:
            data = nd.array(x, dtype="bfloat16" if bf16 else None)
            with autograd.record():
                loss = loss_fn(net(data), nd.array(y))
            loss.backward()
            trainer.step(B)


def _tensors(net, trainer):
    out = [p.data()._data.clone() for p in net.collect_params().values()]
    for i in sorted(trainer._updater.states):
        st = trainer._updater.states[i]
        out += [t.clone() for t in (st if isinstance(st, tuple) else [st])
                if t is not None]
    return out


OPTS = {
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4}, False),
    "adam": ("adam", {"learning_rate": 0.01}, False),
    "bf16_multi_precision": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                     "multi_precision": True}, True),
}


@pytest.mark.parametrize("case", sorted(OPTS))
def test_trainer_resume_equals_uninterrupted(tmp_path, case):
    opt, params, bf16 = OPTS[case]
    batches = _batches()
    whole = _mlp(0, bf16)
    whole_tr = gluon.Trainer(whole.collect_params(), opt, dict(params))
    _eager_steps(whole, whole_tr, batches, bf16)

    first = _mlp(0, bf16)
    first_tr = gluon.Trainer(first.collect_params(), opt, dict(params))
    _eager_steps(first, first_tr, batches[:3], bf16)
    pfile, sfile = str(tmp_path / "n.params"), str(tmp_path / "n.states")
    first.save_parameters(pfile)
    first_tr.save_states(sfile)

    resumed = _mlp(1, bf16)
    resumed_tr = gluon.Trainer(resumed.collect_params(), opt, dict(params))
    with mx.cpu():
        resumed.load_parameters(pfile)
        resumed_tr.load_states(sfile)
    assert resumed_tr._optimizer.num_update == 3
    assert resumed_tr._optimizer.param_dict[0] is \
        list(resumed.collect_params().values())[0]
    _eager_steps(resumed, resumed_tr, batches[3:], bf16)
    a, b = _tensors(whole, whole_tr), _tensors(resumed, resumed_tr)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)
    if bf16:  # bf16 weights, float32 masters and momenta
        assert {t.dtype for t in b} == {torch.bfloat16, torch.float32}
        assert all(s[0].dtype == torch.float32
                   for s in resumed_tr._updater.states.values())


def _pickle_globals(blob):
    """The module of every global a pickle names, and every string it
    holds (protocol 4 names a global by two pushed strings)."""
    modules, strings = [], []
    for op, arg, _ in pickletools.genops(blob):
        if op.name == "GLOBAL":
            modules.append(arg.split(" ")[0])
        elif op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE",
                         "BINUNICODE8"):
            strings.append(arg)
    return modules, strings


def test_states_file_holds_numpy_and_plain_python_only(tmp_path):
    net = _mlp(0, bf16=True)
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 0.01, "multi_precision": True})
    _eager_steps(net, tr, _batches(2), bf16=True)
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    with open(path, "rb") as f:
        blob = f.read()
    modules, strings = _pickle_globals(blob)
    for name in modules + strings:
        assert not (name == "torch" or name.startswith("torch.")), name
    states, opt = pickle.loads(blob)
    assert opt.param_dict == {} and "_state_struct_cache" not in vars(opt)
    assert opt.num_update == 2

    def leaves(s):
        if isinstance(s, tuple):
            return [t for x in s for t in leaves(x)]
        return [] if s is None else [s]

    found = [t for s in states.values() for t in leaves(s)]
    assert found and all(isinstance(t, np.ndarray) for t in found)
    assert {t.dtype for t in found} == {np.dtype(np.float32)}


def test_jax_trainer_states_file_is_refused(tmp_path):
    """A JAX Trainer states file names the JAX optimizer's class: the port
    refuses it with an MXNetError (the kept deviation), and its own
    trainer's states stay as they were."""
    jnet = jmx.gluon.nn.Dense(8, in_units=6)
    jnet.initialize()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    x = jmx.nd.array(np.ones((2, 6), np.float32))
    with jmx.autograd.record():
        loss = jnet(x).sum()
    loss.backward()
    jtr.step(2)
    path = str(tmp_path / "jax.states")
    jtr.save_states(path)

    net = _mlp(0)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    _eager_steps(net, tr, _batches(1))
    before = _tensors(net, tr)
    with pytest.raises(MXNetError, match="mxnet_tpu.optimizer.SGD.*loads "
                       "only in the package that wrote it"):
        with mx.cpu():
            tr.load_states(path)
    assert tr._optimizer is tr._updater.optimizer
    for x, y in zip(before, _tensors(net, tr)):
        assert torch.equal(x, y)


def _ptrs(plane):
    return [t.data_ptr() for t in plane._held()]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_restore_into_live_plane_is_in_place(tmp_path, monkeypatch, dtype):
    monkeypatch.setenv("MXNET_TRAIN_DTYPE", dtype)
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    batches = _batches()
    with mx.cpu():
        net = _mlp(0)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
        plane = trainplane.TrainPlane(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
        data = [(nd.array(x), nd.array(y)) for x, y in batches]
        for x, y in data[:3]:
            plane.step(x, y)
        pfile, sfile = str(tmp_path / "p.params"), str(tmp_path / "p.states")
        net.save_parameters(pfile)
        tr.save_states(sfile)
        after = [plane.step(x, y)._data.clone() for x, y in data[3:]]
        want = [t.clone() for t in plane._held()]
        ptrs, captures = _ptrs(plane), plane.compile_count
        net.load_parameters(pfile)
        tr.load_states(sfile)
        assert _ptrs(plane) == ptrs
        again = [plane.step(x, y)._data.clone() for x, y in data[3:]]
    assert plane.plane == "graph" and plane.compile_count == captures == 1
    assert _ptrs(plane) == ptrs
    for x, y in zip(after + want, again + list(plane._held())):
        assert torch.equal(x, y)
    if dtype == "bf16":
        assert all(p.data()._data.dtype == torch.bfloat16
                   for p in net.collect_params().values())


def test_load_into_uninitialized_and_deferred_parameters(tmp_path):
    src = _mlp(0)
    path = str(tmp_path / "d.params")
    src.save_parameters(path)
    with mx.cpu():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16), nn.BatchNorm(), nn.Activation("relu"),
                    nn.Dense(8))
        net.initialize()  # deferred: in_units unknown
        net.load_parameters(path)
        x = nd.array(np.random.RandomState(0).rand(3, 6).astype(np.float32))
        got, want = net(x).asnumpy(), src(x).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert os.path.getsize(path) > 0
