"""The port's fused optimizer apply (``mxnet_tpu_torch.fastpath``) against
its per-parameter path and the JAX package (CPU).

* ``fastpath.apply_updater`` (one call of the optimizer's list kernel
  over every parameter) equals the per-parameter loop (the same kernel
  over one-element lists) bit for bit, for SGD (momentum 0 and 0.9, wd,
  clip, rescale) and Adam, over mixed shapes and three steps.
* It equals ``mxnet_tpu.fastpath.fused_apply`` over the same three steps
  within 2e-5.
* ``Trainer.step`` and ``Module.update`` dispatch once a step through the
  fused path, and match ``MXNET_FASTPATH=0`` (the per-parameter loop) bit
  for bit; the fresh-gradient contract holds in both modes
  (``tests/test_fastpath.py:72-98, 153, 197-228``).
* ``TrainStep``'s ``pure_step`` (0-d device learning rate and step
  count) equals the fused apply for SGD and Adam.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fastpath as jfastpath
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, fastpath, gluon, nd
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.telemetry import OPT_DISPATCHES

TOL = 2e-5
SHAPES = [(4, 3), (7,), (2, 2, 2), (5, 1), (3,), (16, 8)]
CASES = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "wd": 0.01, "clip_gradient": 0.5,
             "rescale_grad": 0.25}),
    ("sgd", {"wd": 0.01, "rescale_grad": 2.0}),
    ("adam", {}),
    ("adam", {"wd": 0.01, "clip_gradient": 0.5, "rescale_grad": 0.5}),
]
IDS = ["sgd", "sgd_momentum", "sgd_wd_clip_rescale", "sgd_wd_rescale",
       "adam", "adam_wd_clip_rescale"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # these small CPU shapes gain nothing from torch's thread pool, and
    # under a parallel test run its spinning threads slow every worker
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values(steps=3):
    rs = np.random.RandomState(0)
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(steps)]
    return ws, gs


def _run_port(path, name, kw, steps=3):
    wv, gv = _values(steps)
    o = opt.create(name, learning_rate=0.05, **kw)
    upd = opt.get_updater(o)
    ws = [NDArray(torch.from_numpy(w.copy())) for w in wv]
    for s in range(steps):
        gs = [NDArray(torch.from_numpy(g.copy())) for g in gv[s]]
        if path == "fused":
            fastpath.apply_updater(upd, [(i, gs[i], ws[i])
                                         for i in range(len(ws))])
        else:
            for i in range(len(ws)):
                upd(i, gs[i], ws[i])
    return ws, upd.states


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_fused_equals_per_parameter_bitwise(name, kw):
    a, sa = _run_port("perparam", name, kw)
    b, sb = _run_port("fused", name, kw)
    for x, y in zip(a, b):
        assert x.asnumpy().tobytes() == y.asnumpy().tobytes()
    for i in sa:
        for x, y in zip(_leaves(sa[i]), _leaves(sb[i])):
            assert x.numpy().tobytes() == y.numpy().tobytes()


def _leaves(state):
    if state is None:
        return []
    return list(state) if isinstance(state, tuple) else [state]


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_fused_equals_jax_fused_apply(name, kw):
    ws, states = _run_port("fused", name, kw)
    wv, gv = _values()
    o = jopt.create(name, learning_rate=0.05, **kw)
    upd = jopt.get_updater(o)
    jws = [JNDArray(jnp.asarray(w), jmx.cpu()) for w in wv]
    for s in range(3):
        jgs = [JNDArray(jnp.asarray(g), jmx.cpu()) for g in gv[s]]
        jfastpath.apply_updater(upd, [(i, jgs[i], jws[i])
                                      for i in range(len(jws))])
    for i, (w, jw) in enumerate(zip(ws, jws)):
        np.testing.assert_allclose(w.asnumpy(), np.asarray(jw._data),
                                   rtol=TOL, atol=TOL)
        jleaves = [] if upd.states[i] is None else (
            list(upd.states[i]) if isinstance(upd.states[i], tuple)
            else [upd.states[i]])
        for x, y in zip(_leaves(states[i]), jleaves):
            np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,kw", [CASES[2], CASES[5]],
                         ids=["sgd", "adam"])
def test_pure_step_equals_fused_apply(name, kw):
    # TrainStep's form: lr and t as 0-d tensors, lr_mults and wd per index
    a, sa = _run_port("fused", name, kw)
    wv, gv = _values()
    o = opt.create(name, learning_rate=0.05, **kw)
    ws = [torch.from_numpy(w.copy()) for w in wv]
    states = [o.create_state(i, w) for i, w in enumerate(ws)]
    for s in range(3):
        with torch.no_grad():
            o.pure_step(ws, [torch.from_numpy(g) for g in gv[s]], states,
                        torch.tensor(float(s + 1)), torch.tensor(0.05),
                        [1.0] * len(ws), [kw.get("wd", 0.0)] * len(ws))
    for x, y in zip(a, ws):
        np.testing.assert_allclose(x.asnumpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_fused_apply_rejects_incapable_optimizer_and_ragged_input():
    class NoKernel(opt.Optimizer):
        pass

    w = NDArray(torch.ones(2, 2))
    with pytest.raises(fastpath.FusedApplyError):
        fastpath.fused_apply(NoKernel(), [0], [w], [w], [None])
    with pytest.raises(fastpath.FusedApplyError, match="ragged"):
        fastpath.fused_apply(opt.SGD(), [0, 1], [w], [w], [None])
    assert not fastpath.supports(NoKernel())
    assert fastpath.supports(opt.SGD()) and fastpath.supports(opt.Adam())


def _mlp(n_layers=6):
    net = gluon.nn.HybridSequential()
    for _ in range(n_layers - 1):
        net.add(gluon.nn.Dense(16, activation="relu"))
    net.add(gluon.nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    net(nd.array(np.zeros((2, 8), np.float32), ctx=mx.cpu()))
    return net


def _train_mlp(steps=3, optimizer="sgd", params=None):
    mx.random.seed(0)  # identical init across the two runs
    with mx.cpu():
        net = _mlp()
        trainer = gluon.Trainer(net.collect_params(), optimizer,
                                params or {"learning_rate": 0.05,
                                           "momentum": 0.9})
        loss_fn = gluon.loss.L2Loss()
        rs = np.random.RandomState(1)
        for _ in range(steps):
            x = nd.array(rs.rand(2, 8).astype(np.float32))
            y = nd.array(rs.rand(2, 4).astype(np.float32))
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(2)
    return [p.data().asnumpy().tobytes()
            for p in net.collect_params().values()]


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001})], ids=["sgd", "adam"])
def test_trainer_dispatches_once_a_step_and_matches_the_loop(
        monkeypatch, optimizer, params):
    steps = 3
    monkeypatch.setenv("MXNET_FASTPATH", "0")
    p0 = OPT_DISPATCHES.value(path="perparam")
    legacy = _train_mlp(steps, optimizer, params)
    perparam = OPT_DISPATCHES.value(path="perparam") - p0
    monkeypatch.setenv("MXNET_FASTPATH", "1")
    f0 = OPT_DISPATCHES.value(path="fused")
    p0 = OPT_DISPATCHES.value(path="perparam")
    fused_run = _train_mlp(steps, optimizer, params)
    fused = OPT_DISPATCHES.value(path="fused") - f0
    assert OPT_DISPATCHES.value(path="perparam") == p0
    assert fused == steps  # one fused apply a step
    assert perparam == 12 * steps  # 6 layers x weight and bias
    assert legacy == fused_run


@pytest.mark.parametrize("fast", ["1", "0"])
def test_trainer_ignore_stale_grad(monkeypatch, fast):
    monkeypatch.setenv("MXNET_FASTPATH", fast)
    with mx.cpu():
        net = _mlp(2)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05})
        loss_fn = gluon.loss.L2Loss()
        x = nd.array(np.ones((2, 8), np.float32))
        y = nd.array(np.ones((2, 4), np.float32))
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(2)
        with pytest.raises(UserWarning):  # no new backward: all stale
            trainer.step(2)
        before = [p.data().asnumpy().tobytes()
                  for p in net.collect_params().values()]
        trainer.step(2, ignore_stale_grad=True)  # skips, writes nothing
    after = [p.data().asnumpy().tobytes()
             for p in net.collect_params().values()]
    assert before == after


def _fit_module(epochs=1):
    rs = np.random.RandomState(4)
    x = rs.rand(32, 8).astype(np.float32)
    y = rs.randint(0, 4, 32).astype(np.float32)
    sym = mx.sym
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    with mx.cpu():
        mx.random.seed(3)
        it = mx.io.NDArrayIter(x, y, 8)
        mod = mx.module.Module(net, context=mx.cpu())
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-3},
                initializer=mx.initializer.Xavier(), num_epoch=epochs)
        args, _ = mod.get_params()
    return {k: v.asnumpy().tobytes() for k, v in args.items()}


def test_module_update_dispatches_once_a_batch_and_matches_the_loop(
        monkeypatch):
    # Module.update is fit's eager branch: with the graph plane on, fit
    # steps through trainplane.module_plane instead, whose update makes no
    # optimizer dispatch and gives the same bits
    monkeypatch.setenv("MXNET_TRAINSTEP", "0")
    monkeypatch.setenv("MXNET_FASTPATH", "0")
    p0 = OPT_DISPATCHES.value(path="perparam")
    legacy = _fit_module()
    perparam = OPT_DISPATCHES.value(path="perparam") - p0
    monkeypatch.setenv("MXNET_FASTPATH", "1")
    f0 = OPT_DISPATCHES.value(path="fused")
    fused_run = _fit_module()
    fused = OPT_DISPATCHES.value(path="fused") - f0
    assert fused == 4  # 32 rows / batch 8
    assert perparam == 4 * 4  # fc1 and fc2, weight and bias
    assert legacy == fused_run
    monkeypatch.setenv("MXNET_TRAINSTEP", "auto")
    f0 = OPT_DISPATCHES.value(path="fused")
    assert _fit_module() == fused_run
    assert OPT_DISPATCHES.value(path="fused") == f0
