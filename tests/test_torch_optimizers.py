"""The port's 17 optimizers against the JAX package's (CPU).

For every registered name, with ``tests/test_fastpath.py``'s arguments:

* three per-parameter updates equal the JAX package's within 2e-5
  (weights and states), and so do three with ``rescale_grad``,
  ``clip_gradient``, ``wd``, an ``lr_mult`` and an ``lr_scheduler``;
* the fused apply (one call of the list kernel over every parameter)
  equals the per-parameter loop bit for bit;
* float16 and bfloat16 weights under ``multi_precision`` keep float32
  masters equal to the JAX package's within 2e-5, and weights that are
  the masters cast back;
* a states file written by either package loads in the other and the
  next update agrees;
* where the class has ``pure_step``, ``parallel.TrainStep`` (the kernel
  with a 0-d learning rate and count) trains a small net as eager
  ``Trainer`` steps do.

SGLD draws its noise from the port's generator, so it is held by its
moments (10,000 draws) and its drift, not against the JAX draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, fastpath, gluon, nd, parallel
from mxnet_tpu_torch import lr_scheduler as lrs
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.ndarray.ndarray import NDArray

TOL = 2e-5
SHAPES = [(4, 3), (2, 1, 5)]
# tests/test_fastpath.py:78-84, plus the names it leaves out
CASES = [
    ("sgd", {"momentum": 0.9}), ("ccsgd", {"momentum": 0.9}),
    ("adam", {}), ("nag", {"momentum": 0.9}),
    ("rmsprop", {"centered": True}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 0.8}),
    ("ftrl", {}), ("adadelta", {}), ("adagrad", {}), ("adamax", {}),
    ("ftml", {}), ("nadam", {}), ("sgld", {}),
    ("signum", {"momentum": 0.9}), ("signsgd", {}),
    ("dcasgd", {"momentum": 0.9}), ("dcasgd", {}),
    ("lbsgd", {"momentum": 0.9}), ("test", {}),
]
IDS = ["%s%s" % (n, "".join("-%s" % k for k in sorted(kw)))
       for n, kw in CASES]
DETERMINISTIC = [(n, kw) for n, kw in CASES if n != "sgld"]
DET_IDS = [i for i, (n, _) in zip(IDS, CASES) if n != "sgld"]
NO_PURE_STEP = ("sgld", "nadam")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values(steps=3, shapes=SHAPES):
    rs = np.random.RandomState(0)
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    # gradients kept away from 0: sign-based steps are discontinuous there
    gs = [[(rs.randn(*s) + np.sign(rs.randn(*s)) * 0.1).astype(np.float32)
           for s in shapes] for _ in range(steps)]
    return ws, gs


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [state]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _run_port(name, kw, path="perparam", steps=3, dtype=torch.float32,
              upd=None, ws=None, start=0, post=None):
    wv, gv = _values(steps + start)
    if upd is None:
        o = opt.create(name, learning_rate=0.05, wd=0.01, **kw)
        if post is not None:
            post(o)
        upd = opt.get_updater(o)
    if ws is None:
        ws = [NDArray(torch.from_numpy(w.copy()).to(dtype)) for w in wv]
    for s in range(start, start + steps):
        gs = [NDArray(torch.from_numpy(g.copy()).to(dtype)) for g in gv[s]]
        if path == "fused":
            fastpath.apply_updater(upd, [(i, gs[i], ws[i])
                                         for i in range(len(ws))])
        else:
            for i in range(len(ws)):
                upd(i, gs[i], ws[i])
    return ws, upd


def _run_jax(name, kw, steps=3, dtype=jnp.float32, upd=None, ws=None,
             start=0, post=None):
    wv, gv = _values(steps + start)
    if upd is None:
        o = jopt.create(name, learning_rate=0.05, wd=0.01, **kw)
        if post is not None:
            post(o)
        upd = jopt.get_updater(o)
    if ws is None:
        ws = [JNDArray(jnp.asarray(w, dtype), jmx.cpu()) for w in wv]
    for s in range(start, start + steps):
        gs = [JNDArray(jnp.asarray(g, dtype), jmx.cpu()) for g in gv[s]]
        for i in range(len(ws)):
            upd(i, gs[i], ws[i])
    return ws, upd


def _assert_match(pws, pupd, jws, jupd, tol=TOL):
    for i, (pw, jw) in enumerate(zip(pws, jws)):
        np.testing.assert_allclose(_np(pw._data), _np(jw._data), rtol=tol,
                                   atol=tol, err_msg="weight %d" % i)
        pl, jl = _leaves(pupd.states[i]), _leaves(jupd.states[i])
        assert len(pl) == len(jl)
        for a, b in zip(pl, jl):
            np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                                       err_msg="state of %d" % i)


def test_registry_has_the_jax_names():
    assert sorted(opt.Optimizer.opt_registry) == \
        sorted(jopt.Optimizer.opt_registry)
    assert len(opt.Optimizer.opt_registry) == 17


@pytest.mark.parametrize("name,kw", DETERMINISTIC, ids=DET_IDS)
def test_three_updates_match_jax(name, kw):
    _assert_match(*_run_port(name, kw), *_run_jax(name, kw))


def _scalars(module):
    def post(o):
        o.rescale_grad = 0.5
        o.clip_gradient = 0.3
        o.set_lr_mult({0: 0.5, 1: 2.0})
        o.lr_scheduler = module.FactorScheduler(step=2, factor=0.5)
        o.lr_scheduler.base_lr = o.lr
    return post


@pytest.mark.parametrize("name,kw", DETERMINISTIC, ids=DET_IDS)
def test_rescale_clip_wd_lr_mult_and_scheduler_match_jax(name, kw):
    _assert_match(*_run_port(name, kw, steps=4, post=_scalars(lrs)),
                  *_run_jax(name, kw, steps=4, post=_scalars(jlrs)))


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_fused_equals_per_parameter_bitwise(name, kw):
    mx.random.seed(5)
    a, ua = _run_port(name, kw, "perparam")
    mx.random.seed(5)
    b, ub = _run_port(name, kw, "fused")
    for x, y in zip(a, b):
        assert x.asnumpy().tobytes() == y.asnumpy().tobytes()
    for i in ua.states:
        for x, y in zip(_leaves(ua.states[i]), _leaves(ub.states[i])):
            assert x.numpy().tobytes() == y.numpy().tobytes()


@pytest.mark.parametrize("low", ["float16", "bfloat16"])
@pytest.mark.parametrize("name,kw", DETERMINISTIC, ids=DET_IDS)
def test_multi_precision_matches_jax(name, kw, low):
    kw = dict(kw, multi_precision=True)
    pws, pupd = _run_port(name, kw, dtype=getattr(torch, low))
    jws, jupd = _run_jax(name, kw, dtype=getattr(jnp, low))
    for i, (pw, jw) in enumerate(zip(pws, jws)):
        assert pw._data.dtype == getattr(torch, low)
        master, base = pupd.states[i]
        jmaster, jbase = jupd.states[i]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(master.numpy(), _np(jmaster), rtol=TOL,
                                   atol=TOL)
        for a, b in zip(_leaves(base), _leaves(jbase)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=TOL, atol=TOL)
        # the weight is the master cast back
        assert torch.equal(pw._data, master.to(pw._data.dtype))


@pytest.mark.parametrize("name,kw", DETERMINISTIC, ids=DET_IDS)
def test_states_files_load_across_packages(name, kw):
    # port -> JAX
    pws, pupd = _run_port(name, kw, steps=2)
    jws0, jupd0 = _run_jax(name, kw, steps=2)
    blob = pupd.get_states()
    jopt_ = jopt.create(name, learning_rate=0.05, wd=0.01, **kw)
    jupd = jopt.get_updater(jopt_)
    jupd.set_states(blob)
    jopt_._index_update_count = dict(jupd0.optimizer._index_update_count)
    jopt_.num_update = jupd0.optimizer.num_update
    if name == "nadam":
        jopt_.m_schedule = jupd0.optimizer.m_schedule
    jws = [JNDArray(jnp.asarray(w.asnumpy()), jmx.cpu()) for w in pws]
    # JAX -> port
    popt = opt.create(name, learning_rate=0.05, wd=0.01, **kw)
    pupd2 = opt.get_updater(popt)
    pupd2.set_states(jupd0.get_states(), device=torch.device("cpu"))
    popt._index_update_count = dict(pupd.optimizer._index_update_count)
    popt.num_update = pupd.optimizer.num_update
    if name == "nadam":
        popt.m_schedule = pupd.optimizer.m_schedule
    pws2 = [NDArray(torch.from_numpy(np.asarray(w._data).copy()))
            for w in jws0]
    # one more update everywhere, from the same place
    pws, pupd = _run_port(name, kw, steps=1, upd=pupd, ws=pws, start=2)
    jws, jupd = _run_jax(name, kw, steps=1, upd=jupd, ws=jws, start=2)
    _assert_match(pws, pupd, jws, jupd)
    pws2, pupd2 = _run_port(name, kw, steps=1, upd=pupd2, ws=pws2, start=2)
    _assert_match(pws2, pupd2, jws, jupd)


def _net(seed):
    mx.random.seed(seed)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="tanh", in_units=6),
            gluon.nn.Dense(3, in_units=8))
    net.initialize(mx.initializer.Xavier())
    return net


@pytest.mark.parametrize(
    "name,kw", [c for c in DETERMINISTIC if c[0] not in NO_PURE_STEP],
    ids=[i for i, c in zip(DET_IDS, DETERMINISTIC)
         if c[0] not in NO_PURE_STEP])
def test_pure_step_in_a_train_step_matches_eager_trainer(name, kw):
    rs = np.random.RandomState(1)
    xs = rs.randn(3, 8, 6).astype(np.float32)
    ys = (xs[:, :, :3].argmax(-1)).astype(np.float32)
    params = dict(kw, learning_rate=0.05, wd=0.01)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.cpu():
        eager = _net(3)
        trainer = gluon.Trainer(eager.collect_params(), name, dict(params))
        for x, y in zip(xs, ys):
            with autograd.record():
                loss = loss_fn(eager(nd.array(x)), nd.array(y))
            loss.backward()
            trainer.step(len(x))
        graph = _net(3)
        step = parallel.TrainStep(
            graph, loss_fn, name, parallel.device_mesh(1, devices=[mx.cpu()]),
            optimizer_params=params)
        for x, y in zip(xs, ys):
            step(nd.array(x), nd.array(y))
        step.copy_to_net()
    for a, b in zip(eager.collect_params().values(),
                    graph.collect_params().values()):
        np.testing.assert_allclose(a.data().asnumpy(), b.data().asnumpy(),
                                   rtol=1e-4, atol=1e-5)


def test_sgld_noise_moments_and_drift():
    n = 10000
    lr = 0.04
    o = opt.create("sgld", learning_rate=lr, rescale_grad=1.0)
    mx.random.seed(11)
    w = NDArray(torch.zeros(n))
    g = NDArray(torch.full((n,), 0.5))
    o.update(0, w, g, o.create_state(0, w))
    draws = w.asnumpy() + lr / 2 * 0.5  # the drift taken back out
    assert abs(draws.mean()) < 4 * np.sqrt(lr / n)
    assert abs(draws.var() / lr - 1.0) < 0.05
    # seeded alike, the per-parameter and fused paths draw alike
    mx.random.seed(11)
    w2 = NDArray(torch.zeros(n))
    fastpath.apply_updater(opt.get_updater(o), [(0, g, w2)])
    assert np.array_equal(w2.asnumpy(), w.asnumpy())
    assert o._host_scalars_stateful


def test_stateful_prologues_fuse_for_one_position_only():
    for name in ("nadam", "sgld"):
        o = opt.create(name)
        assert fastpath.supports(o, 1) and not fastpath.supports(o, 2)
    assert fastpath.supports(opt.create("adam"), 2)


@pytest.mark.parametrize("name", ["nadam", "ftml", "adamax"])
def test_train_plane_carries_the_prologue_to_the_kernel(name):
    """``TrainPlane`` feeds the kernel the prologue's counts, rates and
    extras (Nadam's schedule) as device scalars: its steps match eager
    ``Trainer`` steps."""
    from mxnet_tpu_torch import trainplane

    rs = np.random.RandomState(2)
    xs = rs.randn(3, 8, 6).astype(np.float32)
    ys = (xs[:, :, :3].argmax(-1)).astype(np.float32)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = {"learning_rate": 0.01, "wd": 0.01}
    with mx.cpu():
        eager = _net(4)
        trainer = gluon.Trainer(eager.collect_params(), name, dict(params))
        for x, y in zip(xs, ys):
            with autograd.record():
                loss = loss_fn(eager(nd.array(x)), nd.array(y))
            loss.backward()
            trainer.step(len(x))
        graph = _net(4)
        plane = trainplane.TrainPlane(graph, loss_fn, gluon.Trainer(
            graph.collect_params(), name, dict(params)))
        for x, y in zip(xs, ys):
            plane.step(nd.array(x), nd.array(y))
    assert plane.plane == "graph"
    for a, b in zip(eager.collect_params().values(),
                    graph.collect_params().values()):
        np.testing.assert_allclose(a.data().asnumpy(), b.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6)
