"""The port's training plane against its eager loop and the JAX package's
plane (CPU): the port of ``tests/test_trainplane.py:69-150``,
``:180-240`` and ``:257-390``.

* In float32 the graph plane equals the eager fastpath (record, backward,
  ``Trainer.step`` through the fused apply) bit for bit over 5 steps, SGD
  with momentum and Adam, losses and weights; both equal the JAX
  package's graph plane on the same weights (``params_from_jax``) and
  batches within ``TOL``.
* One ``STEP_DISPATCHES{plane="graph"}`` a step and no
  ``OPT_DISPATCHES``, as in the JAX plane.
* The demotions, by reason, each counted in ``FALLBACKS``: a forward that
  reads back to the host, a plain ``Block``, ``MXNET_FASTPATH=0``, an
  optimizer without a list kernel, ``grad_req='add'``; the eager loop
  then trains. ``MXNET_TRAINSTEP=0`` runs eagerly and counts nothing, in
  both packages. ``MXNET_ZERO`` and ``fit``'s checkpoints raise.
* ``MXNET_TRAIN_DTYPE=bf16``: the graph plane against an explicit eager
  bfloat16 run with ``multi_precision`` (rtol and atol 1e-2, as the JAX
  test) and against the JAX plane in the same mode (the same), weights
  bfloat16 and masters and momenta float32.
* One step counter across ``TrainStep``, the plane and eager steps: the
  lr schedule reads the same point as an all-eager run, in both packages.
* ``fit`` over an ``NDArrayIter`` trains on the graph plane.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import trainplane as jtrainplane
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import (MXNetError, autograd, gluon, lr_scheduler, nd,
                             optimizer, parallel, telemetry, trainplane)
from mxnet_tpu_torch.gluon import nn

B = 8  # a power of two: the 1/B loss scaling is exact
TOL = 2e-5  # fp32, two packages (test_decode.py:46-51)
BF16_TOL = 1e-2  # tests/test_trainplane.py:257


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=3):
    rs = np.random.RandomState(seed)
    return (rs.rand(5 * B, 6).astype(np.float32),
            rs.randint(0, 8, (5 * B,)))


def _jax_mlp(xs):
    net = jnn.HybridSequential()
    with net.name_scope():
        net.add(jnn.Dense(16, activation="relu"))
        net.add(jnn.Dense(8))
    net.initialize()
    with jmx.autograd.pause():
        net(jmx.nd.array(xs[:B]))
    return net


def _arrays(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _port_mlp(arrays):
    with mx.cpu():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu"))
            net.add(nn.Dense(8))
        net.initialize()
        gluon.params_from_jax(net, arrays)
        with autograd.pause():
            net(nd.array(np.zeros((1, 6), np.float32)))
    return net


def _plane(net, opt, opt_params, loss_fn=None):
    tr = gluon.Trainer(net.collect_params(), opt, dict(opt_params))
    return trainplane.TrainPlane(
        net, loss_fn or gluon.loss.SoftmaxCrossEntropyLoss(), tr,
        mesh=parallel.device_mesh(1, devices=[mx.cpu()]))


def _jax_plane(net, opt, opt_params, loss_fn=None):
    tr = jmx.gluon.Trainer(net.collect_params(), opt, dict(opt_params))
    return jtrainplane.TrainPlane(
        net, loss_fn or jmx.gluon.loss.SoftmaxCrossEntropyLoss(), tr,
        mesh=jparallel.device_mesh(1))


def _batch(xs, ys, s):
    return xs[s * B:(s + 1) * B], ys[s * B:(s + 1) * B]


def _values(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
])
def test_graph_plane_matches_eager_fastpath(monkeypatch, opt, opt_params):
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    xs, ys = _data()
    jnet = _jax_mlp(xs)
    arrays = _arrays(jnet)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net_e = _port_mlp(arrays)
    net_e.hybridize()
    tr_e = gluon.Trainer(net_e.collect_params(), opt, dict(opt_params))
    net_g = _port_mlp(arrays)
    plane = _plane(net_g, opt, opt_params)
    jplane = _jax_plane(jnet, opt, opt_params)
    for s in range(5):
        x, y = _batch(xs, ys, s)
        with mx.cpu():
            with autograd.record():
                le = loss_fn(net_e(nd.array(x)), nd.array(y))
            le.backward()
            tr_e.step(B)
            lg = plane.step(nd.array(x), nd.array(y))
        lj = jplane.step(jmx.nd.array(x), jmx.nd.array(y))
        np.testing.assert_array_equal(lg.asnumpy(), le.asnumpy())
        np.testing.assert_allclose(lg.asnumpy(), lj.asnumpy(), rtol=TOL,
                                   atol=TOL)
    assert plane.plane == "graph" and jplane.plane == "graph"
    for ve, vg, vj in zip(_values(net_e), _values(net_g), _values(jnet)):
        np.testing.assert_array_equal(vg, ve)
        np.testing.assert_allclose(vg, vj, rtol=TOL, atol=TOL)
    # the optimizer state lives in the trainer's updater, as eager's does
    st_g = plane._trainer._updater.states
    st_e = tr_e._updater.states
    assert set(st_g) == set(st_e)
    for i in st_g:
        for a, b in zip(torch.utils._pytree.tree_leaves(st_g[i]),
                        torch.utils._pytree.tree_leaves(st_e[i])):
            assert torch.equal(a, b)


def _opt_total():
    return (telemetry.OPT_DISPATCHES.value(path="perparam")
            + telemetry.OPT_DISPATCHES.value(path="fused"))


def test_graph_plane_one_dispatch_per_step(monkeypatch):
    """Exactly one step dispatch a step and no optimizer dispatch, in
    both packages' counters."""
    from mxnet_tpu import telemetry as jtelemetry

    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    xs, ys = _data(11)
    jnet = _jax_mlp(xs)
    net = _port_mlp(_arrays(jnet))
    sgd = {"learning_rate": 0.1}
    plane, jplane = _plane(net, "sgd", sgd), _jax_plane(jnet, "sgd", sgd)
    with mx.cpu():
        plane.step(nd.array(xs[:B]), nd.array(ys[:B]))  # activate
    jplane.step(jmx.nd.array(xs[:B]), jmx.nd.array(ys[:B]))
    g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
    o0 = _opt_total()
    jg0 = jtelemetry.STEP_DISPATCHES.value(plane="graph")
    jo0 = (jtelemetry.OPT_DISPATCHES.value(path="perparam")
           + jtelemetry.OPT_DISPATCHES.value(path="fused"))
    for s in range(1, 4):
        x, y = _batch(xs, ys, s)
        with mx.cpu():
            plane.step(nd.array(x), nd.array(y))
        jplane.step(jmx.nd.array(x), jmx.nd.array(y))
    assert telemetry.STEP_DISPATCHES.value(plane="graph") - g0 == 3
    assert _opt_total() - o0 == 0
    assert jtelemetry.STEP_DISPATCHES.value(plane="graph") - jg0 == 3
    assert (jtelemetry.OPT_DISPATCHES.value(path="perparam")
            + jtelemetry.OPT_DISPATCHES.value(path="fused")) - jo0 == 0
    assert plane.compile_count == 1


class _HostSyncBlock(gluon.HybridBlock):
    """Reads a value back to the host in its forward: not capturable."""

    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.dense = nn.Dense(4)

    def hybrid_forward(self, F, x):
        _ = float(x.asnumpy().sum())
        return self.dense(x)


class _PlainBlock(gluon.Block):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.dense = nn.Dense(4)

    def forward(self, x):
        return self.dense(x)


class _NoKernel(optimizer.SGD):
    """SGD through ``update`` only: no list kernel to fuse or capture."""

    _leaf_step = optimizer.Optimizer._leaf_step

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.sub_(self._get_lr(index) * self.rescale_grad
                              * grad._data)
        return state


def _dense_plane(net, opt="sgd"):
    with mx.cpu():
        net.initialize()
        net(nd.array(np.zeros((B, 6), np.float32)))
    return _plane(net, opt, {} if not isinstance(opt, str)
                  else {"learning_rate": 0.1}, gluon.loss.L2Loss())


def _fallbacks(counter):
    """reason -> count."""
    return {row["labels"]["reason"]: row["value"]
            for row in counter.series()}


@pytest.mark.parametrize("case,reason", [
    ("host_sync", "capture: MXNetError"),
    ("plain_block", "net is not a HybridBlock"),
    ("fastpath_off", "MXNET_FASTPATH=0 (legacy escape hatch)"),
    ("no_list_kernel", "optimizer has no list kernel"),
    ("grad_req_add", "grad_req 'add' on"),
])
def test_demotions_by_reason(monkeypatch, case, reason):
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    xs, _ = _data(17)
    ys = np.random.RandomState(18).rand(5 * B, 4).astype(np.float32)
    with mx.cpu():
        if case == "host_sync":
            net = _HostSyncBlock()
        elif case == "plain_block":
            net = _PlainBlock()
        else:
            net = nn.Dense(4)
    if case == "fastpath_off":
        monkeypatch.setenv("MXNET_FASTPATH", "0")
    opt = _NoKernel(learning_rate=0.1) if case == "no_list_kernel" \
        else "sgd"
    plane = _dense_plane(net, opt)
    if case == "grad_req_add":
        net.collect_params()[net.prefix + "weight"].grad_req = "add"
    before = _fallbacks(telemetry.TRAINPLANE_FALLBACKS)
    with mx.cpu():
        losses = [float(plane.step(nd.array(x), nd.array(y))
                        .asnumpy().mean())
                  for x, y in (_batch(xs, ys, s) for s in range(5))]
    assert plane.plane == "eager"
    assert plane._why_eager.startswith(reason)
    after = _fallbacks(telemetry.TRAINPLANE_FALLBACKS)
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    assert list(moved.values()) == [1]
    assert list(moved)[0].startswith(reason)
    assert trainplane.FALLBACKS is telemetry.TRAINPLANE_FALLBACKS
    assert losses[-1] < losses[0]  # it trained, eagerly
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_trainstep_zero_runs_eager_uncounted(monkeypatch, pkg):
    monkeypatch.setenv("MXNET_TRAINSTEP", "0")
    xs, ys = _data(21)
    jnet = _jax_mlp(xs)
    if pkg == "port":
        plane = _plane(_port_mlp(_arrays(jnet)), "sgd",
                       {"learning_rate": 0.1})
        counter, x, y = telemetry.TRAINPLANE_FALLBACKS, nd.array, nd.array
    else:
        plane = _jax_plane(jnet, "sgd", {"learning_rate": 0.1})
        counter = jtrainplane.FALLBACKS
        x = y = jmx.nd.array
    before = _fallbacks(counter)
    with mx.cpu():
        plane.step(x(xs[:B]), y(ys[:B]))
    assert plane.plane == "eager"
    assert _fallbacks(counter) == before


def test_rebound_state_recaptures(monkeypatch):
    """A state replaced after the capture (a restore) holds another
    address than the graph baked in: the plane captures again, and the
    run still equals the eager fastpath bit for bit."""
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    xs, ys = _data(47)
    arrays = _arrays(_jax_mlp(xs))
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net_e, net_g = _port_mlp(arrays), _port_mlp(arrays)
    tr_e = gluon.Trainer(net_e.collect_params(), "sgd", dict(sgd))
    plane = _plane(net_g, "sgd", sgd)
    for s in range(4):
        x, y = _batch(xs, ys, s)
        if s == 2:
            for upd in (plane._trainer._updater, tr_e._updater):
                upd.states[0] = upd.states[0].clone()
        with mx.cpu():
            with autograd.record():
                le = loss_fn(net_e(nd.array(x)), nd.array(y))
            le.backward()
            tr_e.step(B)
            lg = plane.step(nd.array(x), nd.array(y))
        np.testing.assert_array_equal(lg.asnumpy(), le.asnumpy())
    assert plane.plane == "graph" and plane.compile_count == 2
    for a, b in zip(_values(net_g), _values(net_e)):
        np.testing.assert_array_equal(a, b)


def test_unported_knobs_raise(monkeypatch):
    # MXNET_ZERO and fit(checkpoint=) are ported: on one process the
    # sharded plane declines with the JAX package's 1-device reason,
    # counted, and the graph step runs replicated
    from mxnet_tpu_torch.fastpath import zero

    xs, ys = _data(22)
    net = _port_mlp(_arrays(_jax_mlp(xs)))
    plane = _plane(net, "sgd", {"learning_rate": 0.1})
    monkeypatch.setenv("MXNET_ZERO", "1")
    reason = "1-device mesh (sharding is a no-op)"
    before = zero.FALLBACKS.value(reason=reason)
    with mx.cpu():
        loss = plane.step(nd.array(xs[:B]), nd.array(ys[:B]))
    assert np.isfinite(loss.asnumpy()).all()
    assert zero.FALLBACKS.value(reason=reason) == before + 1
    # batch_axis is ported (tests/test_torch_dist_planes.py); a mesh of
    # several devices in one process still raises: a process drives one
    # device
    from mxnet_tpu_torch import parallel

    two = parallel.Mesh([(0, "cpu"), (1, "cpu")])
    with pytest.raises(MXNetError, match="drives one device"):
        trainplane.TrainPlane(net, gluon.loss.L2Loss(), plane._trainer,
                              mesh=two)


def _jbf16(x):
    import jax.numpy as jnp

    return jmx.nd.NDArray(jnp.asarray(x, jnp.bfloat16), jmx.cpu())


def test_bf16_mode_master_weights_and_loss(monkeypatch):
    """``MXNET_TRAIN_DTYPE=bf16``: the graph plane trains in bfloat16 with
    float32 masters, matching an explicit eager bfloat16 run with
    ``multi_precision`` and the JAX plane in the same mode."""
    xs, ys = _data(31)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    jnet = _jax_mlp(xs)
    arrays = _arrays(jnet)
    net_e = _port_mlp(arrays)
    net_e.cast("bfloat16")
    tr_e = gluon.Trainer(net_e.collect_params(), "sgd",
                         dict(sgd, multi_precision=True))
    net_g = _port_mlp(arrays)
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    monkeypatch.setenv("MXNET_TRAIN_DTYPE", "bf16")
    plane = _plane(net_g, "sgd", sgd)
    jplane = _jax_plane(jnet, "sgd", sgd)
    for s in range(3):
        x, y = _batch(xs, ys, s)
        with mx.cpu():
            with autograd.record():
                le = loss_fn(net_e(nd.array(x).astype("bfloat16")),
                             nd.array(y))
            le.backward()
            tr_e.step(B)
            lg = plane.step(nd.array(x), nd.array(y))
        lj = jplane.step(jmx.nd.array(x), jmx.nd.array(y))
        assert lg._data.dtype == torch.bfloat16
        np.testing.assert_allclose(lg.asnumpy(), le.asnumpy(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(lg.asnumpy(),
                                   lj.asnumpy().astype(np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)
    assert plane.plane == "graph" and jplane.plane == "graph"
    assert plane._trainer._optimizer.multi_precision
    for p in net_g.collect_params().values():
        assert p.data()._data.dtype == torch.bfloat16
    for st in plane._trainer._updater.states.values():
        master, base = st
        assert master.dtype == torch.float32 and base.dtype == torch.float32
    for a, b in zip(_values(net_g), _values(jnet)):
        np.testing.assert_allclose(a, b.astype(np.float32), rtol=BF16_TOL,
                                   atol=BF16_TOL)


def _counter_run(pkg):
    """2 eager + 3 TrainStep + 2 eager steps under FactorScheduler(2,
    0.5); returns (num_update after each phase, the final lr, the lr an
    all-eager run reads at 7)."""
    xs, _ = _data(41)
    lbl = np.random.RandomState(42).rand(B, 4).astype(np.float32)
    if pkg == "jax":
        m, lrs, par, nnm, ndm = (jmx, jmx.lr_scheduler, jparallel, jnn,
                                 jmx.nd)
        mesh = jparallel.device_mesh(1)
    else:
        m, lrs, par, nnm, ndm = mx, lr_scheduler, parallel, nn, nd
        mesh = parallel.device_mesh(1, devices=[mx.cpu()])
    loss_fn = m.gluon.loss.L2Loss()
    sched = lrs.FactorScheduler(step=2, factor=0.5)
    opt = m.optimizer.create("sgd", learning_rate=0.8, lr_scheduler=sched)
    with mx.cpu():
        net = nnm.Dense(4)
        net.initialize()
        with m.autograd.pause():
            net(ndm.array(xs[:B]))
        tr = m.gluon.Trainer(net.collect_params(), opt)
        step = par.TrainStep(net, loss_fn, opt, mesh)

        def eager_step():
            with m.autograd.record():
                loss = loss_fn(net(ndm.array(xs[:B])), ndm.array(lbl))
            loss.backward()
            tr.step(B)

        seen = []
        for _ in range(2):
            eager_step()
        seen.append(opt.num_update)
        for _ in range(3):
            step(ndm.array(xs[:B]), ndm.array(lbl))
        seen.append((step._t, opt.num_update))
        for _ in range(2):
            eager_step()
        seen.append(opt.num_update)
    ref = lrs.FactorScheduler(step=2, factor=0.5)
    ref.base_lr = 0.8
    return seen, opt.learning_rate, ref(7)


def test_mixed_trainstep_eager_counter_and_lr_schedule():
    """``tests/test_trainplane.py:310``: TrainStep._t and num_update share
    one source of truth, in the port as in the JAX package."""
    port, jax_ = _counter_run("port"), _counter_run("jax")
    assert port[0] == [2, (5, 5), 7]
    assert port[1] == port[2]
    assert port == jax_


def test_plane_and_eager_steps_share_the_counter_and_schedule(monkeypatch):
    """Graph-plane steps interleaved with eager steps: the per-index
    counts and the lr schedule move as 7 eager steps move them, and the
    weights equal an all-eager run's bit for bit."""
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    xs, ys = _data(43)
    arrays = _arrays(_jax_mlp(xs))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def run(graph_steps):
        net = _port_mlp(arrays)
        sched = lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = optimizer.create("adam", learning_rate=0.02,
                               lr_scheduler=sched)
        tr = gluon.Trainer(net.collect_params(), opt)
        plane = trainplane.TrainPlane(net, loss_fn, tr)
        for s in range(7):
            x, y = _batch(xs, ys, s % 5)
            with mx.cpu():
                if s in graph_steps:
                    plane.step(nd.array(x), nd.array(y))
                    continue
                with autograd.record():
                    loss = loss_fn(net(nd.array(x)), nd.array(y))
                loss.backward()
                tr.step(B)
        return net, opt

    net_m, opt_m = run({2, 3, 4})
    net_e, opt_e = run(set())
    assert opt_m.num_update == opt_e.num_update == 7
    assert opt_m._index_update_count == opt_e._index_update_count
    assert opt_m.learning_rate == opt_e.learning_rate
    for a, b in zip(_values(net_m), _values(net_e)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sync_num_update_seeds_fresh_indices(pkg):
    m = mx if pkg == "port" else jmx
    opt = m.optimizer.create("adam", learning_rate=0.01)
    opt.sync_num_update(10)
    assert opt._index_update_count == {}
    opt._update_count(0)
    assert opt._index_update_count[0] == 11
    assert opt.num_update == 11


def test_fit_trains_on_the_graph_plane(monkeypatch):
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    xs, _ = _data(45)
    ys = xs[:, :4].argmax(1)  # learnable: random labels pin the loss
    net = _port_mlp(_arrays(_jax_mlp(xs)))
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    seen = []
    with mx.cpu():
        it = mx.io.NDArrayIter(xs, ys, batch_size=B)
        g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
        plane = trainplane.fit(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), tr, it, epochs=3,
            batch_end_callback=lambda e, n, loss: seen.append(
                float(loss.asnumpy().mean())))
    assert plane.plane == "graph"
    assert telemetry.STEP_DISPATCHES.value(plane="graph") - g0 == 15
    assert len(seen) == 15
    assert np.mean(seen[10:]) < np.mean(seen[:5])  # epoch 3 below epoch 1
