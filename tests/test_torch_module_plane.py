"""The port's module plane (``trainplane.module_plane``, the whole
``Module.fit`` step as one captured graph) against its eager executor
branch and against the JAX package's plane (CPU); the port of
``tests/test_trainplane.py:369-436``.

* ``Module.fit`` on the graph plane equals ``fit`` on the eager branch
  (``MXNET_TRAINSTEP=0``: ``forward_backward`` + ``update``) bit for bit
  in fp32, weights and moving statistics, on an MLP and on a LeNet-style
  net with BatchNorm, with one ``STEP_DISPATCHES{plane="graph"}`` a batch
  and no ``OPT_DISPATCHES``; the same between single steps and a rebound
  weight (a recapture).
* Each demotion gives the JAX package's decision and ``FALLBACKS`` label
  on the same module: ``MXNET_FASTPATH=0``, several contexts, a kvstore,
  an updater that is not ``Updater``, an optimizer without a list kernel
  and ``inputs_need_grad`` (``"module-config"``), ``grad_req="add"`` and
  no trainable parameter (``"module-trace: _Ineligible"``);
  ``MXNET_TRAINSTEP=0`` and a ``Module`` subclass decline uncounted. The
  one deviation, kept on purpose: a custom op that reads back to the
  host (the numpy softmax op) demotes in the port
  (``"module-trace: MXNetError"``), where the JAX plane runs it in a host
  callback inside its compiled step; a CUDA graph cannot run Python.
* The port's ``fit`` on its plane against the JAX package's ``fit`` on
  its plane, the BatchNorm net, 2 epochs from the same weights: weights
  and moving statistics within ``TOL``.
* The executor's outputs are the step's own copies: an earlier batch's
  outputs are not overwritten by a later step.
* ``rtc.add_launches`` adds a capture's launches at every replay.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import trainplane as jtrainplane

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc, telemetry, trainplane

B = 16
TOL = 1e-5  # fp32, two packages, 8 SGD steps with momentum
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


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


NETS = {"mlp": (_mlp, (6,)), "lenet_bn": (_lenet, (1, 8, 8))}


def _data(shape, seed=5):
    rs = np.random.RandomState(seed)
    xs = rs.rand(4 * B, *shape).astype(np.float32)
    return xs, rs.randint(0, 4, (4 * B,)).astype(np.float32)


def _fit(pkg, net, monkeypatch, trainstep="auto", epochs=2):
    """``Module.fit`` of ``net`` on ``pkg``; returns (module, weights,
    auxiliary states) as numpy."""
    make, shape = NETS[net]
    xs, ys = _data(shape)
    monkeypatch.setenv("MXNET_TRAINSTEP", trainstep)
    with pkg.cpu():
        pkg.random.seed(7)
        it = pkg.io.NDArrayIter(xs, ys, B, shuffle=True)
        mod = pkg.module.Module(make(pkg), context=pkg.cpu())
        mod.fit(it, optimizer="sgd", optimizer_params=dict(SGD),
                initializer=pkg.initializer.Xavier(), num_epoch=epochs)
        args, aux = mod.get_params()
    return (mod, {k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _opt_dispatches():
    return sum(telemetry.OPT_DISPATCHES.value(path=p)
               for p in ("fused", "perparam"))


@pytest.mark.parametrize("net", sorted(NETS))
def test_graph_plane_equals_eager_fit_bitwise(monkeypatch, net):
    g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
    o0 = _opt_dispatches()
    _, gw, ga = _fit(mx, net, monkeypatch)
    assert telemetry.STEP_DISPATCHES.value(plane="graph") - g0 == 8  # 2 x 4
    assert _opt_dispatches() == o0
    _, ew, ea = _fit(mx, net, monkeypatch, trainstep="0")
    assert telemetry.STEP_DISPATCHES.value(plane="graph") - g0 == 8
    assert sorted(gw) == sorted(ew) and sorted(ga) == sorted(ea)
    for name in gw:
        np.testing.assert_array_equal(gw[name], ew[name], err_msg=name)
    for name in ga:  # the BatchNorm moving statistics moved, alike
        np.testing.assert_array_equal(ga[name], ea[name], err_msg=name)
        start = 0.0 if name.endswith("mean") else 1.0
        assert np.abs(ga[name] - start).max() > 1e-3, name


def _bound(pkg, net="mlp", **bind_kw):
    make, shape = NETS[net]
    xs, ys = _data(shape)
    with pkg.cpu():
        pkg.random.seed(7)
        it = pkg.io.NDArrayIter(xs, ys, B)
        mod = pkg.module.Module(make(pkg), context=pkg.cpu(),
                                **bind_kw.pop("module_kw", {}))
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label, **bind_kw)
        mod.init_params(pkg.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    return mod, it


def _fallbacks(pkg):
    fb = jtrainplane.FALLBACKS if pkg is jmx else trainplane.FALLBACKS
    return {r["labels"]["reason"]: r["value"] for r in fb.series()}


def _decide(pkg, mod):
    """(plane or None, the FALLBACKS labels counted by the decision)."""
    plane_mod = jtrainplane if pkg is jmx else trainplane
    before = _fallbacks(pkg)
    with pkg.cpu():
        plane = plane_mod.module_plane(mod)
    after = _fallbacks(pkg)
    return plane, {k: v - before.get(k, 0.0) for k, v in after.items()
                   if v != before.get(k, 0.0)}


class _NotAnUpdater(object):
    def __init__(self, inner):
        self.inner = inner
        self.states = inner.states

    def __call__(self, *args):
        return self.inner(*args)


def _fastpath_off(mod, monkeypatch):
    monkeypatch.setenv("MXNET_FASTPATH", "0")


def _two_contexts(mod, monkeypatch):
    monkeypatch.setattr(mod, "_context", list(mod._context) * 2)


def _kvstore(mod, monkeypatch):
    monkeypatch.setattr(mod, "_kvstore", object())


def _custom_updater(mod, monkeypatch):
    monkeypatch.setattr(mod, "_updater", _NotAnUpdater(mod._updater))


def _no_list_kernel(mod, monkeypatch):
    opt = mod._optimizer
    monkeypatch.setattr(type(opt), "fastpath_capable", property(
        lambda self: False))


def _grad_req_add(mod, monkeypatch):
    mod._exec_group.execs[0].grad_req["fc1_weight"] = "add"


def _no_trainable(mod, monkeypatch):
    ex = mod._exec_group.execs[0]
    for name in list(ex.grad_req):
        ex.grad_req[name] = "null"
    ex.grad_dict.clear()


DEMOTIONS = {
    "fastpath_off": (_fastpath_off, "module-config"),
    "two_contexts": (_two_contexts, "module-config"),
    "kvstore": (_kvstore, "module-config"),
    "custom_updater": (_custom_updater, "module-config"),
    "no_list_kernel": (_no_list_kernel, "module-config"),
    "grad_req_add": (_grad_req_add, "module-trace: _Ineligible"),
    "no_trainable": (_no_trainable, "module-trace: _Ineligible"),
}


@pytest.mark.parametrize("case", sorted(DEMOTIONS))
def test_demotion_reason_matches_jax(monkeypatch, case):
    change, label = DEMOTIONS[case]
    for pkg in (jmx, mx):
        mod, _ = _bound(pkg)
        plane, counted = _decide(pkg, mod)
        assert plane is not None, pkg.__name__  # eligible as bound
        change(mod, monkeypatch)
        plane, counted = _decide(pkg, mod)
        assert plane is None and counted == {label: 1.0}, (pkg.__name__,
                                                           counted)
        monkeypatch.undo()


def test_inputs_need_grad_demotes_as_in_jax():
    for pkg in (jmx, mx):
        mod, _ = _bound(pkg, inputs_need_grad=True)
        plane, counted = _decide(pkg, mod)
        assert plane is None and counted == {"module-config": 1.0}


@pytest.mark.parametrize("how", ["trainstep_0", "subclass"])
def test_uncounted_declines_as_in_jax(monkeypatch, how):
    for pkg in (jmx, mx):
        mod, _ = _bound(pkg)
        if how == "trainstep_0":
            monkeypatch.setenv("MXNET_TRAINSTEP", "0")
        else:
            mod.__class__ = type("Sub", (type(mod),), {})
        plane, counted = _decide(pkg, mod)
        assert plane is None and counted == {}
        monkeypatch.undo()


def test_numpy_op_demotes_where_jax_runs_it_in_a_callback():
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as cr

    import test_torch_module_fit as fit_test

    fit_test._jax_example()  # registers np_softmax_ce with the JAX package
    xs, ys = _data((6,))
    mods = []
    for pkg, symbol in ((jmx, fit_test._jax_symbol()),
                        (mx, cr.get_symbol("np_softmax_ce"))):
        with pkg.cpu():
            it = pkg.io.NDArrayIter(xs, ys, B)
            mod = pkg.module.Module(symbol, context=pkg.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(pkg.initializer.Xavier())
            mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
        mods.append(_decide(pkg, mod))
    assert mods[0][0] is not None and mods[0][1] == {}
    assert mods[1][0] is None
    assert mods[1][1] == {"module-trace: MXNetError": 1.0}


def test_fit_on_the_plane_matches_the_jax_plane(monkeypatch):
    g0 = jmx.telemetry.STEP_DISPATCHES.value(plane="graph")
    _, jw, ja = _fit(jmx, "lenet_bn", monkeypatch)
    assert jmx.telemetry.STEP_DISPATCHES.value(plane="graph") - g0 == 8
    g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
    _, tw, ta = _fit(mx, "lenet_bn", monkeypatch)
    assert telemetry.STEP_DISPATCHES.value(plane="graph") - g0 == 8
    assert sorted(tw) == sorted(jw) and sorted(ta) == sorted(ja)
    for name in jw:
        np.testing.assert_allclose(tw[name], jw[name], rtol=TOL, atol=TOL,
                                   err_msg=name)
    for name in ja:
        np.testing.assert_allclose(ta[name], ja[name], rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_single_steps_and_a_rebound_weight_recapture():
    """Plane steps interleave with eager ones; a ``set_params`` of the
    bound shapes writes the executor's tensors in place and keeps the
    captured path, and a rebound weight (a new tensor in the executor)
    makes a new path; every step equals the eager module's."""
    mods = [_bound(mx, "lenet_bn") for _ in range(2)]
    (gm, it), (em, _) = mods
    plane = trainplane.module_plane(gm)
    assert plane.compile_count == 1
    batches = list(it)
    assert len(batches) > 3
    counts = []
    with mx.cpu():
        for i, batch in enumerate(batches):
            if i == 2:
                args, aux = gm.get_params()
                args = {k: v.copy() for k, v in args.items()}
                aux = {k: v.copy() for k, v in aux.items()}
                gm.set_params(args, aux)
                em.set_params(args, aux)
            if i == 3:
                w = gm._exec_group.execs[0].arg_dict["fc1_weight"]
                w._data = w._data.clone()
            if i == 1:  # an eager step on the plane's module
                gm.forward_backward(batch)
                gm.update()
            else:
                plane.step(batch)
            em.forward_backward(batch)
            em.update()
            counts.append(plane.compile_count)
    assert counts[:4] == [1, 1, 1, 2]
    assert plane.compile_count == 2
    for got, want in zip(gm.get_params(), em.get_params()):
        for name in want:
            assert torch.equal(got[name]._data, want[name]._data), name


def test_outputs_are_copies_and_survive_the_next_step():
    mod, it = _bound(mx)
    plane = trainplane.module_plane(mod)
    first, second = list(it)[:2]
    with mx.cpu():
        out1 = plane.step(first)[0]
        kept = out1.asnumpy().copy()
        plane.step(second)
    assert mod.get_outputs()[0] is not out1
    np.testing.assert_array_equal(out1.asnumpy(), kept)


def test_add_launches_counts_replays():
    class _K(object):
        launches = 0

    k = _K()
    total = rtc.Kernel.total_launches
    rtc.add_launches({k: 2}, 3)
    assert k.launches == 6 and rtc.Kernel.total_launches == total + 6
    rtc.add_launches({k: 2}, -1)
    assert k.launches == 4 and rtc.Kernel.total_launches == total + 4
    rtc.Kernel.total_launches = total
