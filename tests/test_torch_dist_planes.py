"""The captured training planes across the ranks of a job (CPU, gloo):
``TrainStep``, ``InferStep`` and ``TrainPlane`` over 2 ranks against the
JAX package's over 2 virtual devices on the same global batches, from
the JAX package's initial weights; the plane's sharded ``MXNET_ZERO``
step at levels 1 and 2 against the JAX plane's; ``fit`` with a
checkpoint and a resume against the JAX ``fit``; the module plane on
each rank's own data against the JAX ``Module.fit`` in one process; the
eager ``dist_sync`` Trainer's per-rank BatchNorm statistics; the
refusals; ``parallel.pipeline_apply`` over the 2 ranks against the JAX
one over 2 devices.

One 2-rank job (``tests/torch_dist_ranks.py``'s ``planes`` and
``pipeline`` cases) runs every case while this process runs the JAX
side. The tolerances are ``tests/test_parallel.py:120``'s: losses 1e-5 /
1e-6, parameters 1e-4 / 1e-5; the sharded plane's are
``tests/test_zero.py:324``'s, 1e-5 / 1e-6; the pipeline's
``tests/test_parallel.py:377``'s, 1e-4 / 1e-5. The ranks' weights must be
bit-equal.
"""
import os
import threading

import jax
import numpy as np
import pytest

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon, nd as jnd, parallel as jparallel
from mxnet_tpu import trainplane as jtrainplane
from mxnet_tpu.fastpath import zero as jzero

import torch_dist_ranks as R
from torch_dist_harness import run_cases

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ZERO_TOL = dict(rtol=1e-5, atol=1e-6)
PP_TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = ("conv", "bn", "axis1")


def _mesh(n):
    return jparallel.device_mesh(n, devices=jax.devices()[:n])


def _mesh_pp(n):
    return jparallel.device_mesh(n, axis_names=("pp",),
                                 devices=jax.devices()[:n])


def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x)


def _arrays(net):
    return [_np(p.data()) for p in net.collect_params().values()]


def _first(kind, d):
    return {"conv": d["xs"][0], "bn": d["bn"], "axis1": d["tx"][0]}[kind]


def _jax_net(kind, d, init=None):
    """A JAX net of ``kind``, materialized; with ``init`` (arrays in the
    net's parameter order) its weights set to those."""
    net = R.plane_net(jmx, kind)
    net.initialize()
    with jmx.autograd.pause():
        net(jnd.array(_first(kind, d)))
    if init is not None:
        for p, a in zip(net.collect_params().values(), init):
            p.set_data(jnd.array(a))
    return net


def _zero_mlp(init=None):
    """``tests/test_zero.py``'s MLP, materialized on its first batch; with
    ``init`` (arrays in parameter order) its weights set to those."""
    net = jgluon.nn.HybridSequential(prefix="zmlp_")
    with net.name_scope():
        net.add(jgluon.nn.Dense(16, activation="relu"))
        net.add(jgluon.nn.Dense(8))
    net.initialize()
    with jmx.autograd.pause():
        net(jnd.array(R.zero_data()[0][:R.ZERO_B]))
    if init is not None:
        for p, a in zip(net.collect_params().values(), init):
            p.set_data(jnd.array(a))
    net.hybridize()
    return net


def _module_init():
    rs = np.random.RandomState(31)
    return {"fc1_weight": rs.randn(8, 6).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rs.randn(3, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}


def _jax_side(d, init):
    """Every reading of the planes case, from the JAX package."""
    ce = jgluon.loss.SoftmaxCrossEntropyLoss()
    ce1 = jgluon.loss.SoftmaxCrossEntropyLoss(batch_axis=1)
    want = {}

    def trainstep(kind, n, params, loss_fn=ce, **kw):
        net = _jax_net(kind, d, init[kind])
        step = jparallel.TrainStep(net, loss_fn, "sgd", _mesh(n),
                                   optimizer_params=params, **kw)
        step.names = list(net.collect_params().keys())
        return step

    def trained(step):
        # in the net's order (the step's dict comes back key-sorted)
        return [np.asarray(step.params[k]) for k in step.names]

    for n in (2, 1):
        step = trainstep("conv", n, R.PL_SGD)
        want["ts_loss", n] = np.asarray([_np(step(
            jnd.array(d["xs"][k]), jnd.array(d["ys"][k])))
            for k in range(R.PL_K)])
        want["ts", n] = trained(step)
    step = trainstep("conv", 2, R.PL_MOM)
    want["mc_loss"] = _np(step.multi_call(jnd.array(d["xs"]),
                                          jnd.array(d["ys"])))
    want["mc"] = trained(step)
    step = trainstep("conv", 2, R.PL_SGD)
    want["rg_loss"] = _np(step(jnd.array(d["rx"]), jnd.array(d["ry"])))
    want["rg"] = trained(step)
    step = trainstep("bn", 2, {"learning_rate": 0.0},
                     loss_fn=lambda o, l: jnd.sum(o * 0.0))
    step(jnd.array(d["bn"]), jnd.array(np.zeros(R.PL_B, np.float32)))
    want["bn"] = trained(step)
    infer = jparallel.InferStep(_jax_net("conv", d, init["conv"]), _mesh(2))
    want["inf"] = _np(infer(jnd.array(d["xs"][0])))
    want["inf_multi"] = _np(infer.multi_call(jnd.array(d["xs"])))
    want["inf_ragged"] = _np(infer(jnd.array(d["rx"])))
    net = _jax_net("conv", d, init["conv"])
    tr = jgluon.Trainer(net.collect_params(), "sgd", dict(R.PL_SGD))
    plane = jtrainplane.TrainPlane(net, ce, tr, mesh=_mesh(2))
    for k in range(2):
        want["tp_loss%d" % k] = _np(plane.step(jnd.array(d["xs"][k]),
                                               jnd.array(d["ys"][k])))
    want["tp_loss_ragged"] = _np(plane.step(jnd.array(d["rx"]),
                                            jnd.array(d["ry"])))
    want["tp"] = _arrays(net)
    want["tp_plane"] = plane.plane
    step = trainstep("axis1", 2, R.PL_SGD, loss_fn=ce1, batch_axis=1)
    want["ax_ts_loss"] = np.asarray([_np(step(
        jnd.array(d["tx"][k]), jnd.array(d["ty"][k]))) for k in range(2)])
    want["ax_ts"] = trained(step)
    net = _jax_net("axis1", d, init["axis1"])
    want["ax_inf"] = _np(jparallel.InferStep(net, _mesh(2), batch_axis=1)(
        jnd.array(d["tx"][0])))
    tr = jgluon.Trainer(net.collect_params(), "sgd", dict(R.PL_SGD))
    plane = jtrainplane.TrainPlane(net, ce1, tr, mesh=_mesh(2),
                                   batch_axis=1)
    want["ax_tp_loss"] = _np(plane.step(jnd.array(d["tx"][0]),
                                        jnd.array(d["ty"][0])))
    want["ax_tp"] = _arrays(net)
    net = _jax_net("conv", d, init["conv"])
    tr = jgluon.Trainer(net.collect_params(), "sgd", dict(R.PL_MOM))
    xs, ys = d["xs"].reshape((-1,) + d["xs"].shape[2:]), d["ys"].reshape(-1)
    with jmx.cpu():
        jtrainplane.fit(net, ce, tr, jmx.io.NDArrayIter(xs, ys, R.PL_B),
                        epochs=2, mesh=_mesh(2))
    want["fit"] = _arrays(net)
    zxs, zys = R.zero_data()
    for opt_name, params in R.PL_ZERO:
        for lv in (1, 2):
            net = _zero_mlp(init["zmlp"])
            tr = jgluon.Trainer(net.collect_params(), opt_name, dict(params))
            plane = jtrainplane.TrainPlane(net, ce, tr, mesh=_mesh(2))
            os.environ["MXNET_ZERO"] = str(lv)
            try:
                want["zp_loss", opt_name, lv] = np.asarray([_np(plane.step(
                    jnd.array(zxs[k * R.ZERO_B:(k + 1) * R.ZERO_B]),
                    jnd.array(zys[k * R.ZERO_B:(k + 1) * R.ZERO_B])))
                    for k in range(R.ZERO_STEPS)])
            finally:
                os.environ.pop("MXNET_ZERO")
            want["zp", opt_name, lv] = _arrays(net)
            upd = tr._updaters[0]
            want["zp_sharded", opt_name, lv] = jzero.plane_of(upd) is not None
            jzero.materialize_updater(upd)
            want["zp_states", opt_name, lv] = {
                i: [np.asarray(jnp.asarray(leaf, jnp.float32)) for leaf in
                    jax.tree_util.tree_leaves(st)]
                for i, st in upd.states.items()}
    ws, xs = R.pipeline_data(2)
    stage = lambda w, x: jnp.tanh(x @ w)  # noqa: E731
    want["pp"] = np.asarray(jparallel.pipeline_apply(
        stage, jnp.asarray(ws), jnp.asarray(xs), _mesh_pp(2)))
    want["pp_one"] = np.asarray(jparallel.pipeline_apply(
        stage, jnp.asarray(ws), jnp.asarray(xs[:1]), _mesh_pp(2)))
    try:
        jparallel.pipeline_apply(stage, jnp.asarray(ws[:1]),
                                 jnp.asarray(xs), _mesh_pp(2))
        want["pp_refuse"] = ""
    except Exception as e:  # noqa: BLE001 - the message is the result
        want["pp_refuse"] = str(e)
    for r in range(2):
        xs, ys = R.module_data(r)
        with jmx.cpu():
            it = jmx.io.NDArrayIter(xs, ys, R.MOD_B)
            mod = jmx.module.Module(R.module_symbol(jmx), context=jmx.cpu())
            mod.fit(it, optimizer="sgd", optimizer_params=dict(R.PL_MOM),
                    arg_params={k: jnd.array(v)
                                for k, v in _module_init().items()},
                    num_epoch=2)
            args, _aux = mod.get_params()
        want["mod", r] = {k: _np(v) for k, v in args.items()}
    return want


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_planes")
    d = R.planes_data()
    init, npz = {}, {}
    for kind in KINDS:
        net = _jax_net(kind, d)
        init[kind] = _arrays(net)
        for name, a in zip(net.collect_params().keys(), init[kind]):
            npz["%s/%s" % (kind, name)] = a
    npz.update({"mod/" + k: v for k, v in _module_init().items()})
    # seeded: a cross-package comparison must see the same inputs every
    # run (Adam scales the two packages' float32 rounding of a nearly
    # cancelling gradient up to its learning rate on some draws)
    jmx.random.seed(0)
    init["zmlp"] = _arrays(_zero_mlp())
    npz.update({"zmlp/%d" % i: a for i, a in enumerate(init["zmlp"])})
    np.savez(base / "init.npz", **npz)
    got = {}

    def run():
        got["ranks"] = run_cases(2, ["planes=%s" % (base / "init.npz"),
                                     "pipeline"], base / "out")

    worker = threading.Thread(target=run)
    worker.start()
    try:
        want = _jax_side(d, init)
    finally:
        worker.join()
    return got["ranks"], want


def _params(rank, key):
    return [rank[k] for k in sorted((k for k in rank if k.startswith(
        key + "_") and k[len(key) + 1:].isdigit()),
        key=lambda k: int(k[len(key) + 1:]))]


def _same_on_ranks(ranks, key):
    for a, b in zip(_params(ranks[0], key), _params(ranks[1], key)):
        np.testing.assert_array_equal(a, b)


def _close(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg="%s %d" % (what, i), **tol)


def test_trainstep_two_ranks_equals_jax_two_and_one_device(job):
    ranks, want = job
    for r in ranks:
        assert r["world"][0] == 2 and r["backend"][0] == "gloo"
        for n in (2, 1):
            np.testing.assert_allclose(r["ts_loss"].reshape(-1),
                                       want["ts_loss", n], **LOSS_TOL)
            _close(_params(r, "ts"), want["ts", n], PARAM_TOL, "ts")
    _same_on_ranks(ranks, "ts")


def test_trainstep_runs_uncaptured_under_gloo_with_its_collectives(job):
    ranks, _ = job
    for r in ranks:
        # never captured: no capture is counted; one BatchNorm layer's
        # forward and backward sums, the gradient buffer, the loss
        assert list(r["ts_counts"]) == [0, 4]
        assert r["ts_reason"][0] == "gloo"


def test_batchnorm_statistics_span_the_ranks(job):
    ranks, want = job
    momentum = 0.9
    expect_mean = (1 - momentum) * R.planes_data()["bn"].mean(axis=0)
    for r in ranks:
        stats = _params(r, "bn")
        np.testing.assert_allclose(stats[2], expect_mean, rtol=1e-4,
                                   atol=1e-5)
        _close(stats, want["bn"], PARAM_TOL, "bn")
    _same_on_ranks(ranks, "bn")


def test_multi_call_two_ranks_equals_jax(job):
    ranks, want = job
    for r in ranks:
        np.testing.assert_allclose(r["mc_loss"], want["mc_loss"], **LOSS_TOL)
        _close(_params(r, "mc"), want["mc"], PARAM_TOL, "mc")
    _same_on_ranks(ranks, "mc")


def test_inferstep_gathers_the_global_batch(job):
    ranks, want = job
    for r in ranks:
        for key in ("inf", "inf_multi", "inf_ragged"):
            assert r[key].shape == want[key].shape, key
            np.testing.assert_allclose(r[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_trainplane_step_returns_the_whole_batch_losses(job):
    ranks, want = job
    assert want["tp_plane"] == "graph"
    for r in ranks:
        assert r["tp_state"][0] == "graph"
        assert r["tp_state"][1] == "gloo" and r["tp_state"][2] == "2"
        for key in ("tp_loss0", "tp_loss1", "tp_loss_ragged"):
            assert r[key].shape == want[key].shape, key
            np.testing.assert_allclose(r[key], want[key], err_msg=key,
                                       **LOSS_TOL)
        _close(_params(r, "tp"), want["tp"], PARAM_TOL, "tp")
        assert list(r["tp_feed_rows"]) == [R.PL_B // 2, R.PL_B]
        captures, collectives, steps, uncaptured = r["tp_counts"]
        # the last step's: the ragged batch runs whole on each rank, so
        # BatchNorm's two sums and the gradient buffer, no loss gather
        assert captures == 0 and collectives == 3 and steps == 3
        assert uncaptured == 3
    _same_on_ranks(ranks, "tp")


def test_ragged_batch_is_replicated(job):
    ranks, want = job
    for r in ranks:
        np.testing.assert_allclose(r["rg_loss"], want["rg_loss"], **LOSS_TOL)
        _close(_params(r, "rg"), want["rg"], PARAM_TOL, "rg")
    _same_on_ranks(ranks, "rg")


@pytest.mark.parametrize("executor", ["trainstep", "inferstep", "trainplane"])
def test_batch_axis_1(job, executor):
    ranks, want = job
    for r in ranks:
        if executor == "trainstep":
            np.testing.assert_allclose(r["ax_ts_loss"].reshape(-1),
                                       want["ax_ts_loss"], **LOSS_TOL)
            _close(_params(r, "ax_ts"), want["ax_ts"], PARAM_TOL, "ax_ts")
        elif executor == "inferstep":
            assert r["ax_inf"].shape == want["ax_inf"].shape == (3, R.PL_B, 3)
            np.testing.assert_allclose(r["ax_inf"], want["ax_inf"],
                                       rtol=1e-5, atol=1e-6)
        else:
            assert r["ax_tp_loss"].shape == want["ax_tp_loss"].shape
            np.testing.assert_allclose(r["ax_tp_loss"], want["ax_tp_loss"],
                                       **LOSS_TOL)
            _close(_params(r, "ax_tp"), want["ax_tp"], PARAM_TOL, "ax_tp")
    if executor != "inferstep":
        _same_on_ranks(ranks, "ax_ts" if executor == "trainstep" else "ax_tp")


def test_module_plane_trains_each_rank_alone(job):
    ranks, want = job
    for rank, r in enumerate(ranks):
        # 2 epochs of MOD_N / MOD_B batches, each one graph step
        assert r["mod_steps"][0] == 2 * R.MOD_N // R.MOD_B
        for name, w in want["mod", rank].items():
            np.testing.assert_allclose(r["mod_" + name], w, err_msg=name,
                                       **PARAM_TOL)
    assert not np.array_equal(ranks[0]["mod_fc1_weight"],
                              ranks[1]["mod_fc1_weight"])


def test_eager_dist_sync_trainer_keeps_rank_statistics(job):
    ranks, _ = job
    bn = R.planes_data()["bn"]
    for rank, r in enumerate(ranks):
        shard = bn[rank * R.PL_B // 2:(rank + 1) * R.PL_B // 2]
        stats = _params(r, "eager_bn")
        np.testing.assert_allclose(stats[2], 0.1 * shard.mean(axis=0),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stats[3], 0.9 + 0.1 * shard.var(axis=0),
                                   rtol=1e-5, atol=1e-6)
    assert not np.allclose(_params(ranks[0], "eager_bn")[2],
                           _params(ranks[1], "eager_bn")[2])


def test_plane_across_ranks_refuses_zero_and_a_partial_mesh(job):
    """``MXNET_ZERO`` across the ranks no longer raises (the sharded
    step runs: see the tests below); a mesh leaving ranks out still
    does."""
    ranks, _ = job
    for r in ranks:
        assert r["refuse_zero"][0] == ""
        assert "a batch of 5 rows" in r["refuse_mesh"][0]
        assert "2 ranks" in r["refuse_mesh"][0]


@pytest.mark.parametrize("opt_name", [o for o, _ in R.PL_ZERO])
@pytest.mark.parametrize("lv", [1, 2])
def test_zero_plane_across_ranks_equals_jax(job, opt_name, lv):
    """The plane's sharded step on 2 ranks against the JAX plane's on 2
    devices on ``tests/test_zero.py``'s MLP and batches: the loss vectors,
    the weights and (materialized) every state after its 5 steps; between
    steps the states stayed sharded, each
    rank holding half of every bucket."""
    ranks, want = job
    key = "zp_%s%d" % (opt_name, lv)
    assert want["zp_sharded", opt_name, lv]
    for r in ranks:
        # the port's sharded step is its replicated step, bit for bit
        rep = "zp_%s0" % opt_name
        for k in r:
            if k.startswith(rep + "_"):
                np.testing.assert_array_equal(r[key + k[len(rep):]], r[k],
                                              err_msg=k)
        np.testing.assert_allclose(r[key + "_loss"],
                                   want["zp_loss", opt_name, lv], **ZERO_TOL)
        _close(_params(r, key), want["zp", opt_name, lv], ZERO_TOL, key)
        for i, leaves in want["zp_states", opt_name, lv].items():
            for j, leaf in enumerate(leaves):
                np.testing.assert_allclose(r["%s_s%d_%d" % (key, i, j)], leaf,
                                           err_msg="%s state %d.%d"
                                           % (key, i, j), **ZERO_TOL)
        sharded, halves, captures, coll, fallbacks, buckets, level = \
            r[key + "_state"]
        assert sharded and halves and level == lv
        # uncaptured under gloo; a step: a reduce-scatter and an
        # all-gather a bucket, the loss gather
        assert captures == 0 and coll == 2 * buckets + 1
        assert fallbacks == 0
    _same_on_ranks(ranks, key)


def test_pipeline_apply_two_ranks_equals_jax(job):
    ranks, want = job
    for r in ranks:
        for key in ("pp", "pp_one"):
            assert r[key].shape == want[key].shape, key
            np.testing.assert_allclose(r[key], want[key], err_msg=key,
                                       **PP_TOL)
        assert r["pp_refuse"][0] == want["pp_refuse"]
    np.testing.assert_array_equal(ranks[0]["pp"], ranks[1]["pp"])


def test_plane_across_ranks_raises_where_one_process_would_demote(job):
    ranks, _ = job
    for r in ranks:
        # the failure itself, on every rank, and no eager plane after it
        assert r["refuse_capture"][0] == "planted first-pass failure"
        assert r["refuse_capture"][1] != "eager"
        assert "no eager fallback" in r["refuse_eager"][0]
        assert "MXNET_FASTPATH=0" in r["refuse_eager"][0]


def test_fit_across_ranks_resumes_from_its_checkpoint(job):
    ranks, want = job
    for r in ranks:
        # the resumed call trained the second epoch only: 3 global batches
        assert list(r["fit_state"]) == [1, R.PL_K, 2]
        assert r["fit_plane"][0] == "graph"
        _close(_params(r, "fit"), want["fit"], PARAM_TOL, "fit")
    _same_on_ranks(ranks, "fit")
