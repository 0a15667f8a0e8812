"""``fastpath.zero`` of the port (the optimizer states sharded over the
job's ranks) against the JAX package's ``fastpath.zero`` and against the
port's own replicated step.

One 2-rank job (gloo on the CPU, ``tests/torch_dist_ranks.py``'s
``zero_*`` cases) runs everything that needs ranks. ``tests/test_zero.py``'s
MLP trains through a ``dist_sync`` Trainer on every rank with the batch
the JAX process sees, stepping with ``2 B`` (B a power of two), so the
reduced gradient is the single process's exactly. Tolerances:

* the port's sharded run against its own ``MXNET_ZERO=0`` run: bit for
  bit (weights and materialized states), as ``tests/test_zero.py:142-186``
  asserts inside the JAX package;
* the port against the JAX package's 2-device ZeRO run (the conftest's
  virtual CPU devices, ``MXNET_ZERO_DEVICES=2``): float32 ``atol = rtol =
  2e-5``; bfloat16 weights within one bfloat16 step (``rtol = 2**-7``),
  their float32 masters and states at the float32 bound;
* fallback counts, flags and byte counts: exact.
"""
import os
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon, nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.fastpath import fused as jfused, zero as jzero
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, gluon as tgluon, nd as tnd
from mxnet_tpu_torch import optimizer as topt, trainplane as ttrainplane
from mxnet_tpu_torch.fastpath import bucketing as tbucketing
from mxnet_tpu_torch.fastpath import fused as tfused, zero as tzero
from mxnet_tpu_torch.gluon import nn as tnn

import torch_dist_ranks as R
from torch_dist_harness import run_cases

F32 = dict(rtol=2e-5, atol=2e-5)
BF16_STEP = dict(rtol=2.0 ** -7, atol=0)
LEVELS = (1, 2)


@contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_mlp(prefix):
    xs, _ = R.zero_data()
    net = jnn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(jnn.Dense(16, activation="relu"))
        net.add(jnn.Dense(8))
    net.initialize()
    with jmx.autograd.pause():
        net(jnd.array(xs[:R.ZERO_B]))
    return net


def _jax_leaves(state):
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in jax.tree_util.tree_leaves(state)]


def _jax_runs(init):
    """The JAX package's 2-device ZeRO runs of the MLP (``tests/
    test_zero.py:_train``) from ``init``: weights and materialized states
    by index, a run a (optimizer, level)."""
    xs, ys = R.zero_data()
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for opt, params in R.ZERO_OPTS:
        for lv in LEVELS:
            with _env(MXNET_ZERO=lv, MXNET_ZERO_DEVICES=2):
                net = _jax_mlp("jz%s%d_" % (opt, lv))
                for (_n, p), (_m, v) in zip(
                        sorted(net.collect_params().items()),
                        sorted(init.items())):
                    p.set_data(jnd.array(v))
                net.hybridize()
                tr = jgluon.Trainer(net.collect_params(), opt, dict(params))
                for s in range(R.ZERO_STEPS):
                    rows = slice(s * R.ZERO_B, (s + 1) * R.ZERO_B)
                    with jmx.autograd.record():
                        loss = loss_fn(net(jnd.array(xs[rows])),
                                       jnd.array(ys[rows]))
                    loss.backward()
                    tr.step(R.ZERO_B)
                upd = tr._updaters[0]
                assert jzero.plane_of(upd).dp == 2
                jzero.materialize_updater(upd)
            runs[(opt, lv)] = (
                [np.asarray(p.data()._data) for p in tr._params],
                {i: _jax_leaves(st) for i, st in upd.states.items()})
    return runs


def _jax_bf16_runs():
    """``tests/test_zero.py:189``'s bf16 runs (float32 masters) at each
    level over 2 devices: weights as float32 and materialized states."""
    ws, gs = R.zero_tensors(1)
    runs = {}
    for opt, kwargs in R.ZERO_MP_OPTS:
        for lv in LEVELS:
            with _env(MXNET_ZERO=lv, MXNET_ZERO_DEVICES=2):
                u = jopt.get_updater(jopt.create(opt, **kwargs))
                wl = [JNDArray(jnp.asarray(w, jnp.bfloat16), jmx.cpu())
                      for w in ws]
                gl = [JNDArray(jnp.asarray(g, jnp.bfloat16), jmx.cpu())
                      for g in gs]
                for _ in range(R.ZERO_STEPS):
                    jfused.apply_updater(u, list(zip(range(len(ws)), gl,
                                                     wl)))
                jzero.materialize_updater(u)
            runs[(opt, lv)] = (
                [np.asarray(w._data.astype(jnp.float32)) for w in wl],
                {i: _jax_leaves(st) for i, st in u.states.items()})
    return runs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    base = tmp_path_factory.mktemp("zero")
    init_net = _jax_mlp("jzinit_")
    init = {n: np.asarray(p.data()._data)
            for n, p in init_net.collect_params().items()}
    np.savez(base / "init.npz", **init)
    ranks = run_cases(2, ["zero_mlp=%s" % (base / "init.npz"), "zero_bf16",
                          "zero_misc", "zero_solo"], base / "out")
    return ranks, init


@pytest.fixture(scope="module")
def jax_runs(job):
    return _jax_runs(job[1])


@pytest.fixture(scope="module")
def jax_bf16():
    return _jax_bf16_runs()


def _states(rank, key):
    out = {}
    for k, v in rank.items():
        if k.startswith(key + "_s"):
            i, j = (int(x) for x in k[len(key) + 2:].split("_"))
            out.setdefault(i, {})[j] = v
    return {i: [d[j] for j in sorted(d)] for i, d in out.items()}


def _weights(rank, key):
    n = sum(1 for k in rank if k.startswith(key + "_w"))
    return [rank["%s_w%d" % (key, i)] for i in range(n)]


@pytest.mark.parametrize("opt", [o for o, _ in R.ZERO_OPTS])
@pytest.mark.parametrize("level", LEVELS)
def test_sharded_step_equals_replicated_bit_for_bit(job, opt, level):
    ranks, _ = job
    for got in ranks:
        key, ref = "zm_%s%d" % (opt, level), "zm_%s0" % opt
        for a, b in zip(_weights(got, key), _weights(got, ref)):
            np.testing.assert_array_equal(a, b)
        sa, sb = _states(got, key), _states(got, ref)
        assert sorted(sa) == sorted(sb) and sa
        for i in sa:
            for a, b in zip(sa[i], sb[i]):
                np.testing.assert_array_equal(a, b, err_msg=str(i))
        # no fallback; one materialization, the test's own
        assert got[key + "_counts"].tolist() == [0, 1]
    for k in ranks[0]:
        if k.startswith("zm_") and not k.endswith("_bytes"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


@pytest.mark.parametrize("opt", [o for o, _ in R.ZERO_OPTS])
@pytest.mark.parametrize("level", LEVELS)
def test_sharded_step_matches_jax_zero(job, jax_runs, opt, level):
    ranks, _ = job
    want_w, want_s = jax_runs[(opt, level)]
    key = "zm_%s%d" % (opt, level)
    got_w, got_s = _weights(ranks[0], key), _states(ranks[0], key)
    assert len(got_w) == len(want_w)
    for a, b in zip(got_w, want_w):
        np.testing.assert_allclose(a, b, **F32)
    assert sorted(got_s) == sorted(want_s)
    for i in want_s:
        for a, b in zip(got_s[i], want_s[i]):
            np.testing.assert_allclose(a, b, err_msg=str(i), **F32)


@pytest.mark.parametrize("opt", [o for o, _ in R.ZERO_MP_OPTS])
@pytest.mark.parametrize("level", LEVELS)
def test_bf16_masters_sharded_bit_for_bit_and_against_jax(job, jax_bf16, opt,
                                                         level):
    ranks, _ = job
    jax_w, jax_s = jax_bf16[(opt, level)]
    for got in ranks:
        key, ref = "zb_%s%d" % (opt, level), "zb_%s0" % opt
        for a, b in zip(_weights(got, key), _weights(got, ref)):
            np.testing.assert_array_equal(a, b)
        sa, sb = _states(got, key), _states(got, ref)
        for i in sb:
            for a, b in zip(sa[i], sb[i]):
                np.testing.assert_array_equal(a, b)
        held, padded = got[key + "_master_len"].tolist()
        # level 2 shards the float32 master; level 1 keeps it whole
        assert held == (padded // 2 if level == 2 else padded)
    for a, b in zip(_weights(ranks[0], "zb_%s%d" % (opt, level)), jax_w):
        np.testing.assert_allclose(a, b, **BF16_STEP)
    got_s = _states(ranks[0], "zb_%s%d" % (opt, level))
    for i in jax_s:
        for a, b in zip(got_s[i], jax_s[i]):
            np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("i", range(len(R.ZERO_INELIGIBLE)))
def test_ineligible_optimizers_fall_back_with_the_jax_reason(job, i):
    opt, kwargs, reason = R.ZERO_INELIGIBLE[i]
    ranks, _ = job
    for got in ranks:
        assert got["zx_inel%d" % i].tolist() == [1, 1, 1]
    # the same optimizer, the same reason in the JAX gate
    assert jzero.eligible_reason(jopt.create(opt, **kwargs), 2) == reason
    assert tzero.eligible_reason(topt.create(opt, **kwargs), 2) == reason


def test_update_on_kvstore_and_one_rank_knob_fall_back(job):
    ranks, _ = job
    for got in ranks:
        assert got["zx_optout"].tolist() == [1, 1, 1]
        assert got["zx_devices1"].tolist() == [1, 1]


def test_knob_turned_off_mid_run_stays_bit_for_bit(job):
    ranks, _ = job
    for got in ranks:
        assert got["zx_flip_z_planes"].tolist() == [1, 1, 1, 0, 0]
        assert got["zx_flip_r_planes"].tolist() == [0] * 5
        for a, b in zip(_weights(got, "zx_flip_z"),
                        _weights(got, "zx_flip_r")):
            np.testing.assert_array_equal(a, b)
        sz, sr = _states(got, "zx_flip_z"), _states(got, "zx_flip_r")
        for i in sr:
            for a, b in zip(sz[i], sr[i]):
                np.testing.assert_array_equal(a, b)


def test_eager_per_parameter_update_materializes_then_readopts(job):
    ranks, _ = job
    for got in ranks:
        assert got["zx_interleave"].tolist() == [1, 1, 1]


def test_state_bytes_a_rank_are_one_over_n(job):
    ranks, _ = job
    total = sum(int(np.prod(s)) for s in R.ZERO_SHAPES)
    for got in ranks:
        sharded, full = got["zx_bytes"].tolist()
        assert full == 2 * total * 4  # Adam: m and v, float32
        # one bucket, padded to a multiple of 2
        assert sharded == 2 * (-(-total // 2)) * 4
    for got in ranks:  # the MLP's states, level 1 against replicated
        for opt, _p in R.ZERO_OPTS:
            rep = int(got["zm_%s0_bytes" % opt][0])
            assert int(got["zm_%s1_bytes" % opt][0]) <= rep // 2 + 64


def test_materialize_on_one_rank_alone_raises_within_its_bound(job):
    ranks, _ = job
    got = ranks[0]
    assert 1.5 <= float(got["zs_seconds"][0]) < 60
    msg = str(got["zs_raised"][0])
    assert "materialize_updater" in msg and "every rank" in msg
    assert got["zs_attached"].tolist() == [1]  # nothing was lost


# -- one process --------------------------------------------------------------


def _port_triples(seed=0):
    ws, gs = R.zero_tensors(seed)
    return list(zip(range(len(ws)), [torch.tensor(g) for g in gs],
                    [torch.tensor(w) for w in ws]))


def test_one_rank_falls_back_with_the_one_device_reason(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO", "1")
    reason = "1-device mesh (sharding is a no-op)"
    before = tzero.FALLBACKS.value(reason=reason)
    u = topt.get_updater(topt.create("sgd", momentum=0.9))
    tfused.apply_updater(u, _port_triples())
    assert tzero.plane_of(u) is None
    assert tzero.FALLBACKS.value(reason=reason) == before + 1
    assert tzero.eligible_reason(topt.create("sgd"), 1) == \
        jzero.eligible_reason(jopt.create("sgd"), 1) == reason


def test_train_plane_on_one_rank_declines_counted_and_trains(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO", "1")
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    reason = "1-device mesh (sharding is a no-op)"
    xs, ys = R.zero_data()
    with tmx.cpu():
        net = tnn.HybridSequential(prefix="zp_")
        with net.name_scope():
            net.add(tnn.Dense(16, activation="relu"), tnn.Dense(8))
        net.initialize()
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
        plane = ttrainplane.TrainPlane(
            net, tgluon.loss.SoftmaxCrossEntropyLoss(), tr)
        before = tzero.FALLBACKS.value(reason=reason)
        for s in range(2):
            rows = slice(s * R.ZERO_B, (s + 1) * R.ZERO_B)
            loss = plane.step(tnd.array(xs[rows]), tnd.array(ys[rows]))
    assert plane.plane == "graph"
    assert np.isfinite(loss.asnumpy()).all()
    assert tzero.FALLBACKS.value(reason=reason) == before + 2


def test_zero_devices_between_one_and_the_world_raises(monkeypatch):
    monkeypatch.setattr(tzero._dist, "world_size", lambda: 4)
    monkeypatch.setenv("MXNET_ZERO_DEVICES", "2")
    with pytest.raises(MXNetError, match="MXNET_ZERO_DEVICES=2"):
        tzero._ndev()
    for cap, ndev in (("0", 4), ("1", 1), ("4", 4), ("8", 4)):
        monkeypatch.setenv("MXNET_ZERO_DEVICES", cap)
        assert tzero._ndev() == ndev


class _Group(object):
    """A stand-in for ``_dist.Group`` (layout only, no collective)."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_segments_tile_each_bucket_once_over_the_ranks(world):
    ws = [torch.zeros(s) for s in R.ZERO_SHAPES] + \
        [torch.zeros(3, dtype=torch.bfloat16)]
    opt = topt.create("adam")
    states = [opt.create_state(i, w) for i, w in enumerate(ws)]
    covered = {}
    for rank in range(world):
        plane = tzero.ZeroPlane(opt, _Group(rank, world), 1,
                                range(len(ws)), ws, states,
                                [False] * len(ws))
        assert len(plane.plan.buckets) == 2  # by dtype
        for b, segs in enumerate(plane._segments):
            s = plane.shard_len(b)
            used = 0
            for pos, lo, hi, off, boff in segs:
                assert off == used and 0 <= lo < hi
                used += hi - lo
                for e in range(lo, hi):
                    covered[(pos, e)] = covered.get((pos, e), 0) + 1
                assert boff + lo == rank * s + off
            assert used <= s
    assert covered == {(p, e): 1 for p, w in enumerate(ws)
                       for e in range(w.numel())}


@pytest.mark.parametrize("pad_to", [1, 2, 3, 8])
def test_flat_plan_matches_jax_layout(pad_to):
    ws, _ = R.zero_tensors(0)
    keys = ["f32"] * len(ws)
    tplan = tbucketing.flat_plan([torch.tensor(w) for w in ws], keys,
                                 pad_to=pad_to)
    from mxnet_tpu.fastpath import bucketing as jbucketing

    jplan = jbucketing.flat_plan([jnp.asarray(w) for w in ws], keys,
                                 pad_to=pad_to)
    assert tplan.buckets == jplan.buckets
    assert tplan.bucket_layout(0) == jplan.bucket_layout(0)
