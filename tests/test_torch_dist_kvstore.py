"""``KVStoreTPU``, ``init_distributed`` and a ``dist_sync`` Trainer across
ranks (CPU, gloo), against the JAX package on the same inputs.

The ranks of a 2-rank job (``tests/torch_dist_ranks.py``) each push two
copies a key; the JAX ``tpu`` store is fed all four copies, one a
virtual device (``tests/test_kvstore.py:56``). The inputs are integer
valued, so the sums are exact in any order, and the bucketed exchange
(``MXNET_KVSTORE_BUCKET_MB``) equals the unbucketed one bit for bit. The
Trainer runs ``tests/test_parallel.py:326``'s script for 3 steps: 2 ranks,
half the batch each, against the JAX package's 2 devices, from the JAX
package's initial weights, within fp32 2e-5, with ``update_on_kvstore``
both ways. Both are held against the JAX run without it: the JAX
package's Trainer with ``update_on_kvstore=True`` over two contexts
fails in its forward (the store's pull leaves one context's weight on
the other device), and for plain SGD the store's update is the same
arithmetic as the Trainer's.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon, nd as jnd
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, kvstore as tkvstore
from mxnet_tpu_torch import nd as tnd

import torch_dist_ranks as R
from torch_dist_harness import run_cases

NAMES = ("tpu", "dist", "dist_sync", "dist_async", "dist_device_sync",
         "dist_sync_device")


def _jax_trainer(ctx_list, update_on_kvstore, steps=3):
    """``tests/test_parallel.py``'s ``_train_trainer``: returns the initial
    and the trained parameters."""
    from mxnet_tpu.gluon.utils import split_and_load

    xs, ys = R.trainer_data()
    net = jnn.HybridSequential(prefix="tt_")
    with net.name_scope():
        net.add(jnn.Dense(8, activation="relu"))
        net.add(jnn.Dense(1))
    net.initialize(jmx.initializer.Xavier(rnd_type="uniform"), ctx=ctx_list)
    jmx.random.seed(99)
    with jmx.autograd.pause():
        net(jnd.array(xs).as_in_context(ctx_list[0]))
    init = {n: np.asarray(p.data(ctx_list[0])._data)
            for n, p in net.collect_params().items()}
    trainer = jgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.05}, kvstore="tpu",
                             update_on_kvstore=update_on_kvstore)
    loss_fn = jgluon.loss.L2Loss()
    for _ in range(steps):
        data = split_and_load(jnd.array(xs), ctx_list)
        label = split_and_load(jnd.array(ys), ctx_list)
        with jmx.autograd.record():
            losses = [loss_fn(net(x), y) for x, y in zip(data, label)]
        for l in losses:
            l.backward()
        trainer.step(16)
    return init, {n: np.asarray(p.data(ctx_list[0])._data)
                  for n, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_kvstore")
    init, trained = _jax_trainer([jmx.cpu(0), jmx.cpu(1)], False)
    np.savez(base / "init.npz", **init)
    ranks = run_cases(2, ["kvstore", "trainer=%s" % (base / "init.npz")],
                      base / "out")
    return ranks, trained


def _jax_store_sums(n):
    """What the JAX ``tpu`` store gives for every rank's copies pushed
    together, one a virtual device."""
    copies = R.kv_copies(n)
    keys = list(range(len(copies[0])))
    flat = [[c for rank in copies for c in rank[k]] for k in keys]
    kv = jmx.kv.create("tpu")
    for k, g in zip(keys, flat):
        kv.init(k, jnd.zeros(g[0].shape))
    devs = jax.devices()

    def put(g):
        return [jnd.NDArray(jax.device_put(c, d)) for c, d in zip(g, devs)]

    kv.push(keys[0], put(flat[0]))
    o = jnd.zeros(flat[0][0].shape)
    kv.pull(keys[0], out=o)
    push0 = o.asnumpy()
    outs = [[jnd.zeros(g[0].shape)] for g in flat]
    kv.pushpull_multi(keys, [put(g) for g in flat], outs)
    return push0, [o[0].asnumpy() for o in outs]


def test_store_push_pull_and_pushpull_multi_match_jax(job):
    ranks, _ = job
    push0, multi = _jax_store_sums(2)
    for got in ranks:
        assert got["kv_rank"].tolist()[1] == 2
        np.testing.assert_array_equal(got["kv_push_0"], push0)
        for k, want in enumerate(multi):
            np.testing.assert_array_equal(got["kv_ppm4_%d" % k], want)
            # bucketed and unbucketed, bit for bit
            np.testing.assert_array_equal(got["kv_ppm0_%d" % k],
                                          got["kv_ppm4_%d" % k])
    assert sorted(r["kv_rank"].tolist()[0] for r in ranks) == [0, 1]


@pytest.mark.parametrize("update_on_kvstore", [False, True])
def test_dist_sync_trainer_two_ranks_matches_jax_two_devices(
        job, update_on_kvstore):
    ranks, want = job
    for got in ranks:
        for name, w in want.items():
            np.testing.assert_allclose(
                got["tr%d_%s" % (int(update_on_kvstore), name)], w,
                rtol=2e-5, atol=2e-5, err_msg=name)
    # every rank holds the same weights, bit for bit
    for key in ranks[0]:
        if key.startswith("tr"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


@pytest.mark.parametrize("name", NAMES)
def test_create_accepts_every_jax_name(name):
    kv = tkvstore.create(name)
    jkv = jmx.kv.create(name)
    assert isinstance(kv, tkvstore.KVStoreTPU)
    assert kv.type == jkv.type
    assert (kv.rank, kv.num_workers) == (0, 1)
    assert kv.get_dead_nodes() == []


def test_init_distributed_without_a_launcher_is_false(monkeypatch):
    for k in ("MXNET_COORDINATOR_ADDR", "MXNET_NUM_WORKERS",
              "MXNET_WORKER_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tkvstore.init_distributed() is False


def test_one_process_tpu_store_matches_jax():
    # one process, several copies: the store sums them in list order
    rs = np.random.RandomState(3)
    copies = [rs.randn(2, 3).astype(np.float32) for _ in range(4)]
    jkv, tkv = jmx.kv.create("tpu"), tkvstore.create("tpu")
    jkv.init("w", jnd.zeros((2, 3)))
    with tmx.cpu():
        tkv.init("w", tnd.zeros((2, 3)))
        tkv.push("w", [tnd.array(c) for c in copies])
        outs = [tnd.zeros((2, 3)) for _ in range(2)]
        tkv.pull("w", out=outs)
    jkv.push("w", [jnd.array(c) for c in copies])
    o = jnd.zeros((2, 3))
    jkv.pull("w", out=o)
    for x in outs:
        np.testing.assert_allclose(x.asnumpy(), o.asnumpy(), rtol=1e-6,
                                   atol=1e-6)


def test_dist_async_applies_each_copy_as_jax_does():
    # tests/test_kvstore.py:200: with an updater each copy is a step
    n, shape = 4, (2, 3)
    grads = [np.ones(shape, np.float32) * (i + 1) for i in range(n)]
    jkv = jmx.kv.create("dist_async")
    jkv.init("w", jnd.ones(shape))
    jkv.set_optimizer(jmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    jkv.push("w", [jnd.NDArray(jax.device_put(g, d))
                   for g, d in zip(grads, jax.devices())])
    jo = jnd.zeros(shape)
    jkv.pull("w", out=jo)
    with tmx.cpu():
        tkv = tkvstore.create("dist_async")
        tkv.init("w", tnd.ones(shape))
        tkv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1,
                                            momentum=0.9))
        tkv.push("w", [tnd.array(g) for g in grads])
        to = tnd.zeros(shape)
        tkv.pull("w", out=to)
        sync = tkvstore.create("dist_sync")
        sync.init("w", tnd.ones(shape))
        sync.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1,
                                             momentum=0.9))
        sync.push("w", [tnd.array(g) for g in grads])
        so = tnd.zeros(shape)
        sync.pull("w", out=so)
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=1e-6)
    assert not np.allclose(so.asnumpy(), to.asnumpy())
    from mxnet_tpu_torch.kvstore import OPS

    assert OPS.value(op="push_async") >= 1


def test_planes_across_ranks_refuse_zero_and_a_partial_mesh(monkeypatch):
    # the planes train across ranks (tests/test_torch_dist_planes.py); on
    # a plane across ranks MXNET_ZERO >= 1 acquires the sharded plane over
    # the job's group (this rank's half of every bucket; its step in
    # tests/test_torch_dist_planes.py), and the default TrainPlane mesh
    # raises where the batch would leave ranks out (one process drives
    # one device)
    from mxnet_tpu_torch import _dist, gluon, trainplane
    from mxnet_tpu_torch.fastpath import zero

    monkeypatch.setattr(_dist, "world_size", lambda: 2)
    with pytest.raises(MXNetError, match="5 rows.*2 ranks"):
        trainplane._default_mesh(5)
    with tmx.cpu():
        net = gluon.nn.Dense(2, in_units=3)
        net.initialize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
        plane = trainplane.TrainPlane(net, gluon.loss.L2Loss(), trainer)
        plane._rows = list(enumerate(trainer._params))
        # the span a job's plane would run in: two ranks over gloo
        plane._span = _dist.Span(_dist.Group(
            None, None, 0, 2, "gloo", ["cpu", "cpu"]))
        monkeypatch.setenv("MXNET_ZERO", "1")
        zp = plane._zero_acquire(trainer._optimizer)
    assert zp is not None and zp.dp == 2 and zp.rank == 0 and zp.level == 1
    assert all(zero.is_sharded(s) for s in trainer._updater.states.values())
    # the weight (6) and the bias (2) in one bucket of 8: 4 a rank
    assert [[t.numel() for t in slots] for slots in zp.buckets] == [[4]]


def test_feed_sharding_is_the_mesh_batch_sharding():
    from mxnet_tpu_torch import gluon, parallel, trainplane

    with tmx.cpu():
        net = gluon.nn.Dense(2)
        net.initialize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        assert trainplane.TrainPlane(net, gluon.loss.L2Loss(),
                                     trainer).feed_sharding(2) is None
        mesh = parallel.device_mesh(devices=[tmx.cpu()])
        plane = trainplane.TrainPlane(net, gluon.loss.L2Loss(), trainer,
                                      mesh=mesh)
        sh = plane.feed_sharding(3)
        assert sh.is_equivalent_to(parallel.batch_sharding(mesh, 3), 3)
        x = torch.ones(4, 3)
        assert parallel.put_sharded(x, sh) is x  # laid out already
