"""``elastic`` of the port on one process: the cases of
``tests/test_elastic.py`` that apply (atomic commits, retention, async
saves, the restart loop, preemption, the stall watchdog, kill-at-step,
training-state round trips), and the checkpoint's ``.params`` bytes equal
to the JAX package's for the same parameters. Every array comparison is
exact (the values only travel through files) unless it says otherwise.
"""
import json
import os
import shutil
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import elastic as jelastic

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import elastic, telemetry
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon.loss import L2Loss
from mxnet_tpu_torch.resilience import chaos


@pytest.fixture(autouse=True)
def _cpu_and_no_preemption():
    elastic.clear_preemption()
    with mx.cpu():
        yield
    elastic.clear_preemption()


def _make_net(seed=0):
    mx.random.seed(seed)
    net = nn.HybridSequential(prefix="el_")
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.Dense(1))
    net.initialize()
    net(mx.nd.ones((2, 4)))
    return net


def _step(net, trainer):
    with mx.autograd.record():
        loss = L2Loss()(net(mx.nd.ones((4, 4))), mx.nd.ones((4, 1)))
    loss.backward()
    trainer.step(4)


def test_checkpoint_save_restore(tmp_path):
    net = _make_net(1)
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    cm = elastic.CheckpointManager(str(tmp_path), max_keep=3)
    assert cm.latest_epoch() == -1
    cm.save(0, net=net, trainer=trainer, metadata={"note": "first"})
    assert cm.latest_epoch() == 0
    want = [p.data().asnumpy() for p in net.collect_params().values()]
    net2 = _make_net(2)
    trainer2 = Trainer(net2.collect_params(), "sgd", {"learning_rate": 0.1})
    assert cm.restore(net=net2, trainer=trainer2) == 0
    for p, w in zip(net2.collect_params().values(), want):
        np.testing.assert_array_equal(p.data().asnumpy(), w)


@pytest.mark.parametrize("how", ["save", "save_training", "async"])
def test_params_file_bytes_equal_the_jax_packages(tmp_path, how):
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(4).astype(np.float32)}
    cm = elastic.CheckpointManager(str(tmp_path / "port"))
    jcm = jelastic.CheckpointManager(str(tmp_path / "jax"))
    ours = {k: mx.nd.array(v) for k, v in params.items()}
    theirs = {k: jmx.nd.array(v) for k, v in params.items()}
    if how == "save_training":
        cm.save_training(0, params=ours, save_rng=False)
        jcm.save_training(0, params=theirs, save_rng=False)
    else:
        cm.save(0, params=ours, async_save=how == "async")
        jcm.save(0, params=theirs, async_save=how == "async")
    cm.wait()
    jcm.wait()
    with open(cm._params_path(0), "rb") as f, \
            open(jcm._params_path(0), "rb") as g:
        assert f.read() == g.read()
    # the manifests name the same files
    with open(cm._manifest_path(0)) as f, open(jcm._manifest_path(0)) as g:
        assert json.load(f)["files"] == json.load(g)["files"]


def test_checkpoint_retention(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path), max_keep=2)
    for e in range(5):
        cm.save(e, params={"w": mx.nd.full((2,), float(e))})
    assert cm._epochs() == [3, 4]
    np.testing.assert_array_equal(cm.load_params()["w"].asnumpy(), [4.0, 4.0])


def test_torn_checkpoint_invisible(tmp_path):
    """A params file without its manifest is not resumable: the manifest
    is the commit point."""
    cm = elastic.CheckpointManager(str(tmp_path))
    cm.save(0, params={"w": mx.nd.ones((2,))})
    from mxnet_tpu_torch.ndarray import io_utils

    io_utils.save(cm._params_path(1), {"w": mx.nd.zeros((2,))})
    assert cm.latest_epoch() == 0
    np.testing.assert_array_equal(cm.load_params()["w"].asnumpy(), [1.0, 1.0])


def test_run_elastic_resumes(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    crashed = {"done": False}
    trained = []

    def train_fn(start_epoch, manager):
        for epoch in range(start_epoch, 6):
            if epoch == 3 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected failure")
            trained.append(epoch)
            manager.save(epoch, params={"w": mx.nd.full((1,), float(epoch))})
        return "finished"

    assert elastic.run_elastic(train_fn, cm, max_restarts=2,
                               restart_delay=0) == "finished"
    assert trained == [0, 1, 2, 3, 4, 5]
    assert cm.latest_epoch() == 5


def test_run_elastic_gives_up(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))

    def always_fail(start_epoch, manager):
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError, match="permanent"):
        elastic.run_elastic(always_fail, cm, max_restarts=2,
                            restart_delay=0)


def test_dead_nodes_single_process():
    assert elastic.get_dead_nodes() == []
    assert elastic.start_heartbeat() is False
    assert mx.kvstore.create("dist_sync").get_dead_nodes() == []


def test_manifest_metadata(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    path = cm.save(2, params={"w": mx.nd.ones((1,))},
                   metadata={"lr": 0.01, "step": 1234})
    with open(path) as f:
        manifest = json.load(f)
    assert manifest["epoch"] == 2
    assert manifest["metadata"]["step"] == 1234
    assert os.path.isfile(os.path.join(str(tmp_path),
                                       manifest["files"]["params"]))


def test_async_save_ordered_and_joined(tmp_path):
    """async_save rides the writer thread: writes stay ordered, wait()
    joins them, and the snapshot is taken at call time."""
    cm = elastic.CheckpointManager(str(tmp_path))
    w = mx.nd.full((3,), 1.0)
    cm.save(0, params={"w": w}, async_save=True)
    w[:] = 999.0  # after the snapshot
    for e in range(1, 4):
        cm.save(e, params={"w": mx.nd.full((3,), float(e))}, async_save=True)
    assert cm.latest_epoch() == 3
    np.testing.assert_array_equal(cm.load_params(0)["w"].asnumpy(), [1.0] * 3)
    np.testing.assert_array_equal(cm.load_params(3)["w"].asnumpy(), [3.0] * 3)


def test_async_save_failure_surfaces_at_wait(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path / "sub"))
    shutil.rmtree(str(tmp_path / "sub"))  # the write fails
    cm.save(0, params={"w": mx.nd.ones((2,))}, async_save=True)
    with pytest.raises(OSError):
        cm.wait()
    cm.wait()  # the failure is raised once


def test_async_save_snapshots_trainer_state(tmp_path):
    """The optimizer states are serialized at save time: a step after the
    async save does not leak into the checkpoint."""
    net = _make_net(3)
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
    _step(net, trainer)
    cm = elastic.CheckpointManager(str(tmp_path))
    cm.save(0, net=net, trainer=trainer, async_save=True)
    saved = trainer._updater.get_states()
    _step(net, trainer)  # after the save: momentum moves
    assert trainer._updater.get_states() != saved
    cm.wait()
    net2 = _make_net(4)
    t2 = Trainer(net2.collect_params(), "sgd",
                 {"learning_rate": 0.1, "momentum": 0.9})
    _step(net2, t2)  # live states, restored in place
    live = [t.data_ptr() for t in t2._updater.states.values()]
    assert cm.restore(net=net2, trainer=t2) == 0
    assert t2._updater.get_states() == saved
    assert [t.data_ptr() for t in t2._updater.states.values()] == live


def test_retention_never_retires_newest_committed(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path), max_keep=-5)
    for e in range(3):
        cm.save(e, params={"w": mx.nd.full((1,), float(e))})
    assert cm.latest_epoch() == 2
    np.testing.assert_array_equal(cm.load_params()["w"].asnumpy(), [2.0])


def test_retention_protects_newest_committed_over_quota(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path), max_keep=0)  # no GC
    for e in range(3):
        cm.save(e, params={"w": mx.nd.full((1,), float(e))})
    os.remove(cm._params_path(1))  # epochs 1 and 2 read uncommitted
    os.remove(cm._params_path(2))
    cm.max_keep = 1
    cm._retire_old()
    assert cm.latest_epoch() == 0
    np.testing.assert_array_equal(cm.load_params()["w"].asnumpy(), [0.0])


def test_latest_epoch_skips_manifest_with_missing_files(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    cm.save(0, params={"w": mx.nd.ones((2,))})
    cm.save(1, params={"w": mx.nd.zeros((2,))})
    os.remove(cm._params_path(1))
    assert cm.latest_epoch() == 0
    np.testing.assert_array_equal(cm.load_params()["w"].asnumpy(), [1.0, 1.0])


def test_restart_budget_resets_on_progress(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    calls = {"n": 0}

    def train_fn(start_epoch, manager):
        manager.save(start_epoch, params={"w": mx.nd.ones((1,))})
        calls["n"] += 1
        if calls["n"] <= 5:  # five failures against a budget of 2, each
            raise RuntimeError("preempted %d" % calls["n"])  # with progress
        return "done"

    assert elastic.run_elastic(train_fn, cm, max_restarts=2,
                               restart_delay=0) == "done"
    assert calls["n"] == 6


def test_run_elastic_still_exhausts_without_progress(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    calls = {"n": 0}

    def train_fn(start_epoch, manager):
        calls["n"] += 1
        raise RuntimeError("no progress")

    with pytest.raises(RuntimeError, match="no progress"):
        elastic.run_elastic(train_fn, cm, max_restarts=2, restart_delay=0)
    assert calls["n"] == 3


def test_step_boundary_preemption_saves_then_exits(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    saved = []
    before = telemetry.PREEMPTIONS.value()
    elastic.request_preemption()
    with pytest.raises(elastic.Preempted):
        elastic.step_boundary(manager=cm, save_fn=lambda: saved.append(True))
    assert saved == [True]
    assert telemetry.PREEMPTIONS.value() == before + 1


def test_step_boundary_preemption_save_failure_is_best_effort():
    elastic.request_preemption()

    def bad_save():
        raise RuntimeError("disk full")

    with pytest.raises(elastic.Preempted):  # not the RuntimeError
        elastic.step_boundary(save_fn=bad_save)


def test_preemption_file_polled(tmp_path, monkeypatch):
    flag = tmp_path / "evict-notice"
    monkeypatch.setenv("MXNET_PREEMPTION_FILE", str(flag))
    assert elastic.preempt_requested() is False
    flag.write_text("")
    assert elastic.preempt_requested() is True
    assert elastic.preempt_requested() is jelastic.preempt_requested()
    jelastic.clear_preemption()


def test_run_elastic_preempted_does_not_consume_restart(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    calls = {"n": 0}

    def train_fn(start_epoch, manager):
        calls["n"] += 1
        manager.save(0, params={"w": mx.nd.ones((1,))}, async_save=True)
        elastic.request_preemption()
        elastic.step_boundary(manager=manager)

    with pytest.raises(elastic.Preempted):
        elastic.run_elastic(train_fn, cm, max_restarts=3, restart_delay=0)
    assert calls["n"] == 1
    assert cm.latest_epoch() == 0  # the flush joined the async save


def test_stall_watchdog_restarts(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    wedge = threading.Event()
    attempts = []
    before = telemetry.ELASTIC_RESTARTS.value(reason="stall")

    def train_fn(start_epoch, manager):
        attempts.append(start_epoch)
        if len(attempts) == 1:
            wedge.wait(10)  # hung: no step boundary, no commit
            return "late"
        return "ok"

    try:
        out = elastic.run_elastic(train_fn, cm, max_restarts=2,
                                  restart_delay=0, stall_timeout=0.3)
    finally:
        wedge.set()
    assert out == "ok" and len(attempts) == 2
    assert telemetry.ELASTIC_RESTARTS.value(reason="stall") == before + 1


def test_chaos_action_parse_and_kill():
    with chaos.active("site=elastic.step,at=2,action=kill"):
        elastic.step_boundary()
        with pytest.raises(chaos.Killed):
            elastic.step_boundary()
        elastic.step_boundary()


def test_kill_at_step_restarts_from_committed(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    trained = []

    def train_fn(start_epoch, manager):
        for step in range(start_epoch, 5):
            elastic.step_boundary(manager=manager)
            trained.append(step)
            manager.save(step, params={"w": mx.nd.full((1,), float(step))})
        return "ok"

    with chaos.active("site=elastic.step,at=3,action=kill"):
        assert elastic.run_elastic(train_fn, cm, max_restarts=2,
                                   restart_delay=0) == "ok"
    assert trained == [0, 1, 2, 3, 4]
    assert cm.latest_epoch() == 4
    assert 0.0 < telemetry.ELASTIC_GOODPUT.value() <= 1.0


def _seq_iter(n=10, batch_size=2):
    data = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    return mx.io.NDArrayIter(data, np.arange(n, dtype=np.float32),
                             batch_size=batch_size)


def test_save_training_carries_iter_rng_and_extra(tmp_path):
    cm = elastic.CheckpointManager(str(tmp_path))
    it = _seq_iter()
    for _ in range(2):
        it.next()
    mx.random.seed(13)
    cm.save_training(0, params={"w": mx.nd.ones((1,))}, train_iter=it,
                     extra={"mid_epoch": True, "note": "x"})
    want = it.next().data[0].asnumpy()
    want_draw = mx.nd.random.uniform(shape=(4,)).asnumpy()
    it2 = _seq_iter()
    mx.random.seed(99)  # scrambled: the restore brings seed 13's back
    assert cm.restore_training(train_iter=it2) == 0
    assert cm.last_restored_extra == {"mid_epoch": True, "note": "x"}
    np.testing.assert_array_equal(it2.next().data[0].asnumpy(), want)
    np.testing.assert_array_equal(
        mx.nd.random.uniform(shape=(4,)).asnumpy(), want_draw)


def test_save_training_hashes_every_file_and_catches_a_tear(tmp_path):
    net = _make_net(5)
    trainer = Trainer(net.collect_params(), "adam", {})
    _step(net, trainer)
    cm = elastic.CheckpointManager(str(tmp_path))
    cm.save_training(0, net=net, trainer=trainer)
    _step(net, trainer)
    cm.save_training(1, net=net, trainer=trainer)
    manifest = json.load(open(cm._manifest_path(1)))
    assert sorted(manifest["hashes"]) == ["params", "states", "train"]
    with open(cm._states_path(1), "r+b") as f:  # tear epoch 1's states
        f.truncate(10)
    before = telemetry.CKPT_CORRUPTION.value()
    net2 = _make_net(6)
    t2 = Trainer(net2.collect_params(), "adam", {})
    assert cm.restore_training(net=net2, trainer=t2) == 0
    assert telemetry.CKPT_CORRUPTION.value() == before + 1
    with pytest.raises(mx.MXNetError, match="epoch 1 unusable"):
        cm.restore_training(net=net2, trainer=t2, epoch=1)
