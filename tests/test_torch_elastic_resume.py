"""Sharded checkpoints and bit-for-bit resume on the port
(``tests/test_elastic_resume.py``'s cases, over ranks).

One 2-rank job (gloo on the CPU, ``tests/torch_dist_ranks.py``'s
``elastic_zero``) at ``MXNET_ZERO=1``: a sharded save performs no
all-gather (``mxnet_zero_materializations_total`` moves by 0) and writes
one shard file a rank; its restore onto the job's 2 ranks, onto this one
process and onto a 4-rank job equals the materialized states bit for
bit, and so does the JAX package's ``states_from_export`` on the same
flat slots; the level-1 float32 masters land once in ``.repl``;
torn-write and drop-shard fall back to the previous epoch; a kill-at-step
run through the eager Trainer and an agreed preemption (the notice
reaches rank 0 only) resume bit for bit against the uninterrupted run.
On one process, ``trainplane.fit(checkpoint=)`` under ``run_elastic`` at
``MXNET_ZERO=0`` resumes bit for bit. Last, the nightly kill script on 3
ranks. Every comparison is exact.
"""
import os
import pickle
import sys

import jax
import numpy as np
import pytest

from mxnet_tpu.fastpath import zero as jzero

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import elastic, gluon, trainplane
from mxnet_tpu_torch.fastpath import zero as tzero
from mxnet_tpu_torch.optimizer import _state_leaves
from mxnet_tpu_torch.resilience import chaos

import torch_dist_ranks as R
from torch_dist_harness import REPO, launch, run_cases


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic_resume")
    ranks = run_cases(2, ["elastic_zero=%s" % base], base / "out")
    return base, ranks


def _arrays(rank, key):
    return {tuple(int(x) for x in k[len(key) + 1:].split("_")): v
            for k, v in rank.items() if k.startswith(key + "_")}


def _assert_same(got, want):
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_sharded_save_performs_no_all_gather(job):
    _, ranks = job
    for got in ranks:
        # 0 materializations, shard bytes moved, still sharded, 2 shard
        # entries, the manifest's layout
        assert got["es_save"].tolist() == [0, 1, 1, 2, 1]
        files = set(got["es_files"].tolist())
        assert {"ckpt-0000.shard0-of-2", "ckpt-0000.shard1-of-2",
                "ckpt-0000.zmeta", "ckpt-0000.params",
                "ckpt-0000.train0-of-2", "ckpt-0000.train1-of-2",
                "ckpt-0000.manifest.json"} == files


def test_restore_onto_two_ranks_equals_the_materialized_states(job):
    _, ranks = job
    for got in ranks:
        _assert_same(_arrays(got, "es_got2"), _arrays(got, "es_want"))
        assert got["es_counts2"].tolist() == got["es_counts"].tolist()
        assert got["es_params_equal"].all()


def _slots(d):
    meta = pickle.load(open(os.path.join(d, "ckpt-0000.zmeta"), "rb"))
    pieces = [pickle.load(open(os.path.join(
        d, "ckpt-0000.shard%d-of-2" % r), "rb")) for r in range(2)]
    return meta, {k: np.concatenate([p[k] for p in pieces])
                  for k in pieces[0]}


def _jax_template(t, leaf):
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(_jax_template(x, leaf) for x in t)
    leaf[0] += 1
    return leaf[0]


def test_restore_onto_one_process_and_jax_states_from_export(job):
    base, ranks = job
    want = _arrays(ranks[0], "es_want")
    d = str(base / "sharded")
    # the JAX package's rebuild of the same flat slots
    meta, slots = _slots(d)
    jmeta = dict(meta, templates=[_jax_template(t, [0])
                                  for t in meta["templates"]])
    jtrees = jzero.states_from_export(jmeta, slots)
    ttrees = tzero.states_from_export(meta, slots)
    for i, (jt, tt) in enumerate(zip(jtrees, ttrees)):
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jt)]
        tl = [x.numpy() for x in _state_leaves(tt)]
        assert len(jl) == len(tl) == 2
        for j, (a, b) in enumerate(zip(jl, tl)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, want[(i, j)])
    # the port's restore in this process (one rank)
    with tmx.cpu():
        net, tr = R.elastic_model("e1_", kvstore="device")
        cm = elastic.CheckpointManager(d)
        assert cm.restore_training(net=net, trainer=tr) == 0
        _assert_same(R.materialized(tr), want)
        assert [tr._optimizer.num_update] + [
            tr._optimizer._index_update_count[i] for i in range(4)] == \
            ranks[0]["es_counts"].tolist()


def test_restore_onto_four_ranks(job):
    base, ranks = job
    four = run_cases(4, ["elastic_restore=%s" % base], base / "out4")
    want = _arrays(ranks[0], "es_want")
    for got in four:
        _assert_same(_arrays(got, "eq_got"), want)
        assert got["eq_dp"].tolist() == [4]  # the next step shards on 4


def test_level_one_masters_replicated_round_trip(job):
    _, ranks = job
    for got in ranks:
        assert got["em_repl"].tolist() == [1]
        assert got["em_equal"].all()


@pytest.mark.parametrize("tag,latest", [("torn", 1), ("drop", 0)])
def test_torn_or_dropped_shard_falls_back_to_the_previous_epoch(job, tag,
                                                                latest):
    _, ranks = job
    for got in ranks:
        newest, restored, corrupt, equal = got["ec_%s" % tag].tolist()
        assert newest == latest  # a torn file looks committed; a lost one not
        assert restored == 0 and corrupt >= 1 and equal


@pytest.mark.parametrize("tag", ["kill", "preempt"])
def test_interrupted_run_resumes_bit_for_bit(job, tag):
    _, ranks = job
    for got in ranks:
        ref = {k[len("er_ref_"):]: v for k, v in got.items()
               if k.startswith("er_ref_")}
        run = {k[len("er_%s_" % tag):]: v for k, v in got.items()
               if k.startswith("er_%s_" % tag)}
        assert sorted(ref) == sorted(run)
        for k in ref:
            if k not in ("restarts", "preempted"):
                np.testing.assert_array_equal(run[k], ref[k], err_msg=k)
        assert ref["restarts"].tolist() == [0]
        assert run["restarts"].tolist() == [1 if tag == "kill" else 0]
    if tag == "preempt":
        # both ranks committed the same epoch and stopped together
        assert [g["er_preempt_preempted"].tolist() for g in ranks] == \
            [[1], [1]]


def _fit_run(d, prefix, kill):
    xs, ys = R.elastic_data()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    cm = elastic.CheckpointManager(str(d))
    final = {}

    def train_fn(start_epoch, manager):
        net, tr = R.elastic_model(prefix, opt=(
            "sgd", {"learning_rate": 0.1, "momentum": 0.9}),
            kvstore="device")
        it = tmx.io.NDArrayIter(xs, ys, batch_size=R.EL_B)
        plane = trainplane.fit(net, loss_fn, tr, it, epochs=3,
                               checkpoint=manager)
        final.setdefault("captures", []).append(plane.compile_count)
        final.update(net=net, tr=tr, it=it, plane=plane)
        return "ok"

    with tmx.cpu():
        if kill:
            # 3 epochs of 2 batches: the 5th boundary is epoch 1's second
            with chaos.active("site=elastic.step,at=5,action=kill"):
                assert elastic.run_elastic(train_fn, cm, max_restarts=2,
                                           restart_delay=0) == "ok"
        else:
            assert elastic.run_elastic(train_fn, cm, max_restarts=0,
                                       restart_delay=0) == "ok"
        assert cm.latest_epoch() == 2
        assert cm.restore_training() == 2
        assert cm.last_restored_extra == {"mid_epoch": False}
        states = R.materialized(final["tr"])
    return final, states


def test_fit_checkpoint_kill_resumes_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_ZERO", raising=False)
    ref, ref_states = _fit_run(tmp_path / "ref", "fa_", kill=False)
    got, got_states = _fit_run(tmp_path / "kill", "fb_", kill=True)
    assert got["plane"].plane == ref["plane"].plane == "graph"
    # one capture an attempt: the restore wrote in place
    assert ref["captures"] == [1] and got["captures"] == [1]
    for a, b in zip(got["net"].collect_params().values(),
                    ref["net"].collect_params().values()):
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())
    _assert_same(got_states, ref_states)
    assert got["it"].cursor == ref["it"].cursor
    assert got["tr"]._optimizer.num_update == ref["tr"]._optimizer.num_update
    assert got["tr"]._optimizer._index_update_count == \
        ref["tr"]._optimizer._index_update_count


def test_nightly_kill_script_on_three_ranks():
    proc = launch(3, [sys.executable, str(REPO / "tests" / "nightly" /
                                          "torch_dist_elastic_kill.py"),
                      "--device", "cpu"], timeout=180)
    out = proc.stdout
    assert proc.returncode == 0, out[-4000:] + proc.stderr[-2000:]
    assert "rank 2: DYING_NOW" in out
    for r in (0, 1):
        assert "rank %d: DEAD_NODE_DETECTED" % r in out
        assert "rank %d: ELASTIC_RESUME_OK" % r in out
