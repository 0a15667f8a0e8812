"""Worker-failure detection and elastic resume across real processes, on
the port: the counterpart of ``tests/nightly/dist_elastic_kill.py``.

Launched as ``python -m mxnet_tpu_torch.tools.launch -n 3 -- python
tests/nightly/torch_dist_elastic_kill.py [--device cpu]``:

- every rank heartbeats through the job's store;
- rank 2 dies hard (``os._exit(0)``) after its first beats, with no clean
  shutdown, as a lost worker does (rank 0 serves the store, so it is not
  the one to die; the launcher lets a rank that exits 0 go);
- the survivors poll ``elastic.get_dead_nodes`` until rank 2's heartbeat
  goes stale (reference ``KVStoreDist::GetDeadNodes``,
  kvstore_dist.h:121), then run ``elastic.run_elastic``: the training
  function fails once (the collective dying with the worker) and must
  resume from the last committed checkpoint.

Markers: ``DYING_NOW`` (rank 2), ``DEAD_NODE_DETECTED`` and
``ELASTIC_RESUME_OK`` (every survivor). Imports the port only.
"""
import argparse
import os
import signal
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _dist, elastic, kvstore


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = parser.parse_args()
    # a hard watchdog: a hung store must fail the job, not wedge it
    signal.alarm(150)
    assert kvstore.init_distributed(), "launcher env missing"
    grp = _dist.group()
    rank, nw = grp.rank, grp.world
    assert nw == 3, "launch with -n 3"
    elastic.stop_heartbeat()
    assert elastic.start_heartbeat(interval=0.5)
    time.sleep(1.5)  # every rank publishes a few beats
    assert elastic.get_dead_nodes(timeout=30.0) == [], "all alive at start"

    if rank == 2:
        print("rank 2: DYING_NOW", flush=True)
        os._exit(0)  # hard death: no heartbeat stop, no group teardown

    # the survivors wait for rank 2's heartbeat to go stale (a live rank
    # may flicker stale on a loaded host: only rank 2's detection counts)
    deadline = time.time() + 60
    while time.time() < deadline:
        if 2 in elastic.get_dead_nodes(timeout=2.0):
            break
        time.sleep(0.5)
    else:
        raise AssertionError("rank 2 never reported dead")
    print("rank %d: DEAD_NODE_DETECTED" % rank, flush=True)

    # elastic resume on the survivor: epochs 0 and 1 committed, a crash
    # in epoch 2, the restart resumes from the committed epoch 2 onwards
    cm = elastic.CheckpointManager(
        tempfile.mkdtemp(prefix="elastic_r%d_" % rank), max_keep=2)
    crashed = {"done": False}
    resumed_from = []
    ctx = mx.current_context() if args.device == "gpu" else mx.cpu()

    def train_fn(start_epoch, mgr):
        resumed_from.append(start_epoch)
        with ctx:
            for epoch in range(start_epoch, 4):
                mgr.save(epoch, params={"w": mx.nd.array([float(epoch)])},
                         metadata={"epoch": epoch})
                if epoch == 2 and not crashed["done"]:
                    crashed["done"] = True
                    raise RuntimeError("worker lost (simulated)")
        return "finished@%d" % mgr.latest_epoch()

    result = elastic.run_elastic(train_fn, cm, max_restarts=2,
                                 restart_delay=0)
    assert result == "finished@3", result
    assert resumed_from[0] == 0 and resumed_from[1] >= 2, resumed_from
    with ctx:
        assert float(cm.load_params()["w"].asnumpy()[0]) == 3.0
    print("rank %d: ELASTIC_RESUME_OK (restarts=%r)" % (rank, resumed_from),
          flush=True)
    # rank 0 serves the store: it leaves after every survivor is done
    # with it (a barrier of the survivors through the store; the group's
    # collectives would wait for rank 2)
    _dist.store_barrier(grp.store, "elastic_kill/done", nw - 1, 60.0,
                        "the survivors' exit", rank=rank, wait_all=False)
    # no teardown with rank 2 gone: a survivor that finished hands control
    # back at once, as an elastic runner does
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
