"""mxnet_tpu_torch.profiler against the JAX package's (CPU).

The same calls on both profilers give the same chrome-trace events
(names, categories, phases, counter values) and the same aggregate
table's rows; ``dump`` writes chrome://tracing JSON; ``pause``/
``resume``, a redundant ``run``, ``set_config``'s refusal of an unknown
key and ``profiled``/``timed_op`` behave as the JAX ones. With
``profile_all`` a run also records a ``torch.profiler`` session, written
beside ``filename`` as ``<filename>.torchtrace.json`` at stop (the JAX
package's ``.jaxtrace`` directory).
"""
import json
import os
import threading

import pytest

from mxnet_tpu import profiler as jprof
from mxnet_tpu.base import MXNetError as JError

from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.base import MXNetError as TError


@pytest.fixture(autouse=True)
def _reset(tmp_path):
    for prof in (jprof, tprof):
        prof.set_config(filename=str(tmp_path / ("%s.json" % prof.__name__)),
                        aggregate_stats=True, profile_symbolic=False,
                        profile_all=False)
    yield
    for prof in (jprof, tprof):
        prof.set_state("stop")
        prof.resume()
        prof._events.clear()
        prof._agg.clear()
        prof.set_config(profile_symbolic=True)


def _session(prof):
    prof.set_state("run")
    dom = prof.Domain("app")
    with dom.new_task("work"):
        pass
    frame = dom.new_frame("frame0")
    frame.start()
    frame.stop()
    counter = dom.new_counter("ctr", 5)
    counter.increment(2)
    counter.decrement(1)
    dom.new_marker("here").mark()
    with prof.Event("evt"):
        pass
    with prof.timed_op("relu"):
        pass

    @prof.profiled("executor", lambda name: "forward(%s)" % name)
    def fwd(name):
        return name

    fwd("net")
    prof.record_event("manual", "custom", 1.0, 2.0)
    prof.set_state("stop")


def test_user_objects_give_the_jax_events():
    out = []
    for prof in (tprof, jprof):
        _session(prof)
        out.append(sorted(
            (e["name"], e["cat"], e["ph"],
             json.dumps(e.get("args", {}), sort_keys=True))
            for e in prof._events))
    assert out[0] == out[1]
    cats = {c for _n, c, _p, _a in out[0]}
    assert {"task", "frame", "counter", "marker", "operator", "executor",
            "custom"} <= cats
    counters = [a for n, c, _p, a in out[0] if c == "counter"]
    assert sorted(counters) == ['{"ctr": 5}', '{"ctr": 6}', '{"ctr": 7}']


def test_aggregate_table_rows_match_jax():
    rows = []
    for prof in (tprof, jprof):
        _session(prof)
        table = prof.dumps()
        rows.append(sorted(line.split()[0] + " " + line.split()[1]
                           for line in table.splitlines()[1:]))
        assert "Calls" in table and "Avg(ms)" in table
        prof.dumps(reset=True)
        assert prof.dumps().splitlines()[1:] == []
    assert rows[0] == rows[1]


def test_dump_writes_chrome_trace(tmp_path):
    _session(tprof)
    fname = str(tmp_path / "dump.json")
    tprof.set_config(filename=fname)
    tprof.dump()
    doc = json.load(open(fname))
    assert doc["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in doc["traceEvents"]} <= {"X", "C", "i"}
    assert any(e["name"] == "app::work" for e in doc["traceEvents"])


def test_pause_resume_and_off_path():
    assert not tprof.ENABLED
    with tprof.timed_op("off"):
        pass
    assert not tprof._events
    tprof.set_state("run")
    tprof.pause()
    with tprof.timed_op("paused"):
        pass
    assert not any("paused" in k for k in tprof._agg)
    tprof.resume()
    with tprof.timed_op("live"):
        pass
    assert any("live" in k for k in tprof._agg)


def test_redundant_run_warns_and_keeps_the_session():
    tprof.set_state("run")
    with tprof.timed_op("kept"):
        pass
    with pytest.warns(UserWarning, match="no-op"):
        tprof.set_state("run")
    assert any("kept" in k for k in tprof._agg)
    tprof.set_state("stop")


def test_pause_resume_threaded_against_set_state():
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            tprof.pause()
            tprof.resume()

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            tprof.set_state("run")
            tprof.set_state("stop")
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)
    tprof.resume()
    assert tprof.ENABLED is False


def test_set_config_and_state_reject_what_jax_rejects():
    for prof, err in ((tprof, TError), (jprof, JError)):
        with pytest.raises(err):
            prof.set_config(bogus=True)
        with pytest.raises(err):
            prof.set_state("walk")
        with pytest.raises(err):
            prof.Domain("d").new_task("never").stop()
    assert tprof.profiler_set_config is tprof.set_config
    assert tprof.profiler_set_state is tprof.set_state


def test_profile_all_writes_a_torch_profiler_trace(tmp_path):
    import torch

    fname = str(tmp_path / "dev.json")
    tprof.set_config(filename=fname, profile_all=True)
    tprof.set_state("run")
    (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    tprof.set_state("stop")
    path = fname + ".torchtrace.json"
    assert os.path.exists(path)
    doc = json.load(open(path))
    assert doc["traceEvents"]
