"""``telemetry.regress`` and ``tools.benchwatch``: the bench-regression
sentinel, the port against the JAX package (CPU).

Every case of ``tests/test_regress.py`` runs through both sentinels; the
same lines and the committed ``BENCH_*.json`` give identical verdicts in
both; ``python -m mxnet_tpu_torch.tools.benchwatch`` keeps
``tools/benchwatch.py``'s arguments and exit codes (0, 9, 2); the port's
``/debug/perf`` view carries the latest verdicts.
"""
import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu.telemetry import regress as jreg

from mxnet_tpu_torch.telemetry import devprof as tdevprof
from mxnet_tpu_torch.telemetry import regress as treg
from mxnet_tpu_torch.tools import benchwatch as tbw

from conftest import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGS = {"jax": jreg, "port": treg}
BOTH = pytest.mark.parametrize("which", ["jax", "port"])


@pytest.fixture(autouse=True)
def _clean():
    for r in REGS.values():
        r.reset()
    yield
    for r in REGS.values():
        r.reset()


def _line(value, metric="decode tokens/s", unit="tok/s", extra=None,
          error=None):
    doc = {"metric": metric, "value": value, "unit": unit}
    if extra is not None:
        doc["extra"] = extra
    if error is not None:
        doc["error"] = error
    return doc


def _seed(store, values, **kw):
    for v in values:
        store.add(_line(v, **kw))


# ---------------------------------------------------------------------------
# keys, direction and the verdict math, in both sentinels
# ---------------------------------------------------------------------------

@BOTH
def test_config_signature_ignores_measurements_keeps_config(which):
    regress = REGS[which]
    a = _line(100.0, extra={"batch": 8, "infer_img_s": 52.9})
    b = _line(900.0, extra={"batch": 8, "infer_img_s": 11.1})
    assert regress.config_signature(a) == regress.config_signature(b)
    c = _line(100.0, extra={"batch": 16, "infer_img_s": 52.9})
    assert regress.config_signature(a) != regress.config_signature(c)
    assert regress.config_signature(_line(1, unit="ms")) != \
        regress.config_signature(_line(1, unit="tok/s"))


def test_signatures_and_directions_are_the_jax_ones():
    lines = [_line(1.0, extra={"batch": 8, "device_kind": "TPU v5 lite"}),
             _line(1.0, extra={"batch": 8,
                               "device_kind": "NVIDIA H100 80GB HBM3"}),
             _line(1.0, metric="decode p99 latency", unit="x"),
             _line(1.0, metric="devprof overhead", unit="frac"),
             _line(1.0, unit="seconds"), _line(1.0, unit="img/s")]
    for line in lines:
        assert treg.config_signature(line) == jreg.config_signature(line)
        assert treg.direction(line) == jreg.direction(line)
    # a card line never meets the TPU line of the same metric
    assert treg.config_signature(lines[0]) != \
        treg.config_signature(lines[1])


@BOTH
def test_direction_inference(which):
    regress = REGS[which]
    assert regress.direction(_line(1, unit="tok/s")) == "higher"
    assert regress.direction(_line(1, unit="ms")) == "lower"
    assert regress.direction(_line(1, unit="seconds")) == "lower"
    assert regress.direction(
        _line(1, metric="decode p99 latency", unit="x")) == "lower"


@BOTH
def test_insufficient_history_never_confirms(which):
    store = REGS[which].TrajectoryStore()
    v = store.verdict(_line(100.0))
    assert v["verdict"] == "no_history" and not v["confirmed"]
    _seed(store, [100.0, 101.0])
    v = store.verdict(_line(1.0))
    assert v["verdict"] == "insufficient_history" and not v["confirmed"]


@BOTH
def test_regression_beyond_noise_confirms(which):
    store = REGS[which].TrajectoryStore()
    _seed(store, [100.0, 102.0, 98.0, 101.0, 99.0])
    v = store.verdict(_line(80.0))
    assert v["verdict"] == "regression" and v["confirmed"]
    assert v["direction"] == "higher" and v["delta"] < 0
    v = store.verdict(_line(120.0))
    assert v["verdict"] == "improvement" and not v["confirmed"]


@BOTH
def test_latency_regresses_upward(which):
    store = REGS[which].TrajectoryStore()
    _seed(store, [10.0, 10.2, 9.8, 10.1], metric="decode p50", unit="ms")
    v = store.verdict(_line(14.0, metric="decode p50", unit="ms"))
    assert v["verdict"] == "regression" and v["confirmed"]
    v = store.verdict(_line(7.0, metric="decode p50", unit="ms"))
    assert v["verdict"] == "improvement"


@BOTH
def test_zero_mad_history_uses_relative_floor(which):
    store = REGS[which].TrajectoryStore()
    _seed(store, [100.0, 100.0, 100.0, 100.0])
    assert store.verdict(_line(99.0))["verdict"] == "ok"
    assert store.verdict(_line(94.0))["verdict"] == "regression"


@BOTH
def test_noise_absorption_and_knobs(which, monkeypatch):
    store = REGS[which].TrajectoryStore()
    _seed(store, [100.0, 110.0, 90.0, 105.0, 95.0])
    assert store.verdict(_line(85.0))["verdict"] == "ok"
    monkeypatch.setenv("MXNET_REGRESS_SIGMA", "1.0")
    assert store.verdict(_line(85.0))["verdict"] == "regression"
    monkeypatch.setenv("MXNET_REGRESS_MIN_HISTORY", "9")
    assert store.verdict(_line(85.0))["verdict"] == "insufficient_history"


@BOTH
def test_warmup_points_are_not_history(which):
    store = REGS[which].TrajectoryStore()
    for _ in range(5):
        store.add(_line(10.0, extra={"warmup": True}))
    key = store.key(_line(10.0, extra={"warmup": True}))
    assert store.history(key) == []
    store.add(_line(10.0), warmup=True)
    assert store.history(store.key(_line(10.0))) == []


@BOTH
def test_dead_round_is_no_value_with_error(which):
    store = REGS[which].TrajectoryStore()
    _seed(store, [100.0, 101.0, 99.0])
    v = store.verdict(_line(None, error="backend init timed out"))
    assert v["verdict"] == "no_value" and not v["confirmed"]
    assert "backend init" in v["error"]
    store.add(_line(None, error="backend init timed out"))
    assert store.history(store.key(_line(1.0))) == [100.0, 101.0, 99.0]


@BOTH
def test_history_is_bounded(which, monkeypatch):
    store = REGS[which].TrajectoryStore(max_points=4)
    _seed(store, [float(i) for i in range(10)])
    assert store.history(store.key(_line(1.0))) == [6.0, 7.0, 8.0, 9.0]
    monkeypatch.setenv("MXNET_REGRESS_MAX_POINTS", "2")
    store = REGS[which].TrajectoryStore()
    _seed(store, [1.0, 2.0, 3.0])
    assert store.history(store.key(_line(1.0))) == [2.0, 3.0]


@BOTH
def test_config_change_starts_new_trajectory(which):
    store = REGS[which].TrajectoryStore()
    _seed(store, [100.0, 101.0, 99.0], extra={"batch": 32})
    v = store.verdict(_line(10.0, extra={"batch": 4}))
    assert v["verdict"] == "no_history" and not v["confirmed"]


# ---------------------------------------------------------------------------
# ingestion and replay: identical verdicts from both
# ---------------------------------------------------------------------------

def _history_files(tmp_path):
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(_line(15.31, metric="resnet quick")))
    wrapper = tmp_path / "wrap.json"
    wrapper.write_text(json.dumps(
        {"n": 4, "rc": 1, "parsed": _line(52.63, metric="resnet train"),
         "tail": "noise"}))
    dead = tmp_path / "dead.json"
    dead.write_text(json.dumps(
        {"n": 5, "rc": 1, "parsed": None,
         "tail": "Traceback...\n" + json.dumps(_line(9.9, metric="embedded"))
         + "\nmore noise"}))
    snap = {"ts": 1.0, "enabled": True, "metrics": {
        "mxnet_device_time_ms": {"type": "histogram", "series": [
            {"labels": {"site": "serving.decode_step"},
             "p50": 1.25, "p99": 3.0, "sum": 10.0, "count": 8}]},
        "mxnet_tokens_per_device_second": {"type": "gauge", "series": [
            {"labels": {"server": "srv"}, "value": 5000.0}]}}}
    jsonl = tmp_path / "emit.jsonl"
    jsonl.write_text(json.dumps(_line(1.0, metric="a")) + "\n"
                     + "not json\n" + json.dumps(snap) + "\n"
                     + json.dumps(_line(2.0, metric="b")) + "\n")
    bad = tmp_path / "bad.json"
    bad.write_text("{truncated")
    return [str(p) for p in (raw, wrapper, dead, jsonl, bad,
                             tmp_path / "missing")]


def test_iter_bench_lines_same_points_from_every_shape(tmp_path):
    for path in _history_files(tmp_path):
        assert list(treg.iter_bench_lines(path)) == \
            list(jreg.iter_bench_lines(path))
    got = {m["metric"] for p in _history_files(tmp_path)
           for m in treg.iter_bench_lines(p)}
    assert got == {"resnet quick", "resnet train", "embedded", "a", "b",
                   "devprof p50 device ms [serving.decode_step]",
                   "devprof tokens/device-s [srv]"}


def test_default_paths_round_order(tmp_path, monkeypatch):
    for name in ("BENCH_r02.json", "BENCH_r01.json", "BENCH_CPU.json",
                 "BENCH_r10.json"):
        (tmp_path / name).write_text("{}")
    monkeypatch.delenv("MXNET_TELEMETRY_EMIT_PATH", raising=False)
    for regress in REGS.values():
        got = [os.path.basename(p)
               for p in regress.default_paths(str(tmp_path))]
        assert got == ["BENCH_CPU.json", "BENCH_r01.json", "BENCH_r02.json",
                       "BENCH_r10.json"]
    # with no root: the repository's own files, the same list
    assert treg.default_paths() == jreg.default_paths()


def _replay(regress, paths):
    store = regress.TrajectoryStore()
    out = []
    for path in paths:
        for line in regress.iter_bench_lines(path):
            out.append(store.verdict(line))
            store.add(line, source=os.path.basename(path))
    return out, store


def test_committed_history_gives_identical_verdicts():
    paths = [p for p in treg.default_paths(REPO)
             if os.path.basename(p) != "telemetry.jsonl"]
    got, tstore = _replay(treg, paths)
    want, jstore = _replay(jreg, paths)
    assert got == want and got
    assert tstore.keys() == jstore.keys()
    for v in got:
        assert not v["confirmed"], v
        assert v["verdict"] in ("no_history", "insufficient_history",
                                "no_value", "ok", "improvement"), v


def _committed_history(tmp_path, values, seed_last=None):
    paths = []
    vals = list(values) + ([seed_last] if seed_last is not None else [])
    for i, v in enumerate(vals, 1):
        p = tmp_path / ("BENCH_r%02d.json" % i)
        p.write_text(json.dumps(_line(v, extra={"batch": 8})))
        paths.append(str(p))
    return paths


def test_replay_flags_seeded_slowdown_in_both(tmp_path):
    paths = _committed_history(tmp_path, [5400.0, 5450.0, 5380.0, 5420.0],
                               seed_last=4000.0)
    got, _ = _replay(treg, paths)
    want, _ = _replay(jreg, paths)
    assert got == want
    confirmed = [v for v in got if v["confirmed"]]
    assert len(confirmed) == 1 and confirmed[0] is got[-1]


@BOTH
def test_stamp_line_verdicts_then_absorbs(which):
    regress = REGS[which]
    store = regress.TrajectoryStore()
    for v in (100.0, 101.0, 99.0):
        regress.stamp_line(_line(v), store=store)
    verdict = regress.stamp_line(_line(50.0), store=store)
    assert verdict["confirmed"] and verdict["verdict"] == "regression"
    recents = regress.recent_verdicts()
    assert len(recents) == 4 and recents[-1] is verdict
    assert 50.0 in store.history(store.key(_line(50.0)))


def test_debug_perf_carries_the_verdicts():
    store = treg.TrajectoryStore()
    verdict = treg.stamp_line(_line(10.0), store=store)
    doc = tdevprof._perf_view()
    assert "devprof" in doc and doc["perf_verdicts"] == [verdict]
    treg.reset()
    assert tdevprof._perf_view()["perf_verdicts"] == []


# ---------------------------------------------------------------------------
# benchwatch
# ---------------------------------------------------------------------------

def _run_both(*argv):
    """The JAX tool and the port's module, each as its own process."""
    jax_run = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "benchwatch.py")]
        + list(argv), capture_output=True, text=True, cwd=REPO, timeout=120)
    port_run = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.benchwatch"]
        + list(argv), capture_output=True, text=True, cwd=REPO,
        env=subprocess_env(), timeout=120)
    return jax_run, port_run


def test_benchwatch_committed_history_is_clean_in_both():
    jax_run, port_run = _run_both("--json")
    assert jax_run.returncode == port_run.returncode == 0, port_run.stderr
    assert json.loads(port_run.stdout) == json.loads(jax_run.stdout)


def test_benchwatch_exit_codes(tmp_path, capsys):
    paths = _committed_history(
        tmp_path, [5400.0, 5450.0, 5380.0, 5420.0], seed_last=4000.0)
    assert tbw.main(paths) == 9
    assert "CONFIRMED REGRESSION" in capsys.readouterr().out
    assert tbw.main(["--json"] + paths) == 9
    doc = json.loads(capsys.readouterr().out)
    assert doc["rc"] == 9 and len(doc["regressions_at_head"]) == 1
    # a regression that later recovered: the head is clean
    recovered = _committed_history(
        tmp_path / "..", [5400.0, 5450.0, 5380.0, 5420.0, 4000.0, 5410.0])
    assert tbw.main(recovered) == 0
    assert "no confirmed regressions at head" in capsys.readouterr().out
    with pytest.raises(SystemExit) as ei:
        tbw.main(["/nonexistent/history.json"])
    assert ei.value.code == 2


def test_benchwatch_line_judged_against_history(tmp_path, capsys):
    hist = _committed_history(tmp_path, [5400.0, 5450.0, 5380.0, 5420.0])
    cand = tmp_path / "candidate.json"
    cand.write_text(json.dumps(_line(4000.0, extra={"batch": 8})))
    assert tbw.main(hist + ["--line", str(cand), "--json"]) == 9
    doc = json.loads(capsys.readouterr().out)
    assert doc["verdicts"][-1]["source"] == "candidate.json"
    assert doc["verdicts"][-1]["confirmed"]
    jax_run, port_run = _run_both(*hist, "--line", str(cand), "--json")
    assert jax_run.returncode == port_run.returncode == 9
    assert json.loads(port_run.stdout) == json.loads(jax_run.stdout)
