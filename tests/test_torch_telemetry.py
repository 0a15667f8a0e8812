"""mxnet_tpu_torch.telemetry against the JAX package (CPU).

The same series fed to a fresh registry of each package render the same
Prometheus text and the same ``snapshot()``; the module-level series have
the JAX names, kinds and labels; spans feed the registry and the profiler
buffer as the JAX spans do; the JSONL emitter writes the JAX line; the
transfer accounting of ``fetch_host`` and ``asnumpy`` counts what the JAX
package counts for the same arrays; the HBM gauges stay unset on the CPU.
"""
import json
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.base import fetch_host as jfetch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import fetch_host as tfetch
from mxnet_tpu import resilience as jres


@pytest.fixture(autouse=True)
def _clean():
    for tel in (jtel, ttel):
        tel.set_enabled(True)
        tel.REGISTRY.clear_data()
    yield
    for tel, prof in ((jtel, jprofiler), (ttel, tprofiler)):
        tel.set_enabled(True)
        tel.stop_emitter()
        prof.set_state("stop")


def _feed(tel):
    """One registry of each kind of metric, fed the same series."""
    reg = tel.Registry()
    c = reg.counter("t_requests_total", "requests", labels=("server", "ev"))
    g = reg.gauge("t_depth", "queue depth", labels=("server",))
    h = reg.histogram("t_latency_ms", "latency", labels=("server",))
    plain = reg.counter("t_plain_total", "no labels")
    for i in range(40):
        c.inc(server="a", ev="ok")
        c.inc(2.5, server="b", ev='qu"ote\n')
        g.set(i % 7, server="a")
        h.observe(float((i * 37) % 101), server="a")
        h.observe(0.5 * i, server="b")
    g.inc(3, server="b")
    g.dec(1, server="b")
    plain.inc(7)
    return reg


def test_prometheus_text_matches_jax():
    assert ttel.render_prometheus(_feed(ttel)) == \
        jtel.render_prometheus(_feed(jtel))


def test_snapshot_metrics_match_jax():
    a = ttel.snapshot(_feed(ttel))
    b = jtel.snapshot(_feed(jtel))
    assert set(a) == set(b) == {"ts", "enabled", "metrics"}
    assert a["metrics"] == b["metrics"]
    json.loads(json.dumps(a))  # the emitter's line must serialize


_SERIES = ["RECOMPILES", "COMPILE_SECONDS", "STEADY_STATE_RECOMPILES",
           "TRANSFERS", "TRANSFER_BYTES", "PROFILER_COUNTER",
           "HBM_BYTES_IN_USE", "HBM_BYTES_PEAK", "STEP_DISPATCHES",
           "COMPILE_CACHE_HITS", "COMPILE_CACHE_MISSES", "CKPT_SAVE_MS",
           "CKPT_RESTORE_MS", "CKPT_BYTES", "PREEMPTIONS",
           "CKPT_CORRUPTION", "ELASTIC_GOODPUT", "ELASTIC_RESTARTS"]


@pytest.mark.parametrize("name", _SERIES)
def test_module_series_have_the_jax_name_kind_and_labels(name):
    a, b = getattr(ttel, name), getattr(jtel, name)
    assert (a.name, a.kind, tuple(a.label_names)) == \
        (b.name, b.kind, tuple(b.label_names))


def test_all_is_the_jax_all_less_what_is_not_ported():
    missing = set(jtel.__all__) - set(ttel.__all__)
    assert missing == {"jit_call", "jit_cache_size"}


def test_same_series_through_module_metrics_render_the_jax_lines():
    arrays = [np.ones((3, 4), np.float32), np.arange(5, dtype=np.int32)]
    for tel in (ttel, jtel):
        tel.record_transfer("fetch_host", arrays)
        tel.record_transfer("asnumpy", arrays[:1])
        tel.note_recompile("serving.x", 2, 0.25)
        tel.set_steady_state_recompiles("serving.x", 0)
    names = ("mxnet_host_transfers_total", "mxnet_host_transfer_bytes_total",
             "mxnet_recompiles_total", "mxnet_compile_seconds_total",
             "mxnet_steady_state_recompiles")

    def lines(tel):
        return [ln for ln in tel.render_prometheus().splitlines()
                if ln.split("{")[0].split(" ")[0] in names
                or any(ln.endswith(" " + n + " " + k) for n in names
                       for k in ("counter", "gauge"))]

    assert lines(ttel) == lines(jtel)


def test_transfer_accounting_matches_jax():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    before = [(tel.TRANSFERS.value(path=p), tel.TRANSFER_BYTES.value(path=p))
              for tel in (ttel, jtel) for p in ("fetch_host", "asnumpy")]
    with mx.cpu():
        t_nd = mx.nd.array(a)
    j_nd = jmx.nd.array(a)
    tfetch([torch.from_numpy(a), torch.from_numpy(a[:1])])
    jfetch([a, a[:1]])
    t_nd.asnumpy()
    j_nd.asnumpy()
    after = [(tel.TRANSFERS.value(path=p), tel.TRANSFER_BYTES.value(path=p))
             for tel in (ttel, jtel) for p in ("fetch_host", "asnumpy")]
    deltas = [(x1 - x0, y1 - y0) for (x0, y0), (x1, y1) in zip(before, after)]
    assert deltas[:2] == deltas[2:]
    assert deltas[0] == (1, a.nbytes + a[:1].nbytes)
    assert deltas[1] == (1, a.nbytes)


def test_asnumpy_chaos_site_retries_like_jax():
    with mx.cpu():
        x = mx.nd.array(np.ones(3, np.float32))
    with tres.chaos.active("seed=1,site=transfer.asnumpy,at=1"):
        np.testing.assert_array_equal(x.asnumpy(), np.ones(3))
    assert tres.snapshot()["retries"]["transfer.asnumpy/recovered"] >= 1


def test_hbm_sampling_is_a_no_op_on_the_cpu():
    assert ttel.sample_hbm() == {} == jtel.sample_hbm()
    assert ttel.accounting.device_memory() == {}
    assert ttel.HBM_BYTES_IN_USE.series() == []


def test_disabled_telemetry_records_nothing():
    ttel.set_enabled(False)
    ttel.record_transfer("fetch_host", [np.ones(4)])
    ttel.TRANSFERS.inc(path="x")
    assert ttel.sample_hbm() == {}
    ttel.set_enabled(True)
    assert ttel.TRANSFERS.series() == []


def test_span_feeds_registry_and_profiler_as_jax(tmp_path):
    kinds = []
    for tel, prof in ((ttel, tprofiler), (jtel, jprofiler)):
        prof.set_config(filename=str(tmp_path / "p.json"),
                        profile_symbolic=False)
        prof.set_state("run")
        with tel.span("ckpt.load", category="io"):
            time.sleep(0.001)

        @tel.traced("executor", lambda n: "forward(%s)" % n)
        def fwd(n):
            return n

        fwd("net")
        prof.set_state("stop")
        rows = {(r["labels"]["category"], r["labels"]["span"]): r["count"]
                for r in tel.spans.SPAN_MS.series()}
        evs = sorted((e["name"], e["cat"], e["ph"]) for e in prof._events)
        kinds.append((rows, evs))
        prof.set_config(profile_symbolic=True)
    assert kinds[0] == kinds[1]
    assert kinds[0][0] == {("io", "ckpt.load"): 1,
                           ("executor", "forward(net)"): 1}


def test_span_as_decorator_and_off_path():
    @ttel.span("work", category="t")
    def work(x):
        return x + 1

    assert work(1) == 2
    ttel.set_enabled(False)
    assert work(2) == 3
    ttel.set_enabled(True)
    assert [r["count"] for r in ttel.spans.SPAN_MS.series()] == [1]


def test_profiler_counter_bridges_to_the_gauge_as_jax():
    for prof, tel in ((tprofiler, ttel), (jprofiler, jtel)):
        c = prof.Domain("dom").new_counter("depth", 3)
        c.increment(4)
        c.decrement(2)
    assert ttel.PROFILER_COUNTER.series() == jtel.PROFILER_COUNTER.series()
    assert ttel.PROFILER_COUNTER.value(domain="dom", counter="depth") == 5


def test_emitter_appends_the_jax_line(tmp_path):
    ttel.TRANSFERS.inc(path="fetch_host")
    jtel.TRANSFERS.inc(path="fetch_host")
    out = []
    for tel in (ttel, jtel):
        path = tmp_path / ("%s.jsonl" % tel.__name__)
        em = tel.Emitter(0.1, str(path))
        try:
            assert em.emit_once() and em.emit_once()
        finally:
            em.stop()
        lines = path.read_text().splitlines()
        assert len(lines) == 2
        out.append(json.loads(lines[-1]))
    assert set(out[0]) == set(out[1])
    assert out[0]["metrics"]["mxnet_host_transfers_total"] == \
        out[1]["metrics"]["mxnet_host_transfers_total"]


def test_start_emitter_knob_off_by_default_then_runs(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_TELEMETRY_EMIT_SECS", raising=False)
    assert ttel.start_emitter() is None
    path = tmp_path / "e.jsonl"
    em = ttel.start_emitter(0.1, str(path))
    try:
        assert em is ttel.start_emitter(0.1, str(path))  # one a process
        deadline = time.time() + 10
        while not path.exists() and time.time() < deadline:
            time.sleep(0.05)
    finally:
        ttel.stop_emitter()
    em.join(5)
    assert not em.is_alive() and path.read_text().strip()


def test_registry_clear_data_keeps_handles_working():
    c = ttel.counter("t_keep_total", "x", labels=("k",))
    c.inc(k="a")
    ttel.REGISTRY.clear_data()
    assert c.series() == []
    c.inc(k="a")
    assert c.value(k="a") == 1


def test_resilience_snapshot_has_the_jax_keys():
    for res in (tres, jres):
        res.chaos.disable()
    assert set(tres.snapshot()) == set(jres.snapshot())
    assert tres.snapshot()["chaos"] == jres.snapshot()["chaos"] == {
        "enabled": False}
