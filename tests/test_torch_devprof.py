"""devprof: the port against the JAX package (CPU).

At sample rate 0 no probe is installed and nothing is recorded; the four
decode sites come out of the same traffic with the same reading counts
in both packages (every request queued before the first admission, the
same weights); the tick and train-step breakdowns give the same gauges
for the same device times; the summary ranks sites by device time; the
chrome device lane places each slice at its launch's host time. On the
CPU a probe times the call's wall, as the JAX package does without
``block_until_ready``; the CUDA-event reading is held on the card by
``chip_smoke.py``.
"""
import json

import jax
import numpy as np
import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.telemetry import accounting as jacc
from mxnet_tpu.telemetry import devprof as jdev
from mxnet_tpu.telemetry import flightrec as jflight
from mxnet_tpu.telemetry import tracing as jtracing

from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.telemetry import accounting as tacc
from mxnet_tpu_torch.telemetry import devprof as tdev
from mxnet_tpu_torch.telemetry import flightrec as tflight
from mxnet_tpu_torch.telemetry import tracing as ttracing

_DIMS = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
             num_kv_heads=2)
_SITES = {"serving.decode_prefill", "serving.decode_prefill_chunk",
          "serving.decode_cow", "serving.decode_step"}


@pytest.fixture(autouse=True)
def _clean():
    for dev, tel, tracing, flight in ((jdev, jtel, jtracing, jflight),
                                      (tdev, ttel, ttracing, tflight)):
        dev.set_sample(None)
        dev.reset()
        tracing.set_sample(None)
        tracing.clear()
        flight.clear()
        tel.REGISTRY.clear_data()
    yield
    for dev, tel, tracing, flight in ((jdev, jtel, jtracing, jflight),
                                      (tdev, ttel, ttracing, tflight)):
        dev.set_sample(None)
        dev.reset()
        tracing.set_sample(None)
        tracing.clear()
        flight.clear()
        tel.REGISTRY.clear_data()
        tel.set_enabled(True)


@pytest.fixture(scope="module")
def tiny():
    jm = jserving.TinyDecoder(**_DIMS)
    jp = jm.init_params(0)
    tm = tserving.TinyDecoder(**_DIMS)
    tp = tserving.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _soak(engine):
    """Shared prompts (prefill, tails, a copy on write) and fresh ones,
    all queued before the first admission."""
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 32, 12).astype(np.int32)
    prompts = [shared] * 4 + [rng.randint(1, 32, 5).astype(np.int32)
                              for _ in range(3)]
    engine.warmup()
    with engine._cv:
        futs = [engine.submit(p, 4) for p in prompts]
    outs = [np.asarray(f.result(timeout=120)) for f in futs]
    engine.close(timeout=60)
    return outs


def _engines(tiny, name):
    jm, jp, tm, tp = tiny
    kw = dict(num_slots=3, max_seq_len=48, prefill_buckets=(8, 16),
              timeout_ms=0, prefix_cache=True, prefill_chunk=0)
    return (jserving.DecodeEngine(jm, jp, name="j" + name, **kw),
            tserving.DecodeEngine(tm, tp, name="t" + name, device="cpu",
                                  **kw))


def test_sample_zero_installs_no_probe_and_records_nothing(tiny):
    assert tacc._DEVPROF_HOOK is None and not tdev.active()
    assert tdev.tick_begin() is False
    _je, te = _engines(tiny, "off")
    _soak(te)
    assert tdev.DEVICE_TIME_MS.series() == []
    assert tdev.chrome_events(1) == [] and tdev.summary()["sites"] == []
    _je.close(timeout=60)


def test_set_sample_and_env_knob_install_the_probe(monkeypatch):
    tdev.set_sample(0.5)
    assert tacc._DEVPROF_HOOK is not None and tdev.active()
    tdev.set_sample(0.0)
    assert tacc._DEVPROF_HOOK is None
    monkeypatch.setenv("MXNET_DEVPROF_SAMPLE", "1.0")
    tdev.set_sample(None)
    assert tdev.active() and tdev.sample_rate() == 1.0
    monkeypatch.delenv("MXNET_DEVPROF_SAMPLE")
    tdev.refresh()
    assert not tdev.active()


def test_four_sites_and_reading_counts_match_jax(tiny):
    je, te = _engines(tiny, "sites")
    jdev.set_sample(1.0)
    tdev.set_sample(1.0)
    j_out = _soak(je)
    t_out = _soak(te)
    for a, b in zip(j_out, t_out):
        np.testing.assert_array_equal(a, b)

    def counts(dev):
        return {r["labels"]["site"]: r["count"]
                for r in dev.DEVICE_TIME_MS.series() if r["count"]}

    assert _SITES <= set(counts(tdev))
    assert counts(tdev) == counts(jdev)
    t_planes, j_planes = (tdev.summary()["planes"],
                          jdev.summary()["planes"])
    assert t_planes["decode"]["tokens"] == j_planes["decode"]["tokens"] == \
        7 * 4
    assert 0.0 <= t_planes["decode"]["host_gap_ratio"] <= 1.0


def _tick(dev, acc, wall, tokens):
    assert dev.tick_begin()
    dev._tls.acc.update(acc)
    dev.note_decode_tick("srv", wall_ms=wall, tokens=tokens)


def test_tick_breakdown_gauges_match_jax():
    ticks = [({"serving.decode_prefill": 2.0, "serving.decode_step": 5.0},
              20.0, 4),
             ({"serving.decode_cow": 0.5, "serving.decode_step": 4.0},
              9.0, 3),
             ({"serving.decode_step": 3.0}, 6.0, 1)]
    out = []
    for dev in (tdev, jdev):
        dev.set_sample(1.0)
        for acc, wall, tokens in ticks:
            _tick(dev, acc, wall, tokens)
        out.append((dev.DECODE_TICK_MS.series(), dev.HOST_GAP_RATIO.series(),
                    dev.TOKENS_PER_DEVICE_S.series(),
                    dev.summary()["planes"]))
    assert out[0] == out[1]
    phases = {r["labels"]["phase"]: r["sum"] for r in out[0][0]}
    assert phases == {"prefill": 2.5, "step": 12.0, "host_gap": 20.5}


def test_train_step_split_and_mfu_match_jax():
    out = []
    for dev in (tdev, jdev):
        dev.set_sample(1.0)
        dev.declare_flops(1e9, 1e12)
        for ms in (4.0, 6.0):
            assert dev.tick_begin()
            dev._tls.acc["trainplane.step"] = ms
            dev.note_train_step(wall_ms=10.0)
        out.append((dev.TRAIN_STEP_MS.series(), dev.MFU.series(),
                    dev.summary()["planes"]))
    assert out[0] == out[1]
    assert out[0][2]["train"]["steps"] == 2 and out[0][2]["train"]["mfu"] > 0


def test_tick_scope_forces_and_end_drops_pending():
    tdev.set_sample(1.0)
    assert tdev.tick_begin()
    probe = tacc._DEVPROF_HOOK("serving.decode_step", None)
    probe.stop()  # pending until the scope's end
    assert tdev.DEVICE_TIME_MS.series() == []
    tdev.tick_end()
    assert tdev.tick_device_ms() == {}
    assert tdev.DEVICE_TIME_MS.series() == []
    tdev.set_sample(0.0)
    assert tdev.tick_begin() is False


def test_cpu_probe_times_the_wall_outside_a_scope():
    tdev.set_sample(1.0)
    probe = tacc._DEVPROF_HOOK("x.site", None)
    assert probe._ev0 is None  # no events on the CPU
    probe.stop()
    rows = tdev.DEVICE_TIME_MS.series()
    assert rows[0]["labels"]["site"] == "x.site" and rows[0]["count"] == 1
    assert probe.read() >= 0.0
    ttel.set_enabled(False)
    assert tacc._DEVPROF_HOOK("x.site", None) is None


def test_sampling_below_one_draws_per_dispatch(monkeypatch):
    tdev.set_sample(0.5)
    draws = iter([0.9, 0.1, 0.7, 0.2])
    monkeypatch.setattr(tdev._random, "random", lambda: next(draws))
    got = [tacc._DEVPROF_HOOK("s", None) is not None for _ in range(4)]
    assert got == [False, True, False, True]


def test_summary_ranks_sites_by_device_time():
    tdev.set_sample(1.0)
    for site, ms in (("a", 1.0), ("b", 5.0), ("c", 3.0), ("b", 1.0)):
        assert tdev.tick_begin()
        tdev._tls.pending.append(_FixedProbe(site, ms))
        tdev.tick_device_ms()
        tdev.tick_end()
    doc = tdev.summary(top_n=2)
    assert [s["site"] for s in doc["sites"]] == ["b", "c"]
    assert doc["site_count"] == 3 and doc["sites"][0]["dispatches_sampled"] \
        == 2


class _FixedProbe:
    def __init__(self, site, ms):
        self.site, self.ms, self.t0 = site, ms, 1.0

    def read(self):
        return self.ms


def test_chrome_device_lane_at_launch_time(tiny, tmp_path):
    tdev.set_sample(1.0)
    ttracing.set_sample(1.0)
    _je, te = _engines(tiny, "lane")
    _je.close(timeout=60)
    _soak(te)
    doc = ttracing.export_chrome(str(tmp_path / "c.json"))
    lane = [e for e in doc["traceEvents"] if e.get("cat") == "device"]
    assert lane and all(e["tid"] == 0 and e["ph"] == "X" for e in lane)
    hops = [e["ts"] for e in doc["traceEvents"] if e.get("cat") == "trace"]
    assert min(e["ts"] for e in lane) >= min(hops)
    meta = [e for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("tid") == 0]
    assert meta and "device" in meta[0]["args"]["name"]
    json.loads((tmp_path / "c.json").read_text())


def test_hbm_watermark_is_a_no_op_on_the_cpu():
    assert tdev.hbm_watermark("t") == {} == jdev.hbm_watermark("t")
    assert not [e for e in tflight.tail(0) if e["kind"] == "hbm.watermark"]


def test_hbm_watermark_records_and_feeds_the_governor(monkeypatch):
    from mxnet_tpu_torch.resilience import hbm

    hbm.reset()
    monkeypatch.setattr(tacc, "sample_hbm", lambda: {0: (700, 900)})
    monkeypatch.setattr(tacc, "device_memory", lambda: {0: {
        "allocated": 700, "peak": 900, "reserved": 800, "free": 300,
        "total": 1000}})
    try:
        assert tdev.hbm_watermark("t") == {0: (700, 900)}
        ev = [e for e in tflight.tail(0) if e["kind"] == "hbm.watermark"]
        assert ev[-1]["devices"]["0"] == {"in_use": 700, "peak": 900,
                                          "reserved": 800, "free": 300,
                                          "total": 1000}
        gov = hbm.governor()
        assert gov.capacity_bytes() == 1000 and gov.tier() == "yellow"
    finally:
        hbm.reset()


def test_perf_debug_view_renders():
    from mxnet_tpu_torch.telemetry import httpd

    doc = httpd._debug_views()["perf"]
    assert set(doc) == set(jdev._perf_view()) == {"devprof",
                                                  "perf_verdicts"}
    assert isinstance(doc["perf_verdicts"], list)
    assert set(doc["devprof"]) == set(jdev.summary())
