"""The HBM pressure governor: the port against the JAX package (CPU).

The same pressure trace gives the same tier sequence, hysteresis and red
latch in both governors; ``classify`` agrees with the JAX one over its
exception table and calls ``torch.OutOfMemoryError`` (and a capture's
``MXNetError`` that carries its text) ``device``; the same decode soak
under chaos ``action=oom`` (every request queued before the first
admission) gives each request the same outcome in both engines, the
completed ones oracle-exact, with the governed admit; orange defers
batch tenants and never interactive ones; /healthz answers 503 while red;
a ``TrainPlane`` step that OOMs leaves a dump and demotes.
"""
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mxnet_tpu import serving as jserving
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.resilience import hbm as jhbm
from mxnet_tpu.telemetry import flightrec as jflight

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd, serving as tserving, trainplane
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import RetryPolicy, chaos as tchaos
from mxnet_tpu_torch.resilience import hbm as thbm
from mxnet_tpu_torch.resilience.chaos import FaultInjected, OOMInjected
from mxnet_tpu_torch.telemetry import flightrec as tflight
from mxnet_tpu_torch.telemetry import httpd as thttpd

_DIMS = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
             num_kv_heads=2)


@pytest.fixture(autouse=True)
def _clean():
    for chaos, hbm, flight in ((jchaos, jhbm, jflight),
                               (tchaos, thbm, tflight)):
        chaos.disable()
        hbm.reset()
        flight.clear()
    yield
    for chaos, hbm, flight in ((jchaos, jhbm, jflight),
                               (tchaos, thbm, tflight)):
        chaos.disable()
        hbm.reset()
        flight.clear()
    thttpd.stop_httpd()


@pytest.fixture(scope="module")
def tiny():
    jm = jserving.TinyDecoder(**_DIMS)
    jp = jm.init_params(0)
    tm = tserving.TinyDecoder(**_DIMS)
    tp = tserving.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _gov(hbm, **kw):
    kw.setdefault("capacity_bytes", 100)
    kw.setdefault("yellow", 0.70)
    kw.setdefault("orange", 0.85)
    kw.setdefault("red", 0.95)
    kw.setdefault("hysteresis", 0.05)
    kw.setdefault("red_hold", 2)
    return hbm.PressureGovernor(**kw)


_TRACE = [0, 75, 90, 96, 92, 0, 0, 0, 72, 66, 64, 88, 84, 79, 99, "latch",
          0, 0, 0, 50, 0, 0]


def _run_trace(hbm):
    gov = _gov(hbm)
    load = {"b": 0}
    gov.register_bound("plane", lambda: load["b"])
    tiers = []
    for step in _TRACE:
        if step == "latch":
            gov.latch_red("oom:trace")
            tiers.append(gov.tier())
            continue
        load["b"] = step
        tiers.append(gov.observe(source="trace"))
    return tiers, gov.tiers_seen(), gov.healthz_view()


def test_same_pressure_trace_gives_the_same_tiers_as_jax():
    t = _run_trace(thbm)
    assert t == _run_trace(jhbm)
    tiers = t[0]
    assert tiers[:8] == ["green", "yellow", "orange", "red", "red",
                         "orange", "yellow", "green"]
    assert {"red"} == {tiers[_TRACE.index("latch")]}


@pytest.mark.parametrize("device_used,bounds,expected", [
    (None, (40, 35), "yellow"), ((96, 96), (40, 35), "red"),
    ((10, 10), (), "green"), ((86, 90), (0,), "orange")])
def test_pressure_is_max_of_device_and_bounds(device_used, bounds,
                                              expected):
    out = []
    for hbm in (thbm, jhbm):
        gov = _gov(hbm)
        for i, b in enumerate(bounds):
            gov.register_bound("b%d" % i, b)
        if device_used is not None:
            gov.observe_device({0: device_used})
        out.append(gov.observe())
    assert out == [expected, expected]


def test_unknown_capacity_on_the_cpu_means_no_tier_pressure():
    gov = _gov(thbm, capacity_bytes=0)
    gov.register_bound("kv", 1 << 40)
    assert gov.capacity_bytes() is None and gov.observe() == "green"


def test_red_latch_then_release_after_red_hold():
    for hbm in (thbm, jhbm):
        gov = _gov(hbm, capacity_bytes=0, red_hold=3)
        assert gov.latch_red("oom:test") == "green"
        assert [gov.observe() for _ in range(3)] == ["red", "red", "green"]
        assert not gov.latched and gov.healthz_view()["latch_reason"] \
            is None


def test_broken_bound_reads_zero_and_report_is_json():
    gov = _gov(thbm)
    gov.register_bound("bad", lambda: 1 / 0)
    gov.register_bound("good", 75)
    assert gov.observe() == "yellow"
    rep = gov.oom_report()
    assert rep["bounds_bytes"] == {"bad": 0, "good": 75}
    assert rep["device_memory"] == {}  # the CPU has no allocator counters
    json.loads(json.dumps(gov.debug_view()))
    jrep = _gov(jhbm).oom_report()
    assert set(rep) - set(jrep) == {"device_memory"}


def test_governed_admit_default_and_knob(monkeypatch):
    gov = _gov(thbm)
    assert [gov.governed_admit(n) for n in (1, 2, 7)] == [1, 1, 3]
    monkeypatch.setenv("MXNET_HBM_RED_ADMIT", "5")
    assert gov.governed_admit(7) == 5 == _gov(jhbm).governed_admit(7)


_TABLE = [
    (MemoryError("host heap"), "host"),
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                  "allocate 17179869184 bytes"), "device"),
    (RuntimeError("failed to allocate request"), "device"),
    (RuntimeError("device OOM during fusion"), "device"),
    (RuntimeError("allocation failure in the pool"), "device"),
    (ValueError("shape mismatch"), None),
    (ValueError("zoom level out of range"), None),
    (KeyError("room"), None),
    (None, None),
]


@pytest.mark.parametrize("exc,kind", _TABLE)
def test_classify_agrees_with_jax(exc, kind):
    assert thbm.classify(exc) == jhbm.classify(exc) == kind


def test_classify_the_allocators_errors():
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB")
    assert thbm.classify(oom) == "device"
    wrapped = MXNetError("DecodeEngine 'x': capturing the step path as a "
                         "CUDA graph failed: %s" % oom)
    assert thbm.classify(wrapped) == "device"
    assert thbm.classify(OOMInjected("s", 1)) == "injected"
    assert thbm.classify(FaultInjected("s", 1)) is None


def test_retry_policy_refuses_to_retry_an_oom():
    calls = []

    def alloc():
        calls.append(1)
        raise OOMInjected("x", len(calls))

    with pytest.raises(OOMInjected):
        RetryPolicy(max_attempts=5, base_delay_ms=0).call(alloc, site="x")
    assert len(calls) == 1


def test_oom_survival_ignores_non_oom_and_latches_on_oom(tmp_path,
                                                         monkeypatch):
    assert not thbm.oom_survival("p", ValueError("x"))
    path = str(tmp_path / "d.json")
    monkeypatch.setenv("MXNET_FLIGHTREC_PATH", path)
    assert thbm.oom_survival("p", torch.OutOfMemoryError("CUDA out of "
                                                         "memory"))
    gov = thbm.governor()
    assert gov.latched and gov.healthz_view()["oom_count"] == 1
    doc = json.loads(open(path).read())
    ev = [e for e in doc["events"] if e["kind"] == "hbm.oom"][-1]
    assert ev["plane"] == "p" and ev["oom_kind"] == "device"
    assert {"bounds_bytes", "watermarks", "device_memory"} <= \
        set(ev["report"])


def _soak_engine(kind, tiny, name):
    jm, jp, tm, tp = tiny
    kw = dict(num_slots=3, max_seq_len=48, prefill_buckets=(8, 16),
              timeout_ms=0, breaker_threshold=1000)
    if kind == "jax":
        return jserving.DecodeEngine(jm, jp, name="j" + name, **kw)
    return tserving.DecodeEngine(tm, tp, name="t" + name, device="cpu",
                                 **kw)


def _soak(engine, chaos, reqs, spec):
    engine.warmup()
    chaos.configure(spec)
    with engine._cv:
        futs = [engine.submit(p, m) for p, m in reqs]
    outs = []
    for f in futs:
        try:
            outs.append(np.asarray(f.result(timeout=120)).tolist())
        except Exception as exc:  # noqa: BLE001 - the outcome is the point
            outs.append(type(exc).__name__)
    chaos.disable()
    mid = engine.stats()
    again = [np.asarray(engine.submit(p, m).result(timeout=120)).tolist()
             for p, m in reqs[:4]]
    st = engine.stats()
    engine.close(timeout=60)
    return outs, again, mid, st


def test_decode_oom_soak_same_outcomes_as_jax_and_oracle_exact(tiny,
                                                              monkeypatch):
    monkeypatch.setenv("MXNET_TENANT_BREAKER_THRESHOLD", "1000")
    _jm, _jp, tm, tp = tiny
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(1, 32, int(rng.randint(2, 12))).astype(np.int32),
             int(rng.randint(2, 7))) for _ in range(14)]
    spec = ("seed=5,site=serving.decode.prefill,p=0.2,action=oom;"
            "seed=5,site=serving.decode,p=0.04,action=oom")
    j = _soak(_soak_engine("jax", tiny, "soak"), jchaos, reqs, spec)
    t = _soak(_soak_engine("torch", tiny, "soak"), tchaos, reqs, spec)
    assert t[0] == j[0] and t[1] == j[1]
    assert "OOMInjected" in t[0] and any(isinstance(o, list) for o in t[0])
    for (p, m), got in zip(reqs, t[0]):
        if isinstance(got, list):
            assert got == tm.reference_generate(tp, p, m).tolist()
    for (p, m), got in zip(reqs, t[1]):
        assert got == tm.reference_generate(tp, p, m).tolist()
    mid, st = t[2], t[3]
    assert mid["hbm"]["oom_count"] == j[2]["hbm"]["oom_count"] > 0
    assert "red" in thbm.governor().tiers_seen()
    assert st["hbm"]["tier"] == "green" and not st["hbm"]["latched"]
    assert st["hbm"]["governed_limit"] is None
    assert st["steady_state_recompiles"] == 0
    assert st["evictions"] == j[3]["evictions"]


def test_orange_defers_batch_never_interactive(tiny):
    gov = thbm.governor()
    bound = 1 << 20
    gov.register_bound("test.synthetic", bound)
    eng = _soak_engine("torch", tiny, "orange")
    try:
        gold = eng.tenants.register(
            "gold", priority=tserving.PRIORITY_CLASSES["interactive"])
        bulk = eng.tenants.register(
            "bulk", priority=tserving.PRIORITY_CLASSES["batch"])
        eng.warmup()
        gov.set_capacity(int(bound / 0.87))  # pressure ~0.87: orange
        with eng._cv:
            bulk_futs = [eng.submit([1, 2, 3], 4, tenant="bulk")
                         for _ in range(2)]
            gold_futs = [eng.submit([4, 5, 6], 4, tenant="gold")
                         for _ in range(2)]
        for f in gold_futs:
            f.result(timeout=120)
        assert bulk.stats.snapshot()["deferred_pressure"] > 0
        assert gold.stats.snapshot()["deferred_pressure"] == 0
        assert not any(f.done() for f in bulk_futs)
        gov.set_capacity(bound * 4)
        for f in bulk_futs:
            f.result(timeout=120)
        assert bulk.stats.snapshot()["shed"] == 0
    finally:
        eng.close(timeout=60)
    assert "orange" in gov.tiers_seen()


def test_yellow_sheds_cached_prefix_pages(tiny):
    gov = thbm.governor()
    eng = _soak_engine("torch", tiny, "yellow")
    try:
        eng.warmup()
        eng.generate(list(range(1, 18)), 3, timeout=60)  # pages cached
        cached = eng.kvcache_stats()["pages_cached"]
        assert cached > 0
        # a synthetic bound that dominates the engine's own: pressure
        # just above yellow's 0.70
        big = 100 * sum(gov.oom_report()["bounds_bytes"].values())
        gov.register_bound("test.synthetic", big)
        gov.set_capacity(int(big / 0.72))
        eng.generate([5, 6, 7], 2, timeout=60)
        st = eng.stats()
    finally:
        eng.close(timeout=60)
        gov.register_bound("test.synthetic", 0)
    # every page cached before the pressure went at the next admission
    assert st["hbm"]["pressure_sheds"] >= cached
    assert "yellow" in gov.tiers_seen()


def test_healthz_503_while_red_over_http():
    thbm.governor().latch_red("oom:test")
    srv = thttpd.start_httpd(port=0)
    try:
        url = "http://127.0.0.1:%d/healthz" % srv.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=10)
        assert ei.value.code == 503
        doc = json.loads(ei.value.read().decode())
        assert doc["status"] == "degraded" and doc["pressure"]["latched"]
        assert doc["pressure"]["latch_reason"] == "oom:test"
        view = thttpd._debug_views()["hbm"]
        assert view["tier"] == "red" and "transitions" in view
    finally:
        thttpd.stop_httpd()


def _plane(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TRAINSTEP", "1")
    monkeypatch.setenv("MXNET_FLIGHTREC_PATH", str(tmp_path / "box.json"))
    rs = np.random.RandomState(3)
    xs = rs.rand(32, 6).astype(np.float32)
    ys = rs.randint(0, 8, (32,)).astype(np.float32)
    with mx.cpu():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(8))
        net.initialize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        plane = trainplane.TrainPlane(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), tr)
    return plane, xs, ys


def _loss(plane, x, y):
    with mx.cpu():
        out = plane.step(nd.array(x), nd.array(y))
    return float(np.asarray(out.asnumpy()).mean())


def test_trainplane_oom_dumps_diagnostic_then_demotes(monkeypatch,
                                                      tmp_path):
    plane, xs, ys = _plane(monkeypatch, tmp_path)
    assert np.isfinite(_loss(plane, xs[:8], ys[:8]))
    assert plane.plane == "graph"
    tchaos.configure("seed=1,site=jit.compile,p=1.0,max=1,action=oom")
    assert np.isfinite(_loss(plane, xs[8:16], ys[8:16]))
    tchaos.disable()
    assert plane.plane == "eager" and plane._why_eager == \
        "oom: OOMInjected"
    assert thbm.governor().latched
    path = tflight.last_dump_path()
    assert path == str(tmp_path / "box.json")
    doc = json.loads(open(path).read())
    assert doc["reason"].startswith("hbm oom at trainplane.step")
    ev = [e for e in doc["events"] if e["kind"] == "hbm.oom"][-1]
    assert ev["plane"] == "trainplane.step" and ev["oom_kind"] == \
        "injected"
    assert {"bounds_bytes", "watermarks"} <= set(ev["report"])
    assert np.isfinite(_loss(plane, xs[16:24], ys[16:24]))


def test_trainplane_capture_oom_takes_the_same_path(monkeypatch, tmp_path):
    plane, xs, ys = _plane(monkeypatch, tmp_path)

    def capture(path, probe_rows):
        return torch.OutOfMemoryError("CUDA out of memory (capture)")

    monkeypatch.setattr(plane, "_capture", capture)
    assert np.isfinite(_loss(plane, xs[:8], ys[:8]))
    assert plane.plane == "eager" and plane._why_eager == \
        "oom: OutOfMemoryError"
    assert thbm.governor().latched


def test_trainplane_non_oom_still_propagates(monkeypatch, tmp_path):
    plane, xs, ys = _plane(monkeypatch, tmp_path)
    _loss(plane, xs[:8], ys[:8])
    tchaos.configure("seed=1,site=jit.compile,p=1.0,max=1,action=fault")
    with pytest.raises(FaultInjected):
        _loss(plane, xs[8:16], ys[8:16])
    assert plane.plane == "graph" and not thbm.governor().latched
