"""Tracing, the flight recorder, SLOs and httpd: the port against the JAX
package (CPU).

The same churn through both decode engines (the same weights through
``params_from_jax``, every request queued before the first admission,
the same chaos schedule) gives each request the same hop kinds and the
same terminal, and the flight recorder the same event kinds; the ring is
bounded and ordered, its dump a readable JSON that no ``ckpt.commit``
fault stops; both SLO engines fire the same alerts over the same gauge
trace; httpd serves ``/metrics``, ``/healthz``, ``/debug/state`` and
``/debug/trace/<id>``.
"""
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.resilience import RetryPolicy as JRetry
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.telemetry import flightrec as jflight
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu.telemetry import tracing as jtracing

from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.resilience import RetryPolicy as TRetry
from mxnet_tpu_torch.resilience import chaos as tchaos
from mxnet_tpu_torch.telemetry import flightrec as tflight
from mxnet_tpu_torch.telemetry import httpd as thttpd
from mxnet_tpu_torch.telemetry import slo as tslo
from mxnet_tpu_torch.telemetry import tracing as ttracing

_DIMS = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=4)
_TERMINALS = {"complete", "evict", "timeout", "shed", "error", "rejected"}


@pytest.fixture(autouse=True)
def _clean():
    # the SLO engines read the whole process registry: series an earlier
    # test left (another file's engines) must not fire here
    for chaos, tracing, flight, slo, tel in (
            (jchaos, jtracing, jflight, jslo, jtel),
            (tchaos, ttracing, tflight, tslo, ttel)):
        chaos.disable()
        tracing.set_sample(None)
        tracing.clear()
        flight.clear()
        slo.reset()
        tel.REGISTRY.clear_data()
    yield
    for chaos, tracing, flight, slo, tel in (
            (jchaos, jtracing, jflight, jslo, jtel),
            (tchaos, ttracing, tflight, tslo, ttel)):
        chaos.disable()
        tracing.set_sample(None)
        tracing.clear()
        flight.clear()
        slo.reset()
        tel.set_enabled(True)
    thttpd.stop_httpd()


@pytest.fixture(scope="module")
def tiny():
    jm = jserving.TinyDecoder(**_DIMS)
    jp = jm.init_params(0)
    tm = tserving.TinyDecoder(**_DIMS)
    tp = tserving.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _engines(tiny, name, **kw):
    jm, jp, tm, tp = tiny
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 48)
    kw.setdefault("prefill_buckets", (8,))
    kw.setdefault("timeout_ms", 0)
    kw.setdefault("page_size", 4)
    je = jserving.DecodeEngine(jm, jp, name="j" + name,
                               retry_policy=JRetry(max_attempts=1), **kw)
    te = tserving.DecodeEngine(tm, tp, name="t" + name, device="cpu",
                               retry_policy=TRetry(max_attempts=1), **kw)
    return je, te


def _churn():
    """Shared prefixes (hits, a copy on write), three tenants, mixed
    lengths."""
    sys_p = [3, 1, 4, 1, 5, 9, 2, 6]
    reqs = []
    for i in range(10):
        tail = [(7 * i) % 29 + 1, (3 * i) % 31 + 1][: 1 + i % 2]
        prompt = sys_p + tail if i % 3 != 2 else [i % 30 + 1, 2, 3]
        reqs.append((prompt, 2 + i % 5, ("gold", "bronze", None)[i % 3]))
    reqs.append((reqs[0][0], 3, None))  # a whole-prompt hit
    return reqs


def _run(engine, reqs, spec=None):
    """Every request queued before the first admission (the engine's
    condition is re-entrant), under ``spec``; returns each request's
    outcome."""
    chaos = jchaos if isinstance(engine, jserving.DecodeEngine) else tchaos
    engine.warmup()
    if spec:
        chaos.configure(spec)
    futs = []
    with engine._cv:
        for prompt, n, tenant in reqs:
            futs.append(engine.submit(prompt, n, tenant=tenant))
    outs = []
    for f in futs:
        try:
            outs.append(np.asarray(f.result(timeout=120)).tolist())
        except Exception as exc:  # noqa: BLE001 - the outcome is the point
            outs.append(type(exc).__name__)
    chaos.disable()
    stats = engine.stats()
    engine.close(timeout=60)
    return outs, stats


def _chains(tracing, tel, server):
    traces = [tel.get_trace(t) for t in tracing.trace_ids()]
    traces = [t for t in traces if t["server"] == server]
    traces.sort(key=lambda t: t["t0"])
    return [[e["kind"] for e in t["events"]] for t in traces]


@pytest.mark.parametrize("spec", [
    None,
    "seed=5,site=serving.decode,at=6;seed=5,site=serving.decode.prefill,at=4",
])
def test_same_churn_same_hops_and_terminals_as_jax(tiny, spec):
    reqs = _churn()
    je, te = _engines(tiny, "churn%d" % (spec is None),
                      prefix_cache=True, breaker_threshold=1000)
    jtracing.set_sample(1.0)
    ttracing.set_sample(1.0)
    j_out, j_st = _run(je, reqs, spec)
    t_out, t_st = _run(te, reqs, spec)
    assert t_out == j_out
    j_chains = _chains(jtracing, jtel, je.name)
    t_chains = _chains(ttracing, ttel, te.name)
    assert len(t_chains) == len(reqs) and t_chains == j_chains
    for chain in t_chains:
        assert chain[0] == "submit" and chain[-1] in _TERMINALS
    terminals = {c[-1] for c in t_chains}
    if spec is None:
        assert terminals == {"complete"}
        assert any("prefix_hit" in c for c in t_chains)
        assert any("cow_copy" in c for c in t_chains)
    else:
        assert {"complete", "evict", "error"} <= terminals
    assert t_st["steady_state_recompiles"] == 0
    assert t_st["evictions"] == j_st["evictions"]

    def kinds(flight):
        out = []
        for e in flight.tail(0):
            if e["kind"] == "decode.tick":
                out.append(("tick", [r[1:] for r in e["reqs"]]))
            elif e["kind"].startswith(("decode.", "chaos.")):
                out.append(e["kind"])
        return out

    assert kinds(tflight) == kinds(jflight)


def test_sampling_gates_trace_minting():
    ttracing.set_sample(0.0)
    assert ttracing.start_trace("decode", "s", "t") is None
    ttracing.set_sample(1.0)
    tr = ttracing.start_trace("decode", "s", "t")
    assert tr is not None and ttracing.trace_ids() == [tr.trace_id]
    ttel.set_enabled(False)
    assert ttracing.start_trace("decode", "s", "t") is None


def test_trace_event_cap_keeps_the_terminal(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_MAX_EVENTS", "8")
    ttracing.set_sample(1.0)
    tr = ttracing.start_trace("decode", "s", "t")
    for i in range(20):
        ttracing.event(tr, "tick", i=i)
    ttracing.finish(tr, "complete")
    ttracing.finish(tr, "error")  # the first terminal wins
    doc = ttel.get_trace(tr.trace_id)
    assert doc["truncated"] and len(doc["events"]) == 8
    assert doc["events"][-1]["kind"] == "complete"


def test_trace_store_capacity_evicts_oldest(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_CAPACITY", "3")
    ttracing.set_sample(1.0)
    ids = [ttracing.start_trace("decode", "s", "t").trace_id
           for _ in range(5)]
    assert ttracing.trace_ids() == ids[2:]


def test_export_chrome_renders_hops_as_slices(tmp_path):
    ttracing.set_sample(1.0)
    tr = ttracing.start_trace("decode", "srv", "gold")
    ttracing.event(tr, "submit")
    ttracing.event(tr, "enqueue")
    ttracing.finish(tr, "complete", tokens=3)
    doc = ttracing.export_chrome(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == doc
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "trace"]
    assert [(e["name"], e["ph"]) for e in mine] == [
        ("submit", "X"), ("enqueue", "X"), ("complete", "i")]
    assert mine[-1]["args"]["tokens"] == 3


def test_flightrec_ring_is_bounded_and_ordered():
    for flight in (tflight, jflight):
        flight.configure(capacity=16)
        for i in range(40):
            flight.record("ev", i=i)
    t_tail, j_tail = tflight.tail(0), jflight.tail(0)
    assert [e["i"] for e in t_tail] == [e["i"] for e in j_tail] == \
        list(range(24, 40))
    assert [e["i"] for e in tflight.tail(3)] == [37, 38, 39]
    for flight in (tflight, jflight):
        flight.configure(capacity=4096)


def test_flightrec_dump_is_readable_and_no_commit_fault_stops_it(tmp_path):
    tflight.record("breaker", site="s", to="open")
    path = str(tmp_path / "box.json")
    with tchaos.active("seed=1,site=ckpt.commit,p=1.0"):
        assert tflight.dump("death", path=path) == path
    doc = json.loads(open(path).read())
    jpath = jflight.dump("death", path=str(tmp_path / "j.json"))
    jdoc = json.loads(open(jpath).read())
    assert set(doc) == set(jdoc) == {"reason", "ts", "t", "pid", "events"}
    assert doc["reason"] == "death" and doc["events"][-1]["kind"] == \
        "breaker"
    assert tflight.last_dump_path() == path
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_engine_catch_all_dumps_the_black_box(tiny, tmp_path, monkeypatch):
    path = str(tmp_path / "catch.json")
    monkeypatch.setenv("MXNET_FLIGHTREC_PATH", path)
    _je, te = _engines(tiny, "catch")
    te.warmup()

    def broken():
        raise RuntimeError("admission bug")

    monkeypatch.setattr(te, "_admit", broken)
    with pytest.raises(RuntimeError):
        te.submit([1, 2, 3], 2).result(timeout=60)
    te.close(drain=False, timeout=60)
    doc = json.loads(open(path).read())
    assert doc["reason"].startswith("decode engine catch-all")
    assert any(e["kind"] == "decode.engine_exception"
               for e in doc["events"])


def _gauge_trace(slo_mod, tel, engine):
    """The same queue-depth / breaker / recompile gauges into ``tel``'s
    registry, evaluated at the same instants."""
    depth = tel.REGISTRY.gauge("mxnet_serving_queue_depth",
                               labels=("server",))
    steady = tel.REGISTRY.gauge("mxnet_steady_state_recompiles",
                                labels=("site",))
    br = tel.REGISTRY.gauge("mxnet_breaker_state", labels=("site",))
    for m in (depth, steady, br):
        m.clear()
    engine.note_bound("queue_depth", "s1", 10)
    out = []
    for i, (d, s, b) in enumerate([(2, 0, 0), (9.5, 0, 0), (10, 1, 0),
                                   (10, 0, 2), (1, 0, 0)]):
        depth.set(d, server="s1")
        steady.set(s, site="serving.s1")
        br.set(b, site="serving.s1.decode")
        out.append(engine.evaluate(now=100.0 + i))
    return out, engine.audit()


def test_slo_alerts_over_the_same_gauge_trace_match_jax():
    t_out, t_audit = _gauge_trace(tslo, ttel, tslo.SLOEngine(fast_s=2,
                                                             slow_s=4))
    j_out, j_audit = _gauge_trace(jslo, jtel, jslo.SLOEngine(fast_s=2,
                                                             slow_s=4))
    assert t_out == j_out and t_audit == j_audit == []
    fired = {a["alert"] for step in t_out for a in step}
    assert {"QueueDepthBurn", "RecompileStorm",
            "EngineBreakerOpen"} <= fired
    assert t_out[0] == []


def test_slo_edges_land_in_the_flight_recorder():
    eng = tslo.SLOEngine(fast_s=1, slow_s=2)
    g = ttel.REGISTRY.gauge("mxnet_steady_state_recompiles",
                            labels=("site",))
    g.set(3, site="serving.edge")
    eng.evaluate(now=10.0)
    g.set(0, site="serving.edge")
    eng.evaluate(now=11.0)
    kinds = [(e["kind"], e["alert"]) for e in tflight.tail(0)
             if e["kind"].startswith("slo.")]
    assert ("slo.alert", "RecompileStorm") in kinds
    assert ("slo.clear", "RecompileStorm") in kinds
    assert ttel.REGISTRY.get("mxnet_slo_burn").value(
        alert="RecompileStorm") == 0


def test_slo_audit_reports_a_contradiction():
    eng = tslo.SLOEngine(fast_s=1, slow_s=2)
    ttel.REGISTRY.gauge("mxnet_steady_state_recompiles",
                        labels=("site",)).set(2, site="serving.aud")
    assert eng.audit()  # nothing evaluated yet: the gauge reads 2
    eng.evaluate(now=1.0)
    assert eng.audit() == []


def test_decode_stats_carry_alerts_and_hbm(tiny):
    _je, te = _engines(tiny, "stats")
    try:
        te.warmup()
        te.generate([1, 2, 3], 3, timeout=60)
        st = te.stats()
    finally:
        te.close(timeout=60)
    assert isinstance(st["alerts"], list)
    assert st["hbm"]["tier"] == "green" and "governed_limit" in st["hbm"]


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_httpd_serves_metrics_health_state_and_traces():
    ttracing.set_sample(1.0)
    tr = ttracing.start_trace("decode", "srv", "t")
    ttracing.finish(tr, "complete")
    ttel.TRANSFERS.inc(path="fetch_host")
    server = ttel.start_httpd(port=0)
    try:
        assert server.server_address[0] == "127.0.0.1"
        port = server.server_address[1]
        code, body = _get(port, "/metrics")
        assert code == 200 and b"mxnet_host_transfers_total" in body
        code, body = _get(port, "/healthz")
        health = json.loads(body)
        assert code in (200, 503) and {"status", "breakers", "alerts",
                                       "pressure"} <= set(health)
        code, body = _get(port, "/debug/state")
        state = json.loads(body)
        assert code == 200 and {"snapshot", "flightrec", "alerts",
                                "perf", "hbm", "fleet"} <= set(state)
        code, body = _get(port, "/debug/trace/" + tr.trace_id)
        assert code == 200 and json.loads(body)["trace_id"] == tr.trace_id
        assert _get(port, "/debug/trace/nope")[0] == 404
        assert _get(port, "/debug/traces")[0] == 200
        code, body = _get(port, "/debug/perf")
        assert code == 200 and "devprof" in json.loads(body)
        assert _get(port, "/nowhere")[0] == 404
    finally:
        ttel.stop_httpd()
    assert thttpd.httpd_address() is None


def test_httpd_debug_view_registry_isolates_a_broken_view():
    thttpd.register_debug_view("boom", lambda: 1 / 0)
    thttpd.register_debug_view("fine", lambda: {"ok": 1})
    try:
        views = thttpd._debug_views()
        assert views["fine"] == {"ok": 1} and "error" in views["boom"]
    finally:
        thttpd.unregister_debug_view("boom")
        thttpd.unregister_debug_view("fine")
