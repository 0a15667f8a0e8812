"""FleetRouter: the port against the JAX package (CPU).

The same requests through both fleets (the same weights, fleet and
replica names, submitted one at a time) go to the same replica and give
the same tokens; the prefix-affinity keys are the JAX cache's bytes; a
fleet's prefix hit ratio is one replica's; drain, add, kill (with and
without the rebuild, which gives back the dead engine's memory) and the
rolling swap drop nothing; the autoscaler adds a replica on a queue
burn and drains the coldest on an occupancy collapse; ``stats()``
merges tenants as ``aggregate_snapshots`` does in both packages.
"""
import contextlib
import json
import time
import urllib.request

import jax
import numpy as np
import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu.serving.tenancy import aggregate_snapshots as jagg
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu.telemetry import tracing as jtracing

from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import chaos as tchaos
from mxnet_tpu_torch.serving import kvcache as tkv
from mxnet_tpu_torch.serving.fleet import FleetRouter, fleet_debug_state
from mxnet_tpu_torch.serving.tenancy import aggregate_snapshots as tagg
from mxnet_tpu_torch.telemetry import httpd as thttpd
from mxnet_tpu_torch.telemetry import slo as tslo
from mxnet_tpu_torch.telemetry import tracing as ttracing

_DIMS = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
             num_kv_heads=2)
_KW = dict(num_slots=2, max_seq_len=48, prefill_buckets=(8, 16),
           timeout_ms=0, page_size=8, prefix_cache=True)


@pytest.fixture(autouse=True)
def _clean():
    for chaos, tracing, slo in ((jchaos, jtracing, jslo),
                                (tchaos, ttracing, tslo)):
        chaos.disable()
        tracing.set_sample(None)
        tracing.clear()
        slo.reset()
    yield
    for chaos, tracing, slo in ((jchaos, jtracing, jslo),
                                (tchaos, ttracing, tslo)):
        chaos.disable()
        tracing.set_sample(None)
        tracing.clear()
        slo.reset()
    thttpd.stop_httpd()


@pytest.fixture(scope="module")
def tiny():
    jm = jserving.TinyDecoder(**_DIMS)
    jp = jm.init_params(0)
    tm = tserving.TinyDecoder(**_DIMS)
    tp = tserving.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tm, tp


def _tfactory(tiny, **kw):
    _jm, _jp, tm, tp = tiny
    opts = dict(_KW, **kw)

    def make(name):
        return tserving.DecodeEngine(tm, tp, name=name, device="cpu", **opts)

    return make


def _jfactory(tiny, **kw):
    jm, jp, _tm, _tp = tiny
    opts = dict(_KW, **kw)

    def make(name):
        return jserving.DecodeEngine(jm, jp, name=name, **opts)

    return make


@contextlib.contextmanager
def _closing(door, timeout=60):
    """Close a fleet with a join timeout, so a hung worker fails its
    test and not the suite."""
    try:
        yield door
    finally:
        door.close(timeout=timeout)


def _fleet(tiny, replicas=2, **kw):
    return _closing(FleetRouter(_tfactory(tiny), replicas=replicas,
                                name=_fname(), **kw))


def _fname():
    return "tfl%d" % np.random.randint(1 << 30)


def _workload(rng, n, prefix_len=16, systems=3):
    sys_p = [rng.randint(1, 32, prefix_len).astype(np.int32)
             for _ in range(systems)]
    return [(np.concatenate([sys_p[i % systems],
                             rng.randint(1, 32, 1 + i % 4).astype(np.int32)]),
             2 + i % 3) for i in range(n)]


def _routes(tracing, tel, fleet):
    out = []
    for tid in tracing.trace_ids():
        t = tel.get_trace(tid)
        if t["plane"] == "fleet" and t["server"] == fleet:
            out.append((t["t0"], [e.get("replica") for e in t["events"]
                                  if e["kind"] == "replica_route"]))
    return [r for _t, r in sorted(out)]


def test_chain_keys_are_the_jax_bytes():
    rng = np.random.RandomState(0)
    parent_j = parent_t = b""
    for _ in range(4):
        chunk = rng.randint(0, 1 << 20, 8).astype(np.int32)
        parent_j = jkv._chain_key(parent_j, chunk)
        parent_t = tkv._chain_key(parent_t, chunk)
        assert parent_t == parent_j


def test_same_requests_same_replica_same_tokens_as_jax(tiny):
    rng = np.random.RandomState(11)
    reqs = _workload(rng, 9) + [(rng.randint(1, 32, 5).astype(np.int32), 3)
                                for _ in range(3)]
    name = _fname()
    jtracing.set_sample(1.0)
    ttracing.set_sample(1.0)
    outs = []
    for Router, factory, tracing, tel in (
            (jserving.FleetRouter, _jfactory(tiny), jtracing, jtel),
            (FleetRouter, _tfactory(tiny), ttracing, ttel)):
        with _closing(Router(factory, replicas=3, name=name)) as fl:
            toks = [fl.generate(p, m, timeout=120).tolist()
                    for p, m in reqs]
            st = fl.stats()
        outs.append((toks, _routes(tracing, tel, name),
                     st["prefix_hit_ratio"], st["router"]["submitted"]))
    assert outs[1] == outs[0]
    routes = outs[1][1]
    # each system prompt stays on one replica
    for s in range(3):
        assert len({tuple(routes[i]) for i in range(s, 9, 3)}) == 1
    _jm, _jp, tm, tp = tiny
    for (p, m), got in zip(reqs, outs[1][0]):
        assert got == tm.reference_generate(tp, p, m).tolist()


def test_fleet_hit_ratio_equals_one_replicas(tiny):
    rng = np.random.RandomState(5)
    reqs = _workload(rng, 8)
    one = _tfactory(tiny)("one" + _fname())
    try:
        for p, m in reqs:
            one.generate(p, m, timeout=120)
        single = one.stats()["prefix_hit_ratio"]
    finally:
        one.close(timeout=60)
    with _fleet(tiny) as fl:
        for p, m in reqs:
            fl.generate(p, m, timeout=120)
        assert fl.stats()["prefix_hit_ratio"] == single > 0


def test_replicas_default_to_the_card_unless_asked(tiny):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _jm, _jp, tm, tp = tiny
    with pytest.raises(MXNetError, match="no CUDA device"):
        FleetRouter(lambda n: tserving.DecodeEngine(tm, tp, name=n),
                    replicas=1, name=_fname())


def test_submit_validation_and_close(tiny):
    fl = FleetRouter(_tfactory(tiny), replicas=2, name=_fname())
    with pytest.raises(MXNetError):
        fl.submit([], 2)
    with pytest.raises(MXNetError):
        fl.submit([1, 2, 3], 100)  # past max_seq_len on every replica
    fl.close(timeout=60)
    assert fl.closed and fl.close(timeout=60) == 0
    with pytest.raises(tserving.ServerClosedError):
        fl.submit([1, 2], 2)


def test_drain_and_add_replica_drop_nothing(tiny):
    rng = np.random.RandomState(9)
    reqs = _workload(rng, 6)
    _jm, _jp, tm, tp = tiny
    with _fleet(tiny) as fl:
        fl.warmup()
        futs = [fl.submit(p, m) for p, m in reqs]
        target = max(fl.debug_state()["replicas"].items(),
                     key=lambda kv: kv[1]["inflight"])[0]
        fl.drain_replica(target)
        for f, (p, m) in zip(futs, reqs):
            np.testing.assert_array_equal(f.result(timeout=120),
                                          tm.reference_generate(tp, p, m))
        assert fl.stats()["replicas_live"] == 1
        assert target not in fl.debug_state()["replicas"]
        added = fl.add_replica()
        assert fl.stats()["replicas_live"] == 2
        for p, m in _workload(np.random.RandomState(2), 6, systems=6):
            fl.generate(p, m, timeout=120)
        assert fl.debug_state()["replicas"][added]["routed"] > 0
        assert fl.stats()["router"]["failed"] == 0


def test_kill_replica_reroutes_exactly_once_and_rebuilds(tiny):
    ttracing.set_sample(1.0)
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(1, 32, 10).astype(np.int32), 6) for _ in range(8)]
    _jm, _jp, tm, tp = tiny
    with _fleet(tiny) as fl:
        fl.warmup()
        futs = [fl.submit(p, m) for p, m in reqs]
        victim = max(fl.debug_state()["replicas"].items(),
                     key=lambda kv: kv[1]["inflight"])[0]
        dead = next(r.engine for r in fl._replicas if r.name == victim)
        fl.kill_replica(victim)
        for f, (p, m) in zip(futs, reqs):
            np.testing.assert_array_equal(f.result(timeout=120),
                                          tm.reference_generate(tp, p, m))
        router = fl.stats()["router"]
        assert router["completed"] == len(reqs) and router["failed"] == 0
        for tid in ttracing.trace_ids():
            t = ttel.get_trace(tid)
            if t["plane"] == "fleet":
                terms = [e for e in t["events"] if e.get("terminal")]
                assert len(terms) == 1 and terms[0]["kind"] == "complete"
        deadline = time.time() + 120
        while fl.debug_state()["replicas"][victim]["state"] != "live":
            assert time.time() < deadline
            time.sleep(0.02)
        row = fl.debug_state()["replicas"][victim]
        assert row["deaths"] == 1 and row["breaker"] == "closed"
        # the dead engine gave its device memory back before the rebuild
        assert dead._paths == {} and dead._params is None
        assert dead._cache.k_pool.numel() == 0
        rebuilt = next(r.engine for r in fl._replicas if r.name == victim)
        assert rebuilt is not dead
        assert rebuilt.stats()["steady_state_recompiles"] == 0


def test_kill_without_restart_isolates_via_breaker(tiny):
    with _fleet(tiny) as fl:
        fl.warmup()
        victim = next(iter(fl.debug_state()["replicas"]))
        fl.kill_replica(victim, restart=False)
        row = fl.debug_state()["replicas"][victim]
        assert row["state"] == "dead" and row["breaker"] == "open"
        for p, m in _workload(np.random.RandomState(4), 4, systems=4):
            fl.generate(p, m, timeout=120)
        assert fl.debug_state()["replicas"][victim]["routed"] == 0 or \
            fl.stats()["replicas_live"] == 1


def test_chaos_site_kills_a_replica_at_routing(tiny):
    _jm, _jp, tm, tp = tiny
    p = np.arange(1, 11, dtype=np.int32)
    with _fleet(tiny) as fl:
        fl.warmup()
        fl.generate(p, 3, timeout=120)  # where this prompt lands
        victim = max(fl.debug_state()["replicas"].items(),
                     key=lambda kv: kv[1]["routed"])[0]
        idx = int(victim.rsplit(".r", 1)[1])
        with tchaos.active("seed=1,site=serving.fleet.replica.%d,at=1"
                           % idx):
            # the affine route walks into the fault: the router contains
            # the death and re-routes before the caller sees it
            np.testing.assert_array_equal(fl.generate(p, 3, timeout=120),
                                          tm.reference_generate(tp, p, 3))
        assert fl.debug_state()["replicas"][victim]["deaths"] == 1
        assert fl.stats()["router"]["completed"] == 2


def test_rolling_swap_drops_nothing_and_recaptures_nothing(tiny):
    _jm, _jp, tm, tp = tiny
    params_b = tm.init_params(1, device="cpu")
    rng = np.random.RandomState(23)
    reqs = [(rng.randint(1, 32, 10).astype(np.int32), 5) for _ in range(6)]
    with _fleet(tiny) as fl:
        fl.warmup()
        fl.register_variant("v2", params_b)
        futs = [fl.submit(p, m) for p, m in reqs]
        assert fl.rolling_swap(variant="v2", timeout=60) == 2
        for f in futs:
            assert f.result(timeout=120) is not None
        p = rng.randint(1, 32, 9).astype(np.int32)
        np.testing.assert_array_equal(fl.generate(p, 4, timeout=120),
                                      tm.reference_generate(params_b, p, 4))
        st = fl.stats()
        assert st["steady_state_recompiles"] == 0
        assert {r["active_variant"] for r in st["replicas"].values()} == \
            {"v2"}
        with pytest.raises(MXNetError):
            fl.rolling_swap()


def test_configure_speculation_reaches_every_replica(tiny):
    with _closing(FleetRouter(_tfactory(tiny, spec_k=2), replicas=2,
                     name=_fname())) as fl:
        fl.configure_speculation("gold", 1)
        caps = {r.engine.tenants.resolve("gold").spec_k
                for r in fl._replicas}
        assert caps == {1}
        fl.configure_speculation("gold", None)
        assert {r.engine.tenants.resolve("gold").spec_k
                for r in fl._replicas} == {None}


def test_autoscaler_scales_up_on_queue_depth_burn(tiny):
    with _fleet(tiny, replicas=1, max_replicas=2) as fl:
        rep = next(iter(fl.debug_state()["replicas"]))
        tslo.note_bound("queue_depth", rep, 10)
        g = ttel.gauge("mxnet_serving_queue_depth", labels=("server",))
        g.set(9.5, server=rep)
        event = fl.autoscale_tick()
        assert event["action"] == "up" and event["reason"] == \
            "QueueDepthBurn"
        assert fl.stats()["replicas_live"] == 2
        assert fl.autoscale_tick() is None  # cooldown
        g.set(0.0, server=rep)


def test_autoscaler_drains_the_coldest_on_occupancy_collapse(tiny):
    with _fleet(tiny, min_replicas=1) as fl:
        g = ttel.gauge("mxnet_decode_slot_occupancy", labels=("server",))
        for rep in fl.debug_state()["replicas"]:
            g.set(0.0, server=rep)
        event = fl.autoscale_tick()
        assert event["action"] == "down" and event["reason"] == \
            "occupancy_collapse"
        assert fl.stats()["replicas_live"] == 1
        assert fl.autoscale_tick(now=time.monotonic() + 3600) is None


def test_debug_state_view_over_httpd(tiny):
    with _fleet(tiny) as fl:
        fl.generate([1, 2, 3, 4], 2, timeout=120)
        view = fleet_debug_state()[fl.name]
        assert set(view["replicas"]) == set(fl.debug_state()["replicas"])
        srv = thttpd.start_httpd(port=0)
        try:
            url = "http://127.0.0.1:%d/debug/fleet" % srv.server_address[1]
            with urllib.request.urlopen(url, timeout=10) as r:
                doc = json.loads(r.read())
        finally:
            thttpd.stop_httpd()
        rep0 = next(iter(doc[fl.name]["replicas"].values()))
        assert rep0["state"] == "live" and {"queue_depth", "pages_in_use",
                                            "breaker"} <= set(rep0)
        assert doc[fl.name]["hbm"]["tier"] == "green"


_SNAPS = [
    [{"gold": {"submitted": 3, "completed": 2, "queue_ms_p99_ms": 5.0,
               "queue_ms_count": 2, "breaker": "closed", "weight": 3.0},
      "bronze": {"submitted": 1, "completed": 1, "breaker": "open"}},
     {"gold": {"submitted": 4, "completed": 4, "queue_ms_p99_ms": 9.0,
               "queue_ms_count": 4, "breaker": "half_open",
               "weight": 3.0, "deferred_pressure": 2}}],
    [],
    [{"t": {"pages_in_use": 3, "spec_proposed_tokens": 8}},
     {"t": {"pages_in_use": 2, "spec_proposed_tokens": 1}}, None],
]


@pytest.mark.parametrize("snaps", _SNAPS)
def test_aggregate_snapshots_matches_jax(snaps):
    assert tagg(snaps) == jagg(snaps)


def test_stats_merge_tenants_across_replicas(tiny):
    with _fleet(tiny) as fl:
        for p, m in _workload(np.random.RandomState(3), 6, systems=6):
            fl.generate(p, m, tenant="gold", timeout=120)
        st = fl.stats()
        assert st["tenants"]["gold"]["completed"] == 6
        assert st["tenants"] == tagg([r["tenants"]
                                      for r in st["replicas"].values()])
