"""Live SLO engine: the serving burn alerts, evaluated in-process.

Ported as it is from ``mxnet_tpu/telemetry/slo.py``. It evaluates the
burn alerts against the telemetry registry, so a fleet without a
Prometheus stack (a single-host soak, the /healthz endpoint) still gets
the same verdicts:

* **multi-window burn** — each ``*Burn`` alert pairs a *fast* window
  (``MXNET_SLO_FAST_S``, page) with a *slow* window (``MXNET_SLO_SLOW_S``,
  ticket): the mean of the sampled series over the window crosses the
  threshold ⇒ the alert fires at that window's level. Samples accumulate
  whenever :func:`evaluate` runs (engine ``stats()``, the /healthz
  endpoint, the fleet autoscaler) — the engine is a pull evaluator, it
  owns no thread;
* **invariant alerts** — TenantPagesOverBudget, EngineBreakerOpen,
  TenantBreakerOpen, RecompileStorm fire on the *current* sample;
* **surfacing** — every fired alert sets ``mxnet_slo_burn{alert=}`` to
  its burn ratio (value/threshold; 0 when clear), lands in
  ``stats()["alerts"]``, and hits the flight recorder on the rising edge
  (``slo.alert``) and on clear (``slo.clear``) — a black-box dump shows
  which alerts were live at death.

:func:`audit` cross-checks fired alerts against the raw series they were
computed from: an engine that pages RecompileStorm while every
steady-state gauge reads 0 — or stays silent while one reads 2 — is
itself broken.

Bounds the registry cannot carry (queue-depth capacity, per-tenant page
budgets) are registered by the planes at construction through
:func:`note_bound`.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..base import get_env
from . import flightrec as _flightrec
from . import registry as _registry

__all__ = ["SLOEngine", "engine", "evaluate", "active_alerts", "audit",
           "note_bound", "reset", "BURN"]

_DEF_FAST_S = 60.0
_DEF_SLOW_S = 600.0
_DEF_TTFT_MS = 500.0

BURN = _registry.gauge(
    "mxnet_slo_burn",
    "burn ratio (value over threshold) of each evaluated SLO alert; "
    "0 = clear, >= 1 = firing",
    labels=("alert",))

#: Alert names.
ALERTS = ("QueueDepthBurn", "TenantQueueBurn", "SlotOccupancyBurn",
          "PagesBurn", "TenantPagesOverBudget", "TenantBreakerOpen",
          "EngineBreakerOpen", "TTFTBurn", "PrefixHitCollapse",
          "RecompileStorm", "FleetImbalanceBurn", "HBMPressureBurn")


def _rows(name: str) -> List[Dict[str, Any]]:
    m = _registry.REGISTRY.get(name)
    return m.series() if m is not None else []


def _label_key(labels: Dict[str, str]) -> str:
    return "/".join(labels[k] for k in sorted(labels))


class SLOEngine:
    """Pull-mode burn evaluator over the process registry."""

    def __init__(self, fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None):
        if fast_s is None:
            fast_s = get_env("MXNET_SLO_FAST_S", _DEF_FAST_S, float,
                             cache=False)
        if slow_s is None:
            slow_s = get_env("MXNET_SLO_SLOW_S", _DEF_SLOW_S, float,
                             cache=False)
        self.fast_s = max(0.001, float(fast_s))
        self.slow_s = max(self.fast_s, float(slow_s))
        self._lock = threading.Lock()
        #: (series, instance) -> deque[(t, value)], pruned to slow_s
        self._hist: Dict[Tuple[str, str], "collections.deque"] = {}
        #: bounds the registry cannot carry: (kind, instance) -> value
        self._bounds: Dict[Tuple[str, str], float] = {}
        #: alerts currently firing, keyed (alert, instance) -> dict
        self._active: Dict[Tuple[str, str], Dict[str, Any]] = {}

    # -- inputs ------------------------------------------------------------
    def note_bound(self, kind: str, instance: str, value: float) -> None:
        """Register a capacity/budget the burn ratios divide by:
        ``queue_depth`` (per server), ``tenant_queue_depth`` /
        ``tenant_pages`` (per ``server/tenant``)."""
        with self._lock:
            self._bounds[(kind, str(instance))] = float(value)

    def _bound(self, kind: str, instance: str) -> Optional[float]:
        with self._lock:
            return self._bounds.get((kind, instance))

    def _observe(self, series: str, instance: str, value: float,
                 now: float) -> None:
        key = (series, instance)
        with self._lock:
            dq = self._hist.get(key)
            if dq is None:
                # maxlen is the memory backstop; the REAL bound is the
                # time prune below — a fast evaluation cadence (1s
                # healthz probes + per-stats() sampling) must not shrink
                # the slow window below slow_s by count-evicting it
                dq = self._hist[key] = collections.deque(maxlen=65536)
            dq.append((now, float(value)))
            horizon = now - self.slow_s
            while dq and dq[0][0] < horizon:
                dq.popleft()

    def mean(self, series: str, instance: str,
             window: Optional[float] = None) -> Optional[float]:
        """Windowed mean of one sampled series (``window`` seconds,
        default the fast window; ``None`` when the window holds no
        samples). The fleet autoscaler's scale-down signal reads the
        per-replica occupancy series through this instead of re-deriving
        its own history."""
        return self._mean(series, str(instance),
                          self.fast_s if window is None else float(window),
                          time.monotonic())

    def _mean(self, series: str, instance: str, window: float,
              now: float) -> Optional[float]:
        with self._lock:
            dq = self._hist.get((series, instance))
            if not dq:
                return None
            vals = [v for (t, v) in dq if now - t <= window]
        if not vals:
            return None
        return sum(vals) / len(vals)

    def _delta(self, series: str, instance: str, window: float,
               now: float) -> float:
        """Increase of a counter sample over the window (0 when the
        window holds < 2 samples)."""
        with self._lock:
            dq = self._hist.get((series, instance))
            if not dq:
                return 0.0
            vals = [v for (t, v) in dq if now - t <= window]
        if len(vals) < 2:
            return 0.0
        return max(0.0, vals[-1] - vals[0])

    def sample(self, now: Optional[float] = None) -> None:
        """Read the watched series' current values into the history."""
        if not _registry.ENABLED:
            return
        now = time.monotonic() if now is None else now
        watch_gauges = (
            "mxnet_serving_queue_depth", "mxnet_tenant_queue_depth",
            "mxnet_decode_slot_occupancy", "mxnet_kvcache_pages_in_use",
            "mxnet_kvcache_pages_capacity", "mxnet_tenant_pages_in_use",
            "mxnet_tenant_breaker_state", "mxnet_breaker_state",
            "mxnet_steady_state_recompiles", "mxnet_fleet_load_imbalance",
            "mxnet_hbm_pressure_tier")
        for name in watch_gauges:
            for row in _rows(name):
                self._observe(name, _label_key(row["labels"]),
                              row["value"], now)
        watch_counters = ("mxnet_kvcache_prefix_hits_total",
                          "mxnet_kvcache_prefix_misses_total")
        for name in watch_counters:
            for row in _rows(name):
                self._observe(name, _label_key(row["labels"]),
                              row["value"], now)
        # TTFT p99 per server (histogram summary row)
        for row in _rows("mxnet_serving_ttft_ms"):
            self._observe("mxnet_serving_ttft_ms:p99",
                          _label_key(row["labels"]), row["p99"], now)

    # -- evaluation --------------------------------------------------------
    def _burn(self, fired, alert, instance, value, threshold, level,
              window_s, hint):
        ratio = (value / threshold) if threshold else float(value > 0)
        fired.append({"alert": alert, "instance": instance,
                      "level": level, "value": round(float(value), 6),
                      "threshold": threshold,
                      "burn": round(float(ratio), 4),
                      "window_s": window_s, "hint": hint})

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Sample, then evaluate every alert; returns the fired list
        (most severe first), updates the ``mxnet_slo_burn`` gauges and
        records rising/clearing edges in the flight recorder."""
        if not _registry.ENABLED:
            return []
        now = time.monotonic() if now is None else now
        self.sample(now)
        fired: List[Dict[str, Any]] = []
        fast, slow = self.fast_s, self.slow_s

        # QueueDepthBurn / TenantQueueBurn: mean depth over capacity
        for series, kind, alert in (
                ("mxnet_serving_queue_depth", "queue_depth",
                 "QueueDepthBurn"),
                ("mxnet_tenant_queue_depth", "tenant_queue_depth",
                 "TenantQueueBurn")):
            for row in _rows(series):
                inst = _label_key(row["labels"])
                bound = self._bound(kind, inst)
                if kind == "tenant_queue_depth" and bound is None:
                    # unconfigured tenants inherit the engine's global
                    # bound (the registry default) — fall back to it
                    bound = self._bound("queue_depth",
                                        row["labels"].get("server", ""))
                if not bound:
                    continue
                m_fast = self._mean(series, inst, fast, now)
                m_slow = self._mean(series, inst, slow, now)
                if m_fast is not None and m_fast / bound > 0.9:
                    self._burn(fired, alert, inst, m_fast / bound, 0.9,
                               "page", fast,
                               "shedding imminent/underway")
                elif m_slow is not None and m_slow / bound > 0.5:
                    self._burn(fired, alert, inst, m_slow / bound, 0.5,
                               "warn", slow,
                               "sustained backlog: add capacity")

        # SlotOccupancyBurn: sustained compute saturation
        for row in _rows("mxnet_decode_slot_occupancy"):
            inst = _label_key(row["labels"])
            m_fast = self._mean("mxnet_decode_slot_occupancy", inst,
                                fast, now)
            m_slow = self._mean("mxnet_decode_slot_occupancy", inst,
                                slow, now)
            if m_fast is not None and m_fast > 0.85:
                self._burn(fired, "SlotOccupancyBurn", inst, m_fast, 0.85,
                           "page", fast, "decode compute-saturated: "
                           "scale out or raise MXNET_DECODE_SLOTS")
            elif m_slow is not None and m_slow > 0.85:
                self._burn(fired, "SlotOccupancyBurn", inst, m_slow, 0.85,
                           "warn", slow, "sustained saturation")

        # PagesBurn: pool occupancy over capacity
        caps = {_label_key(r["labels"]): r["value"]
                for r in _rows("mxnet_kvcache_pages_capacity")}
        for row in _rows("mxnet_kvcache_pages_in_use"):
            inst = _label_key(row["labels"])
            cap = caps.get(inst)
            if not cap:
                continue
            m_fast = self._mean("mxnet_kvcache_pages_in_use", inst,
                                fast, now)
            m_slow = self._mean("mxnet_kvcache_pages_in_use", inst,
                                slow, now)
            if m_fast is not None and m_fast / cap > 0.8:
                self._burn(fired, "PagesBurn", inst, m_fast / cap, 0.8,
                           "page", fast, "admission will defer soon: "
                           "raise MXNET_KVCACHE_PAGES or tighten budgets")
            elif m_slow is not None and m_slow / cap > 0.8:
                self._burn(fired, "PagesBurn", inst, m_slow / cap, 0.8,
                           "warn", slow, "sustained page pressure")

        # TenantPagesOverBudget: invariant violation, any sample
        for row in _rows("mxnet_tenant_pages_in_use"):
            inst = _label_key(row["labels"])
            budget = self._bound("tenant_pages", inst)
            if budget and row["value"] > budget:
                self._burn(fired, "TenantPagesOverBudget", inst,
                           row["value"], budget, "page", 0.0,
                           "INVARIANT VIOLATION: control plane "
                           "guarantees <= budget at every tick")

        # breaker alerts: current state == open (2)
        for series, alert, hint in (
                ("mxnet_tenant_breaker_state", "TenantBreakerOpen",
                 "one tenant shed alone: page the tenant's owner"),
                ("mxnet_breaker_state", "EngineBreakerOpen",
                 "engine-level faults: the fleet oncall's page")):
            for row in _rows(series):
                if series == "mxnet_breaker_state" and \
                        not row["labels"].get("site", "").startswith(
                            "serving."):
                    continue
                if row["value"] >= 2:
                    self._burn(fired, alert, _label_key(row["labels"]),
                               row["value"], 2.0, "page", 0.0, hint)

        # TTFTBurn: p99 over the SLO over the fast window
        ttft_slo = get_env("MXNET_SLO_TTFT_MS", _DEF_TTFT_MS, float,
                           cache=False)
        if ttft_slo > 0:
            for row in _rows("mxnet_serving_ttft_ms"):
                inst = _label_key(row["labels"])
                m_fast = self._mean("mxnet_serving_ttft_ms:p99", inst,
                                    fast, now)
                if m_fast is not None and m_fast > ttft_slo:
                    self._burn(fired, "TTFTBurn", inst, m_fast, ttft_slo,
                               "page", fast, "check deferred_pages vs "
                               "occupancy to split capacity from rung")

        # PrefixHitCollapse: windowed hit ratio under the fleet baseline
        base_ratio = get_env("MXNET_SLO_PREFIX_RATIO", 0.0, float,
                             cache=False)
        if base_ratio > 0:
            for row in _rows("mxnet_kvcache_prefix_hits_total"):
                inst = _label_key(row["labels"])
                hits = self._delta("mxnet_kvcache_prefix_hits_total",
                                   inst, slow, now)
                misses = self._delta("mxnet_kvcache_prefix_misses_total",
                                     inst, slow, now)
                if hits + misses <= 0:
                    continue
                ratio = hits / (hits + misses)
                if ratio < base_ratio:
                    self._burn(fired, "PrefixHitCollapse", inst,
                               ratio, base_ratio, "warn", slow,
                               "leading indicator for TTFTBurn: prompt "
                               "mix change, swap flush, or pool too "
                               "small")

        # FleetImbalanceBurn: one replica absorbing the fleet's load.
        # The router publishes max/mean in-flight over live replicas
        # (1.0 = perfectly balanced); prefix affinity legitimately skews
        # placement, so the thresholds tolerate a hot replica and fire
        # only when the skew is extreme (fast) or sustained (slow) —
        # the signal that the prefix->replica index collapsed onto one
        # replica or a restart left a replica cold and unrouted.
        for row in _rows("mxnet_fleet_load_imbalance"):
            inst = _label_key(row["labels"])
            m_fast = self._mean("mxnet_fleet_load_imbalance", inst,
                                fast, now)
            m_slow = self._mean("mxnet_fleet_load_imbalance", inst,
                                slow, now)
            if m_fast is not None and m_fast > 4.0:
                self._burn(fired, "FleetImbalanceBurn", inst, m_fast, 4.0,
                           "page", fast, "one replica is absorbing the "
                           "fleet: check /debug/state fleet view for a "
                           "dead/cold replica or an index collapse")
            elif m_slow is not None and m_slow > 2.0:
                self._burn(fired, "FleetImbalanceBurn", inst, m_slow, 2.0,
                           "warn", slow, "sustained placement skew: "
                           "rebalance the prefix index or add a replica")

        # RecompileStorm: the compile-once contract broke — any sample.
        # Keyed SOLELY off the steady-state gauge, which warmup anchors
        # at 0: a raw recompile-counter delta would page every ordinary
        # startup's warmup compiles and flap /healthz for the whole slow
        # window (the PromQL increase() spelling in the docs is for
        # fleets that subtract a deploy marker; in-process the warm
        # baseline is the gauge's whole job)
        for row in _rows("mxnet_steady_state_recompiles"):
            if row["value"] > 0:
                self._burn(fired, "RecompileStorm",
                           _label_key(row["labels"]), row["value"], 0.0,
                           "page", 0.0, "rollback trigger for the last "
                           "deploy/swap")

        # HBMPressureBurn: the pressure governor's tier gauge (0=green ..
        # 3=red). Red pages on ANY sample — red means admissions are
        # stopped and /healthz is 503ing, so the on-call learns NOW, not
        # after a sustained window. Orange only warns, and only when it
        # is the fast-window norm rather than a single shed-and-recover
        # blip the ladder already absorbed.
        for row in _rows("mxnet_hbm_pressure_tier"):
            inst = _label_key(row["labels"])
            if row["value"] >= 3.0:
                self._burn(fired, "HBMPressureBurn", inst, row["value"],
                           3.0, "page", 0.0, "governor is red: new "
                           "admissions stopped; see /debug/state hbm view "
                           "and the governor's oom_report")
            else:
                m_fast = self._mean("mxnet_hbm_pressure_tier", inst,
                                    fast, now)
                if m_fast is not None and m_fast >= 2.0:
                    self._burn(fired, "HBMPressureBurn", inst, m_fast, 2.0,
                               "warn", fast, "sustained orange: admission "
                               "quanta shrunk and batch tenants deferred; "
                               "shed load or raise MXNET_HBM_CAPACITY_BYTES")

        fired.sort(key=lambda a: (a["level"] != "page", -a["burn"]))
        self._publish(fired)
        return fired

    def _publish(self, fired: List[Dict[str, Any]]) -> None:
        """Gauges + flight-recorder edges + the active set."""
        by_alert: Dict[str, float] = {a: 0.0 for a in ALERTS}
        keys = set()
        for f in fired:
            by_alert[f["alert"]] = max(by_alert.get(f["alert"], 0.0),
                                       f["burn"])
            keys.add((f["alert"], f["instance"]))
        for alert, burn in by_alert.items():
            BURN.set(burn, alert=alert)
        with self._lock:
            prev = set(self._active)
            self._active = {(f["alert"], f["instance"]): f for f in fired}
        for alert, instance in keys - prev:
            _flightrec.record("slo.alert", alert=alert, instance=instance)
        for alert, instance in prev - keys:
            _flightrec.record("slo.clear", alert=alert, instance=instance)

    def active(self) -> List[Dict[str, Any]]:
        """The most recent :meth:`evaluate`'s fired set (no new sample)."""
        with self._lock:
            return list(self._active.values())

    # -- the contradiction gate ---------------------------------------------
    def audit(self) -> List[str]:
        """Cross-check the active alert set against the raw series it
        was computed from. Returns human-readable contradictions — an
        SLO engine that disagrees with its own inputs is worse than
        none."""
        out: List[str] = []
        active = {(f["alert"], f["instance"]) for f in self.active()}
        fired_alerts = {a for a, _ in active}
        # RecompileStorm <=> a steady gauge reads nonzero right now
        steady = [(r, _label_key(r["labels"]))
                  for r in _rows("mxnet_steady_state_recompiles")]
        hot = [inst for r, inst in steady if r["value"] > 0]
        if hot and "RecompileStorm" not in fired_alerts:
            out.append("steady_state_recompiles > 0 at %s but "
                       "RecompileStorm did not fire" % hot)
        if "RecompileStorm" in fired_alerts:
            gauge_insts = {inst for _r, inst in steady}
            for alert, inst in active:
                if alert != "RecompileStorm":
                    continue
                if inst in gauge_insts and inst not in hot:
                    out.append("RecompileStorm fired for %r but its "
                               "steady gauge reads 0" % inst)
        # TenantPagesOverBudget <=> a pages gauge exceeds its budget
        for row in _rows("mxnet_tenant_pages_in_use"):
            inst = _label_key(row["labels"])
            budget = self._bound("tenant_pages", inst)
            if budget and row["value"] > budget \
                    and ("TenantPagesOverBudget", inst) not in active:
                out.append("tenant pages %s > budget %s at %r but "
                           "TenantPagesOverBudget did not fire"
                           % (row["value"], budget, inst))
        # HBMPressureBurn pages <=> the tier gauge reads red right now
        hbm_rows = [(r, _label_key(r["labels"]))
                    for r in _rows("mxnet_hbm_pressure_tier")]
        red = [inst for r, inst in hbm_rows if r["value"] >= 3.0]
        if red and "HBMPressureBurn" not in fired_alerts:
            out.append("hbm pressure tier is red at %s but "
                       "HBMPressureBurn did not fire" % red)
        # EngineBreakerOpen <=> a serving breaker gauge reads open
        open_sites = [
            _label_key(r["labels"])
            for r in _rows("mxnet_breaker_state")
            if r["value"] >= 2
            and r["labels"].get("site", "").startswith("serving.")]
        for site in open_sites:
            if ("EngineBreakerOpen", site) not in active:
                out.append("breaker gauge open at %r but "
                           "EngineBreakerOpen did not fire" % site)
        return out

    def reset(self) -> None:
        with self._lock:
            self._hist.clear()
            self._active.clear()


# ---------------------------------------------------------------------------
# process-wide engine + module-level convenience API
# ---------------------------------------------------------------------------

_ENGINE_LOCK = threading.Lock()
_ENGINE: Optional[SLOEngine] = None


def engine() -> SLOEngine:
    """The process-wide evaluator (lazy; windows from the knobs)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = SLOEngine()
        return _ENGINE


def evaluate() -> List[Dict[str, Any]]:
    return engine().evaluate()


def active_alerts() -> List[Dict[str, Any]]:
    return engine().active()


def audit() -> List[str]:
    return engine().audit()


def note_bound(kind: str, instance: str, value: float) -> None:
    engine().note_bound(kind, instance, value)


def reset() -> None:
    """Drop history + active alerts (test isolation); keeps bounds."""
    engine().reset()
