"""Circuit breakers — stop hammering a dependency that is down.

Ported as it is from ``mxnet_tpu/resilience/breaker.py``.

A :class:`CircuitBreaker` guards one *site* (a serving engine, in
practice) with the classic three-state machine:

* **closed** — traffic flows; consecutive failures are counted, and
  hitting ``failure_threshold`` trips the breaker **open**;
* **open** — :meth:`allow` refuses immediately (the caller degrades:
  serving falls to the next engine, then load-sheds) until
  ``reset_timeout_s`` has elapsed, at which point the next :meth:`allow`
  admits a **half-open** probe;
* **half-open** — up to ``half_open_max`` probes may run; one success
  closes the breaker, one failure re-opens it and restarts the clock.

State is visible two ways: :attr:`state` / :func:`snapshot` for in-process
consumers (``Server.stats()``), and the telemetry gauge
``mxnet_breaker_state{site}`` (0 closed, 1 half-open, 2 open) plus
``mxnet_breaker_transitions_total{site,to}`` for a scraper — a dashboard
sees the trip before the pager does. Thresholds default from the
``MXNET_RESILIENCE_BREAKER_*`` knobs (``docs/env_var.md``).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..base import MXNetError, get_env

__all__ = ["CircuitBreaker", "CircuitOpenError", "breaker", "snapshot",
           "STATE_VALUE"]

_DEF_THRESHOLD = 5
_DEF_RESET_S = 30.0

#: Gauge encoding of breaker states (``mxnet_breaker_state{site}``).
STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


class CircuitOpenError(MXNetError):
    """Refused without trying: the site's breaker is open."""

    def __init__(self, site: str):
        super().__init__("circuit breaker for %r is open" % site)
        self.site = site


_GAUGE = None
_TRANSITIONS = None


def _metrics():
    global _GAUGE, _TRANSITIONS
    if _GAUGE is None:
        from .. import telemetry

        _GAUGE = telemetry.gauge(
            "mxnet_breaker_state",
            "circuit breaker state per site (0 closed, 1 half-open, 2 open)",
            labels=("site",))
        _TRANSITIONS = telemetry.counter(
            "mxnet_breaker_transitions_total",
            "circuit breaker state transitions per site",
            labels=("site", "to"))
    return _GAUGE, _TRANSITIONS


class CircuitBreaker:
    """Per-site closed/open/half-open breaker. Thread-safe; every method is
    O(1) under one lock (the serving batcher calls :meth:`allow` per
    batch, not per request)."""

    def __init__(self, site: str, failure_threshold: Optional[int] = None,
                 reset_timeout_s: Optional[float] = None,
                 half_open_max: int = 1):
        if failure_threshold is None:
            failure_threshold = get_env("MXNET_RESILIENCE_BREAKER_THRESHOLD",
                                        _DEF_THRESHOLD, int, cache=False)
        if reset_timeout_s is None:
            reset_timeout_s = get_env("MXNET_RESILIENCE_BREAKER_RESET_S",
                                      _DEF_RESET_S, float, cache=False)
        self.site = site
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = max(0.0, float(reset_timeout_s))
        self.half_open_max = max(1, int(half_open_max))
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        gauge, _ = _metrics()
        gauge.set(STATE_VALUE["closed"], site=site)

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            # an elapsed open breaker reads as half-open: the next allow()
            # would admit a probe, and stats should say so
            if self._state == "open" and self._elapsed():
                return "half_open"
            return self._state

    def _elapsed(self) -> bool:
        return time.monotonic() - self._opened_at >= self.reset_timeout_s

    def _transition(self, to: str) -> None:
        # caller holds self._lock
        self._state = to
        gauge, transitions = _metrics()
        gauge.set(STATE_VALUE[to], site=self.site)
        transitions.inc(site=self.site, to=to)
        # black box: breaker trips are the canonical "what changed right
        # before the death" event (telemetry resolved by _metrics above)
        from ..telemetry import flightrec

        flightrec.record("breaker", site=self.site, to=to)

    # ------------------------------------------------------------------
    def allow(self) -> bool:
        """May a call proceed right now? Open->half-open promotion happens
        here (time-based), so a caller that only ever asks ``allow`` still
        drives the full state machine."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if not self._elapsed():
                    return False
                self._transition("half_open")
                self._probes = 1
                return True
            # half-open: bounded number of in-flight probes
            if self._probes < self.half_open_max:
                self._probes += 1
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != "closed":
                self._transition("closed")
                self._probes = 0

    def on_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open":
                self._transition("open")
                self._opened_at = time.monotonic()
                self._probes = 0
            elif self._state == "closed" and \
                    self._failures >= self.failure_threshold:
                self._transition("open")
                self._opened_at = time.monotonic()

    def call(self, fn, *args, **kwargs):
        """Run ``fn`` under the breaker: :class:`CircuitOpenError` when the
        breaker refuses, success/failure reported automatically."""
        if not self.allow():
            raise CircuitOpenError(self.site)
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.on_failure()
            raise
        self.on_success()
        return out

    def __repr__(self) -> str:
        return "CircuitBreaker(%r, state=%s, failures=%d/%d)" % (
            self.site, self.state, self._failures, self.failure_threshold)


# ---------------------------------------------------------------------------
# per-site registry (get-or-create, like telemetry metrics)
# ---------------------------------------------------------------------------

_REG_LOCK = threading.Lock()
_REGISTRY: Dict[str, CircuitBreaker] = {}


def breaker(site: str, **kwargs) -> CircuitBreaker:
    """Get-or-create the process-wide breaker for ``site``. ``kwargs`` only
    apply on first creation (matching telemetry's get-or-create contract)."""
    with _REG_LOCK:
        br = _REGISTRY.get(site)
        if br is None:
            br = _REGISTRY[site] = CircuitBreaker(site, **kwargs)
        return br


def snapshot() -> Dict[str, str]:
    """``{site: state}`` for every registered breaker."""
    with _REG_LOCK:
        items = list(_REGISTRY.items())
    return {site: br.state for site, br in items}
