"""Serving observability: counters + latency reservoirs + registry series.

Ported from ``mxnet_tpu/serving/stats.py``: :class:`ServingStats`
backs ``Server.stats()`` and ``DecodeEngine.stats()`` and publishes the
same Prometheus series (``mxnet_serving_requests_total{server=,event=}``,
the ``mxnet_serving_latency_ms`` / TTFT / TPOT summaries, the queue-depth
and batch-fill gauges, per-bucket batch counts, the engine-chain events,
the speculative-decoding counters); :class:`TenantStats` is its
per-tenant twin. Every update also feeds ``profiler`` Counters (queue
depth, batch fill) and Markers (shed, timeout), which no-op unless a
profiling session is running, as the JAX package's do.

Latency is held in a bounded ring (``MXNET_SERVING_LATENCY_WINDOW``,
default 2048 most-recent requests) — percentiles over recent traffic,
O(1) memory under unbounded load.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Optional

import numpy as np

from .. import profiler, telemetry
from ..base import get_env

__all__ = ["ServingStats", "TenantStats"]

_DEFAULT_WINDOW = 2048

# registry handles shared by every ServingStats; the `server` label keeps
# concurrent servers in one process apart
_T_REQS = telemetry.counter(
    "mxnet_serving_requests_total",
    "serving request lifecycle events",
    labels=("server", "event"))
_T_LATENCY = telemetry.histogram(
    "mxnet_serving_latency_ms",
    "end-to-end request latency (submit to result) in milliseconds",
    labels=("server",))
_T_DEPTH = telemetry.gauge(
    "mxnet_serving_queue_depth",
    "requests waiting in the submit queue",
    labels=("server",))
_T_FILL = telemetry.gauge(
    "mxnet_serving_batch_fill_pct",
    "real rows over bucket size of the most recent batch, percent",
    labels=("server",))
_T_BATCHES = telemetry.counter(
    "mxnet_serving_batches_total",
    "device batch executions per bucket rung",
    labels=("server", "bucket"))
_T_ENGINE = telemetry.counter(
    "mxnet_serving_engine_events_total",
    "engine-level resilience events (failure after retries, fallback "
    "serve, load-shed with every breaker open)",
    labels=("server", "engine", "event"))
_T_TTFT = telemetry.histogram(
    "mxnet_serving_ttft_ms",
    "time to first token: submit to the first generated token "
    "(decode plane) in milliseconds",
    labels=("server",))
_T_TPOT = telemetry.histogram(
    "mxnet_serving_tpot_ms",
    "time per output token: inter-token interval during decode in "
    "milliseconds",
    labels=("server",))
_T_CHUNKS = telemetry.counter(
    "mxnet_decode_prefill_chunks_total",
    "prefill chunks executed by the decode plane (prefix-cache tails)",
    labels=("server",))
_T_DRAIN = telemetry.counter(
    "mxnet_serving_drain_completed_total",
    "requests finished during a graceful close(drain=True) — the number "
    "a zero-drop drain/rolling-upgrade asserts against",
    labels=("server",))
_T_SPEC_PROPOSED = telemetry.counter(
    "mxnet_spec_proposed_tokens_total",
    "draft tokens proposed by the speculative decode plane (the verify "
    "rows beyond each slot's committed token)",
    labels=("server",))
_T_SPEC_ACCEPTED = telemetry.counter(
    "mxnet_spec_accepted_tokens_total",
    "draft tokens accepted by greedy verification (committed to the "
    "sequence; proposed - accepted = wasted verify rows)",
    labels=("server",))
_T_SPEC_RATE = telemetry.gauge(
    "mxnet_spec_acceptance_rate",
    "cumulative accepted/proposed draft-token ratio; tenant='_engine' "
    "is the engine-wide row, other rows are per tenant — the signal a "
    "per-tenant spec_k knob is tuned against",
    labels=("server", "tenant"))


def _percentile_rows(out: Dict, pairs) -> None:
    """Emit ``{key}_p50_ms``/``{key}_p99_ms``/``{key}_count`` for each
    ``(key, samples)`` reservoir — shared by the global and per-tenant
    snapshots so the two can never diverge."""
    for key, arr in pairs:
        if arr.size:
            p50, p99 = np.percentile(arr, [50.0, 99.0])
            out[key + "_p50_ms"] = float(p50)
            out[key + "_p99_ms"] = float(p99)
        else:
            out[key + "_p50_ms"] = out[key + "_p99_ms"] = 0.0
        out[key + "_count"] = int(arr.size)


class ServingStats:
    """Thread-safe serving metrics collector for one :class:`Server` or
    decode engine."""

    def __init__(self, name: str = "serving", window: Optional[int] = None):
        if window is None:
            window = get_env("MXNET_SERVING_LATENCY_WINDOW", _DEFAULT_WINDOW,
                             int, cache=False)
        self._lock = threading.Lock()
        self._lat_ms = collections.deque(maxlen=max(1, int(window)))
        # decode-plane reservoirs: first-token latency (TTFT) and the
        # inter-token interval (TPOT) — the two numbers an LLM serving
        # SLO is written in. Empty (and snapshot-zero) for batch servers.
        self._ttft_ms = collections.deque(maxlen=max(1, int(window)))
        self._tpot_ms = collections.deque(maxlen=max(1, int(window)))
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.timeouts = 0
        self.errors = 0
        self.batches = 0
        self.prefill_chunks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.padded_rows = 0
        self.served_rows = 0
        self.isolation_retries = 0
        self.fallbacks = 0
        self.unavailable = 0
        self.engine_failures: Dict[str, int] = {}
        self.bucket_counts: Dict[int, int] = {}
        self._queue_depth = 0
        self.name = name
        # profiler bridge: zero-cost unless a profiling session is live
        dom = profiler.Domain(name)
        self._c_depth = dom.new_counter("queue_depth")
        self._c_fill = dom.new_counter("batch_fill_pct")
        self._m_shed = dom.new_marker("shed")
        self._m_timeout = dom.new_marker("timeout")

    # -- producers (called by the server or the decode engine) -------------
    def on_submit(self, depth: int):
        with self._lock:
            self.submitted += 1
            self._queue_depth = depth
        self._c_depth.set_value(depth)
        _T_REQS.inc(server=self.name, event="submitted")
        _T_DEPTH.set(depth, server=self.name)

    def on_shed(self):
        with self._lock:
            self.shed += 1
        self._m_shed.mark()
        _T_REQS.inc(server=self.name, event="shed")

    def on_timeout(self):
        with self._lock:
            self.timeouts += 1
        self._m_timeout.mark()
        _T_REQS.inc(server=self.name, event="timeout")

    def on_complete(self, latency_ms: float):
        with self._lock:
            self.completed += 1
            self._lat_ms.append(latency_ms)
        _T_REQS.inc(server=self.name, event="completed")
        _T_LATENCY.observe(latency_ms, server=self.name)

    def on_batch(self, real: int, bucket: int, depth: Optional[int]):
        """Record one device execution; ``depth=None`` (isolation reruns)
        leaves the queue-depth gauge untouched."""
        with self._lock:
            self.batches += 1
            self.served_rows += real
            self.padded_rows += bucket - real
            self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
            if depth is not None:
                self._queue_depth = depth
        if depth is not None:
            self._c_depth.set_value(depth)
            _T_DEPTH.set(depth, server=self.name)
        self._c_fill.set_value(100.0 * real / bucket)
        _T_FILL.set(100.0 * real / bucket, server=self.name)
        _T_BATCHES.inc(server=self.name, bucket=bucket)

    def on_first_token(self, ttft_ms: float):
        """First generated token of a sequence delivered: submit-to-first-
        token latency."""
        with self._lock:
            self._ttft_ms.append(ttft_ms)
        _T_TTFT.observe(ttft_ms, server=self.name)

    def on_output_tokens(self, tpot_ms_batch):
        """One decode tick's worth of output tokens (one TPOT sample per
        active slot): single lock acquisition per tick, not per token —
        this sits on the per-token hot path of the decode plane."""
        with self._lock:
            self._tpot_ms.extend(tpot_ms_batch)
        _T_TPOT.observe_many(tpot_ms_batch, server=self.name)

    def on_prefill_chunk(self):
        """One prefill chunk executed (chunked prefill or a prefix-cache
        tail completion)."""
        with self._lock:
            self.prefill_chunks += 1
        _T_CHUNKS.inc(server=self.name)

    def on_spec(self, proposed: int, accepted: int):
        """One decode tick's speculative outcome, batched across slots:
        ``proposed`` draft tokens went into the verify rows, ``accepted``
        of them were committed. One lock acquisition per tick."""
        if proposed <= 0 and accepted <= 0:
            return
        with self._lock:
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            rate = (self.spec_accepted / self.spec_proposed
                    if self.spec_proposed else 0.0)
        if proposed > 0:
            _T_SPEC_PROPOSED.inc(proposed, server=self.name)
        if accepted > 0:
            _T_SPEC_ACCEPTED.inc(accepted, server=self.name)
        _T_SPEC_RATE.set(rate, server=self.name, tenant="_engine")

    def on_error(self):
        with self._lock:
            self.errors += 1
        _T_REQS.inc(server=self.name, event="error")

    def on_drain(self, n: int):
        """``n`` requests completed between ``close(drain=True)`` and the
        worker's exit."""
        if n > 0:
            _T_DRAIN.inc(n, server=self.name)

    def on_isolation_retry(self):
        with self._lock:
            self.isolation_retries += 1
        _T_REQS.inc(server=self.name, event="isolation_retry")

    def on_engine_failure(self, engine: str):
        """One engine exhausted its retries on a batch (the breaker for it
        has already been told); the batch may still be served by the next
        engine in the chain."""
        with self._lock:
            self.engine_failures[engine] = \
                self.engine_failures.get(engine, 0) + 1
        _T_ENGINE.inc(server=self.name, engine=engine, event="failure")

    def on_fallback(self, engine: str):
        """A batch was served by a non-primary engine (degraded mode)."""
        with self._lock:
            self.fallbacks += 1
        _T_ENGINE.inc(server=self.name, engine=engine, event="fallback")

    def on_unavailable(self, n_requests: int):
        """Load shed at the engine layer: every breaker open, ``n``
        requests answered with ``EngineUnavailableError``."""
        with self._lock:
            self.unavailable += n_requests
        _T_ENGINE.inc(n_requests, server=self.name, engine="all",
                      event="unavailable")

    # -- consumer ----------------------------------------------------------
    def snapshot(self) -> Dict:
        """Point-in-time dict of every serving metric (``Server.stats()``)."""
        with self._lock:
            lat = np.asarray(self._lat_ms)
            ttft = np.asarray(self._ttft_ms)
            tpot = np.asarray(self._tpot_ms)
            out = {
                "queue_depth": self._queue_depth,
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "batches": self.batches,
                "prefill_chunks": self.prefill_chunks,
                "spec_proposed_tokens": self.spec_proposed,
                "spec_accepted_tokens": self.spec_accepted,
                "spec_acceptance_rate": (self.spec_accepted /
                                         self.spec_proposed
                                         if self.spec_proposed else 0.0),
                "isolation_retries": self.isolation_retries,
                "fallbacks": self.fallbacks,
                "unavailable": self.unavailable,
                "engine_failures": dict(self.engine_failures),
                "bucket_counts": dict(self.bucket_counts),
                "batch_fill": (self.served_rows /
                               (self.served_rows + self.padded_rows)
                               if self.served_rows else 0.0),
            }
        if lat.size:
            p50, p99 = np.percentile(lat, [50.0, 99.0])
            out["p50_ms"] = float(p50)
            out["p99_ms"] = float(p99)
            out["latency_window"] = int(lat.size)
        else:
            out["p50_ms"] = out["p99_ms"] = 0.0
            out["latency_window"] = 0
        _percentile_rows(out, (("ttft", ttft), ("tpot", tpot)))
        return out


# ---------------------------------------------------------------------------
# per-tenant rows: the multi-tenant control plane's view of the same SLOs
# ---------------------------------------------------------------------------

_T_TEN_REQS = telemetry.counter(
    "mxnet_tenant_requests_total",
    "per-tenant request lifecycle events (submitted, completed, shed, "
    "shed_breaker, timeout, error, deferred_pages, deferred_rate)",
    labels=("server", "tenant", "event"))
_T_TEN_DEPTH = telemetry.gauge(
    "mxnet_tenant_queue_depth",
    "requests waiting in one tenant's sub-queue",
    labels=("server", "tenant"))
_T_TEN_SLOTS = telemetry.gauge(
    "mxnet_tenant_slots_active",
    "decode slots currently held by one tenant's sequences",
    labels=("server", "tenant"))
_T_TEN_PAGES = telemetry.gauge(
    "mxnet_tenant_pages_in_use",
    "KV cache pages currently reserved by one tenant's sequences",
    labels=("server", "tenant"))
_T_TEN_TTFT = telemetry.histogram(
    "mxnet_tenant_ttft_ms",
    "per-tenant time to first token in milliseconds",
    labels=("server", "tenant"))
_T_TEN_TPOT = telemetry.histogram(
    "mxnet_tenant_tpot_ms",
    "per-tenant time per output token in milliseconds",
    labels=("server", "tenant"))
_T_TEN_LATENCY = telemetry.histogram(
    "mxnet_tenant_latency_ms",
    "per-tenant end-to-end request latency in milliseconds",
    labels=("server", "tenant"))


class TenantStats:
    """Thread-safe per-tenant metrics collector (one per tenant per
    engine, owned by :class:`~mxnet_tpu_torch.serving.tenancy.Tenant`).
    Same shape as :class:`ServingStats` but scoped to one tenant's
    traffic and published under the ``mxnet_tenant_*`` families."""

    def __init__(self, server: str, tenant: str,
                 window: Optional[int] = None):
        if window is None:
            window = get_env("MXNET_SERVING_LATENCY_WINDOW",
                             _DEFAULT_WINDOW, int, cache=False)
        self.server = server
        self.tenant = tenant
        self._lock = threading.Lock()
        self._lat_ms = collections.deque(maxlen=max(1, int(window)))
        self._ttft_ms = collections.deque(maxlen=max(1, int(window)))
        self._tpot_ms = collections.deque(maxlen=max(1, int(window)))
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.shed_breaker = 0
        self.timeouts = 0
        self.errors = 0
        self.deferred_pages = 0
        self.deferred_rate = 0
        self.deferred_pressure = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._queue_depth = 0
        self._slots = 0
        self._pages = 0
        self._max_pages = 0

    def _labels(self) -> Dict[str, str]:
        return {"server": self.server, "tenant": self.tenant}

    # -- producers ---------------------------------------------------------
    def on_submit(self, depth: int):
        with self._lock:
            self.submitted += 1
            self._queue_depth = depth
        _T_TEN_REQS.inc(event="submitted", **self._labels())
        _T_TEN_DEPTH.set(depth, **self._labels())

    def set_depth(self, depth: int):
        with self._lock:
            self._queue_depth = depth
        _T_TEN_DEPTH.set(depth, **self._labels())

    def on_shed(self, breaker: bool = False):
        with self._lock:
            if breaker:
                self.shed_breaker += 1
            else:
                self.shed += 1
        _T_TEN_REQS.inc(event="shed_breaker" if breaker else "shed",
                        **self._labels())

    def on_timeout(self):
        with self._lock:
            self.timeouts += 1
        _T_TEN_REQS.inc(event="timeout", **self._labels())

    def on_error(self):
        with self._lock:
            self.errors += 1
        _T_TEN_REQS.inc(event="error", **self._labels())

    def on_defer(self, kind: str):
        """One admission-guard deferral (``pages``, ``rate`` or
        ``pressure`` — the last is the HBM governor's orange-tier
        batch-class rung). Counts *defer events* — the admission loop
        may defer the same head request many times before it finally
        fits."""
        with self._lock:
            if kind == "pages":
                self.deferred_pages += 1
            elif kind == "pressure":
                self.deferred_pressure += 1
            else:
                self.deferred_rate += 1
        _T_TEN_REQS.inc(event="deferred_" + kind, **self._labels())

    def on_first_token(self, ttft_ms: float):
        with self._lock:
            self._ttft_ms.append(ttft_ms)
        _T_TEN_TTFT.observe(ttft_ms, **self._labels())

    def on_output_tokens(self, tpot_ms_batch):
        if not tpot_ms_batch:
            return
        with self._lock:
            self._tpot_ms.extend(tpot_ms_batch)
        _T_TEN_TPOT.observe_many(tpot_ms_batch, **self._labels())

    def on_complete(self, latency_ms: float):
        with self._lock:
            self.completed += 1
            self._lat_ms.append(latency_ms)
        _T_TEN_REQS.inc(event="completed", **self._labels())
        _T_TEN_LATENCY.observe(latency_ms, **self._labels())

    def on_spec(self, proposed: int, accepted: int):
        """This tenant's share of one tick's speculative outcome; keeps
        the per-tenant ``mxnet_spec_acceptance_rate`` row fresh so one
        slow-accepting tenant is visible (and tunable via its ``spec_k``)
        without dividing engine-level counters."""
        if proposed <= 0 and accepted <= 0:
            return
        with self._lock:
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            rate = (self.spec_accepted / self.spec_proposed
                    if self.spec_proposed else 0.0)
        _T_SPEC_RATE.set(rate, **self._labels())

    def set_slots(self, n: int):
        with self._lock:
            self._slots = n
        _T_TEN_SLOTS.set(n, **self._labels())

    def set_pages(self, n: int):
        with self._lock:
            self._pages = n
            if n > self._max_pages:
                self._max_pages = n
        _T_TEN_PAGES.set(n, **self._labels())

    # -- consumer ----------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            lat = np.asarray(self._lat_ms)
            ttft = np.asarray(self._ttft_ms)
            tpot = np.asarray(self._tpot_ms)
            out = {
                "queue_depth": self._queue_depth,
                "slots_active": self._slots,
                "pages_in_use_now": self._pages,
                "pages_in_use_max": self._max_pages,
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "shed_breaker": self.shed_breaker,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "deferred_pages": self.deferred_pages,
                "deferred_rate": self.deferred_rate,
                "deferred_pressure": self.deferred_pressure,
                "spec_proposed_tokens": self.spec_proposed,
                "spec_accepted_tokens": self.spec_accepted,
                "spec_acceptance_rate": (self.spec_accepted /
                                         self.spec_proposed
                                         if self.spec_proposed else 0.0),
            }
        _percentile_rows(out, (("latency", lat), ("ttft", ttft),
                               ("tpot", tpot)))
        return out
