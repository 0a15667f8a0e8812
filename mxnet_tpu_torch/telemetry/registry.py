"""Metrics registry: Counter/Gauge/Histogram with labels, process-wide.

The collection core of :mod:`mxnet_tpu_torch.telemetry` (ported as it is
from ``mxnet_tpu/telemetry/registry.py``). Design constraints, in
priority order:

1. **disabled means free** — every update method checks the module-level
   :data:`ENABLED` flag *before* touching any lock or dict, so a process
   running with ``MXNET_TELEMETRY=0`` pays one global read per
   instrumentation point and nothing else;
2. **thread-safe** — serving worker threads, io prefetch threads and the
   main training loop all publish concurrently: series mutation is guarded
   by a per-metric lock, metric registration by a registry lock;
3. **bounded memory** — histograms keep exact ``count``/``sum`` forever but
   hold only the most recent ``MXNET_TELEMETRY_RESERVOIR`` observations for
   percentiles (the same recent-window semantics as
   ``serving.ServingStats``), so an unbounded run cannot grow the registry.

Metric and label names must match the Prometheus data model
(``[a-zA-Z_:][a-zA-Z0-9_:]*``) so every registered series is exportable by
:func:`mxnet_tpu_torch.telemetry.render_prometheus` without mangling.
"""
from __future__ import annotations

import collections
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, get_env

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "enabled", "set_enabled",
           "ENABLED"]

# Master switch, read per-process at import; tests and embedders flip it at
# runtime through set_enabled(). Update paths read this module global bare —
# no lock — which is what keeps the disabled path free.
ENABLED = bool(get_env("MXNET_TELEMETRY", 1, int, cache=False))

_DEFAULT_RESERVOIR = 2048

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def enabled() -> bool:
    """Whether the registry is collecting (``MXNET_TELEMETRY`` knob)."""
    return ENABLED


def set_enabled(flag: bool) -> bool:
    """Flip collection on/off at runtime; returns the previous state."""
    global ENABLED
    prev = ENABLED
    ENABLED = bool(flag)
    return prev


class _Metric:
    """Shared machinery: label keying + per-metric lock + series storage."""

    kind = ""

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        if not _NAME_RE.match(name):
            raise MXNetError("invalid metric name %r" % name)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise MXNetError("invalid label name %r on metric %r"
                                 % (ln, name))
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(label_names)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if len(labels) != len(self.label_names):
            raise MXNetError(
                "metric %s expects labels %s, got %s"
                % (self.name, list(self.label_names), sorted(labels)))
        try:
            return tuple(str(labels[n]) for n in self.label_names)
        except KeyError as exc:
            raise MXNetError("metric %s missing label %s" % (self.name, exc))

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.label_names, key))

    def clear(self):
        """Drop all recorded series (registration survives)."""
        with self._lock:
            self._series.clear()

    def series(self) -> List[Dict[str, Any]]:
        """Point-in-time list of per-labelset dicts (exporter feed)."""
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing total (Prometheus counter)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if not ENABLED:
            return
        if value < 0:
            raise MXNetError("counter %s cannot decrease (inc %r)"
                             % (self.name, value))
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def series(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._series.items())
        return [{"labels": self._label_dict(k), "value": float(v)}
                for k, v in items]


class Gauge(_Metric):
    """Point-in-time value that can go up and down (Prometheus gauge)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        if not ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, value: float = 1.0, **labels):
        if not ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def series(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._series.items())
        return [{"labels": self._label_dict(k), "value": float(v)}
                for k, v in items]


class _HistSeries:
    __slots__ = ("count", "sum", "window")

    def __init__(self, reservoir: int):
        self.count = 0
        self.sum = 0.0
        self.window = collections.deque(maxlen=reservoir)


class Histogram(_Metric):
    """Duration/size distribution: exact count+sum, bounded-reservoir
    percentiles over the most recent observations. Exported in Prometheus
    *summary* form (``{quantile="0.5"}`` … ``_sum``/``_count``)."""

    kind = "histogram"
    quantiles = (0.5, 0.9, 0.99)

    def __init__(self, name, help, label_names, reservoir: Optional[int] = None):
        super().__init__(name, help, label_names)
        if reservoir is None:
            reservoir = get_env("MXNET_TELEMETRY_RESERVOIR",
                                _DEFAULT_RESERVOIR, int, cache=False)
        self._reservoir = max(1, int(reservoir))

    def observe(self, value: float, **labels):
        if not ENABLED:
            return
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(self._reservoir)
            s.count += 1
            s.sum += value
            s.window.append(value)

    def observe_many(self, values, **labels):
        """Batched :meth:`observe`: one key build + one lock acquisition
        for a whole batch of samples — the per-tick hot path of the
        decode plane (one TPOT sample per active slot per tick)."""
        if not ENABLED or not values:
            return
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(self._reservoir)
            s.count += len(values)
            s.sum += sum(values)
            s.window.extend(values)

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            return s.count if s is not None else 0

    def percentile(self, q: float, **labels) -> float:
        """Percentile (q in [0, 100]) over the recent window; 0.0 when empty."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            window = list(s.window) if s is not None else []
        return _percentile(window, q)

    def series(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = [(k, s.count, s.sum, sorted(s.window))
                     for k, s in self._series.items()]
        out = []
        for key, count, total, window in items:
            row = {"labels": self._label_dict(key), "count": count,
                   "sum": total, "window": len(window)}
            for q in self.quantiles:
                row["p%g" % (q * 100)] = _percentile_sorted(window, q * 100)
            out.append(row)
        return out


def _percentile(window: List[float], q: float) -> float:
    """Nearest-rank percentile over a host list — plain Python on purpose:
    the exporter must not touch numpy/torch (it runs from arbitrary threads,
    including during interpreter teardown in the JSONL emitter)."""
    return _percentile_sorted(sorted(window), q)


def _percentile_sorted(data: List[float], q: float) -> float:
    """:func:`_percentile` over an already-sorted window (one sort serves
    every quantile of a scrape)."""
    if not data:
        return 0.0
    idx = max(0, min(len(data) - 1,
                     int(round(q / 100.0 * (len(data) - 1)))))
    return float(data[idx])


class Registry:
    """Named metric collection. ``counter``/``gauge``/``histogram`` are
    get-or-create: a second registration with the same name returns the
    existing metric (so instrumentation points in different modules can
    share series) but mismatched kind or labels is an error, not a silent
    new metric."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "collections.OrderedDict[str, _Metric]" = \
            collections.OrderedDict()

    def _get_or_create(self, cls, name, help, labels, **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != cls.kind:
                    raise MXNetError(
                        "metric %s already registered as %s (wanted %s)"
                        % (name, existing.kind, cls.kind))
                if existing.label_names != tuple(labels):
                    raise MXNetError(
                        "metric %s already registered with labels %s "
                        "(wanted %s)" % (name, list(existing.label_names),
                                         list(labels)))
                return existing
            metric = cls(name, help, labels, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  reservoir: Optional[int] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   reservoir=reservoir)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def clear_data(self):
        """Reset every metric's series, keeping registrations valid — the
        module-level metric handles held by instrumented code keep working.
        Test isolation."""
        for m in self.metrics():
            m.clear()


#: The process-wide default registry every framework instrumentation point
#: publishes into and the exporters read from.
REGISTRY = Registry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
    """``REGISTRY.counter`` shorthand."""
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    """``REGISTRY.gauge`` shorthand."""
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              reservoir: Optional[int] = None) -> Histogram:
    """``REGISTRY.histogram`` shorthand."""
    return REGISTRY.histogram(name, help, labels, reservoir=reservoir)
