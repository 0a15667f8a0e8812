"""Exporters: Prometheus text format, JSON snapshot, JSONL emitter thread.

Ported as it is from ``mxnet_tpu/telemetry/exporters.py``.

Three ways the same registry leaves the process:

* :func:`render_prometheus` — the `text exposition format`_ a Prometheus
  scrape expects; counters/gauges verbatim, histograms as summaries
  (``{quantile="0.5"}``/``_sum``/``_count``). Serve it from any HTTP
  handler, or dump it to a file for node-exporter's textfile collector.
* :func:`snapshot` — a plain-dict point-in-time view for benches and
  tests.
* :class:`Emitter` / :func:`start_emitter` — a daemon thread appending
  ``snapshot()`` lines to a JSONL file every ``MXNET_TELEMETRY_EMIT_SECS``
  seconds. This is the post-mortem channel: a run that hangs and gets
  killed leaves its last-known recompile/transfer state on disk even
  though no in-process consumer survived to ask.

.. _text exposition format:
   https://prometheus.io/docs/instrumenting/exposition_formats/
"""
from __future__ import annotations

import atexit
import json
import threading
import time
from typing import Any, Dict, Optional

from ..base import get_env
from . import registry as _registry

__all__ = ["render_prometheus", "snapshot", "Emitter", "start_emitter",
           "stop_emitter"]

_DEFAULT_EMIT_PATH = "telemetry.jsonl"


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: Dict[str, str], extra: Optional[str] = None) -> str:
    parts = ['%s="%s"' % (k, _escape_label(v)) for k, v in labels.items()]
    if extra:
        parts.append(extra)
    if not parts:
        return ""
    return "{%s}" % ",".join(parts)


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(registry: Optional[_registry.Registry] = None) -> str:
    """The whole registry in Prometheus text exposition format."""
    reg = registry if registry is not None else _registry.REGISTRY
    lines = []
    for metric in reg.metrics():
        rows = metric.series()
        if not rows:
            continue
        if metric.help:
            lines.append("# HELP %s %s" % (metric.name, metric.help))
        prom_type = "summary" if metric.kind == "histogram" else metric.kind
        lines.append("# TYPE %s %s" % (metric.name, prom_type))
        for row in rows:
            labels = row["labels"]
            if metric.kind == "histogram":
                for q in metric.quantiles:
                    lines.append("%s%s %s" % (
                        metric.name,
                        _fmt_labels(labels, 'quantile="%g"' % q),
                        _fmt_value(row["p%g" % (q * 100)])))
                lines.append("%s_sum%s %s" % (metric.name,
                                              _fmt_labels(labels),
                                              _fmt_value(row["sum"])))
                lines.append("%s_count%s %s" % (metric.name,
                                                _fmt_labels(labels),
                                                _fmt_value(row["count"])))
            else:
                lines.append("%s%s %s" % (metric.name, _fmt_labels(labels),
                                          _fmt_value(row["value"])))
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot(registry: Optional[_registry.Registry] = None) -> Dict[str, Any]:
    """Point-in-time dict: ``{"ts": ..., "enabled": ..., "metrics":
    {name: {"type", "help", "series": [...]}}}``. Safe to call with
    telemetry disabled (returns whatever was collected while enabled)."""
    reg = registry if registry is not None else _registry.REGISTRY
    metrics: Dict[str, Any] = {}
    for metric in reg.metrics():
        rows = metric.series()
        if not rows:
            continue
        metrics[metric.name] = {"type": metric.kind, "help": metric.help,
                                "series": rows}
    return {"ts": time.time(), "enabled": _registry.ENABLED,
            "metrics": metrics}


class Emitter(threading.Thread):
    """Daemon thread appending one ``snapshot()`` JSON line per interval.

    Writes are line-atomic (single ``write`` of one line) and flushed, so
    a ``kill -9`` mid-run loses at most the current interval. Failures to
    write (read-only fs, deleted dir) disable the emitter rather than
    spamming; telemetry must never take down the run it observes.
    """

    def __init__(self, interval_s: float, path: str,
                 registry: Optional[_registry.Registry] = None):
        super().__init__(name="mxnet-telemetry-emitter", daemon=True)
        self.interval_s = max(0.1, float(interval_s))
        self.path = path
        self._registry = registry
        self._stop_event = threading.Event()

    def run(self):
        while not self._stop_event.wait(self.interval_s):
            if not self.emit_once():
                return

    def emit_once(self) -> bool:
        """Append one snapshot line; False when the sink is unwritable."""
        try:
            # HBM watermark rides the emit cadence: every run gets a
            # device-memory timeline in the JSONL tail and the flight-
            # recorder ring.
            # Lazy import (devprof loads after exporters); the probe
            # itself is guarded inside hbm_watermark — a stat-less
            # backend must not cost the snapshot line.
            try:
                from . import devprof as _devprof
            except ImportError:
                _devprof = None
            if _devprof is not None:
                _devprof.hbm_watermark("emitter")
            line = json.dumps(snapshot(self._registry))
            with open(self.path, "a") as f:
                f.write(line + "\n")
            return True
        except (OSError, ValueError, TypeError):
            return False

    def stop(self, timeout: Optional[float] = 1.0):
        self._stop_event.set()
        if self.is_alive():
            self.join(timeout)


_emitter_lock = threading.Lock()
_emitter: Optional[Emitter] = None
_atexit_registered = False


def _atexit_flush():
    """Final snapshot line at interpreter exit: a run that dies BETWEEN
    emit intervals (the exact post-mortem window the flight recorder
    also serves) still leaves its last-known state on disk instead of
    losing up to one full interval of tail. Registered once, when the
    first emitter starts; a daemon thread cannot flush itself at exit —
    it is killed mid-wait — so the hook runs on the main thread."""
    with _emitter_lock:
        emitter = _emitter
    if emitter is not None:
        emitter.emit_once()


def start_emitter(interval_s: Optional[float] = None,
                  path: Optional[str] = None) -> Optional[Emitter]:
    """Start (or return the already-running) background emitter.

    Defaults come from ``MXNET_TELEMETRY_EMIT_SECS`` /
    ``MXNET_TELEMETRY_EMIT_PATH``; a non-positive interval means no
    emitter (returns None). Idempotent: one emitter per process.
    """
    global _emitter
    if interval_s is None:
        interval_s = get_env("MXNET_TELEMETRY_EMIT_SECS", 0.0, float,
                             cache=False)
    if interval_s is None or interval_s <= 0:
        return None
    if path is None:
        path = get_env("MXNET_TELEMETRY_EMIT_PATH", _DEFAULT_EMIT_PATH,
                       cache=False)
    global _atexit_registered
    with _emitter_lock:
        if _emitter is not None and _emitter.is_alive():
            return _emitter
        _emitter = Emitter(interval_s, path)
        _emitter.start()
        if not _atexit_registered:
            atexit.register(_atexit_flush)
            _atexit_registered = True
        return _emitter


def stop_emitter():
    """Stop the background emitter if one is running."""
    global _emitter
    with _emitter_lock:
        if _emitter is not None:
            _emitter.stop()
            _emitter = None
