"""Span tracing: one instrumentation point, two sinks.

Ported as it is from ``mxnet_tpu/telemetry/spans.py``.

``telemetry.span("name")`` times a region and publishes the duration to

* the metrics registry — ``mxnet_span_duration_ms{category=,span=}``
  summary series (p50/p90/p99 over the recent window), and
* the profiler event buffer — a chrome://tracing complete event in the
  same ``category`` lane as the rest of the framework's events,

so a region instrumented once shows up both on a Prometheus scrape and in
the chrome trace of a profiling session. Each sink keeps its
own switch: the registry records iff ``MXNET_TELEMETRY`` is on, the event
buffer iff a ``profiler.set_state('run')`` session is live; with both off
the span costs two module-global reads and no clock call.

Use as a context manager, a decorator, or both::

    with telemetry.span("load_checkpoint"):
        ...

    @telemetry.span("kvstore.push", category="kvstore")
    def push(...): ...

:func:`traced` is the dynamic-label variant for call sites whose span name
depends on the arguments (the executor's ``forward(<symbol>)``).
"""
from __future__ import annotations

import functools
import time

from .. import profiler as _profiler
from . import registry as _registry

__all__ = ["span", "traced", "SPAN_MS"]

#: Every span's duration lands here; ``category`` groups related spans
#: (executor/kvstore/serving/…), ``span`` is the specific region.
SPAN_MS = _registry.histogram(
    "mxnet_span_duration_ms",
    "duration of telemetry.span regions in milliseconds",
    labels=("category", "span"))


class span:
    """Timed region feeding the registry and the profiler event buffer."""

    __slots__ = ("name", "category", "_t0")

    def __init__(self, name: str, category: str = "span"):
        self.name = name
        self.category = category
        self._t0 = None

    def __enter__(self):
        if _registry.ENABLED or _profiler.ENABLED:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        if t0 is None:
            return False
        self._t0 = None
        dur_s = time.perf_counter() - t0
        if _registry.ENABLED:
            SPAN_MS.observe(dur_s * 1e3, category=self.category,
                            span=self.name)
        # record_event re-checks profiler.ENABLED itself (it may have been
        # paused while the span was open)
        _profiler.record_event(self.name, self.category, t0 * 1e6,
                               dur_s * 1e6)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_registry.ENABLED or _profiler.ENABLED):
                return fn(*args, **kwargs)
            with span(self.name, self.category):
                return fn(*args, **kwargs)

        return wrapper


def traced(category: str, label):
    """Decorator variant of :class:`span` for dynamic names: ``label`` is a
    string or a callable over the wrapped function's arguments. Supersedes
    ``profiler.profiled`` at framework call sites — same event-buffer
    output, plus the registry histogram."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_registry.ENABLED or _profiler.ENABLED):
                return fn(*args, **kwargs)
            lbl = label(*args, **kwargs) if callable(label) else label
            with span(lbl, category):
                return fn(*args, **kwargs)

        return wrapper

    return deco
