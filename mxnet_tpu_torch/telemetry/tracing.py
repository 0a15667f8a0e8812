"""Per-request causality: trace_id minted at submit(), carried to the end.

Ported as it is from ``mxnet_tpu/telemetry/tracing.py``. The metrics
plane answers "how is the fleet doing"; this module answers "why was
THIS request slow/shed/evicted". A trace is minted at ``submit()`` on
the decode engine and the fleet router, and every hop the request takes —
WFQ enqueue, admission-guard deferrals (pages/rate/breaker verdicts),
prefill and prefill chunks, prefix-cache hits and CoW copies, every
decode tick the sequence participates in, and the terminal event
(complete / evict / timeout / shed / error) — lands as a typed event
with a monotonic timestamp.

Sampling & cost discipline, in priority order:

1. ``MXNET_TELEMETRY=0`` extends to tracing: :func:`start_trace` returns
   ``None`` after one module-global read, and every :func:`event` call
   no-ops on a ``None`` trace — zero locks end to end;
2. ``MXNET_TRACE_SAMPLE`` (0.0-1.0, default 0) decides per *request* at
   mint time; an unsampled request carries ``trace=None`` through the
   whole pipeline, so the per-hop cost of not tracing is one ``is None``
   check — no lock, no clock, no allocation;
3. a sampled trace is bounded: at most ``MXNET_TRACE_MAX_EVENTS`` events
   (a ``truncated`` marker replaces the overflow), and the process keeps
   at most ``MXNET_TRACE_CAPACITY`` traces (oldest evicted) — an
   unbounded soak cannot grow the store.

Reading traces: :func:`get_trace` returns the typed event list for one
id; :func:`export_chrome` renders every retained trace as chrome://
tracing slices MERGED with the profiler/span event buffer, so a request
timeline lands next to the executor/kvstore lanes in one file.
"""
from __future__ import annotations

import collections
import json
import random as _random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .. import profiler as _profiler
from ..base import get_env
from . import registry as _registry

__all__ = ["Trace", "start_trace", "event", "finish", "get_trace",
           "trace_ids", "export_chrome", "set_sample", "clear",
           "TRACES_STARTED"]

_DEFAULT_CAPACITY = 1024
_DEFAULT_MAX_EVENTS = 1024

TRACES_STARTED = _registry.counter(
    "mxnet_traces_started_total",
    "request traces minted at submit() (MXNET_TRACE_SAMPLE-gated)",
    labels=("plane",))

#: test/bench override of MXNET_TRACE_SAMPLE; None = read the env knob.
_SAMPLE_OVERRIDE: List[Optional[float]] = [None]

_LOCK = threading.Lock()
_TRACES: "collections.OrderedDict[str, Trace]" = collections.OrderedDict()

# the sampling decision uses random.random(): a C-level call, no lock;
# determinism is not a goal here (chaos owns the deterministic-fault
# story), only cheapness


def set_sample(rate: Optional[float]) -> None:
    """Override ``MXNET_TRACE_SAMPLE`` in-process (None = back to the
    env knob). Benches use this to run traced-at-1.0 vs sampling-0
    soaks in one process."""
    _SAMPLE_OVERRIDE[0] = None if rate is None else float(rate)


def _sample_rate() -> float:
    ov = _SAMPLE_OVERRIDE[0]
    if ov is not None:
        return ov
    return get_env("MXNET_TRACE_SAMPLE", 0.0, float, cache=False)


class Trace:
    """One request's event chain. Appends take the trace's own lock (two
    threads touch a request: the submitting client and the engine
    worker); everything here is only ever reached for SAMPLED requests.
    """

    __slots__ = ("trace_id", "plane", "server", "tenant", "t0", "ts0",
                 "done", "truncated", "_events", "_max", "_lock")

    def __init__(self, trace_id: str, plane: str, server: str,
                 tenant: str, max_events: int):
        self.trace_id = trace_id
        self.plane = plane
        self.server = server
        self.tenant = tenant
        self.t0 = time.perf_counter()
        self.ts0 = time.time()
        self.done = False
        self.truncated = False
        self._events: List[Dict[str, Any]] = []
        self._max = max_events
        self._lock = threading.Lock()

    def event(self, kind: str, **fields) -> None:
        ev = {"t": time.perf_counter(), "kind": kind}
        if fields:
            ev.update(fields)
        with self._lock:
            if len(self._events) >= self._max:
                self.truncated = True
                return
            self._events.append(ev)

    def finish(self, kind: str, **fields) -> None:
        """Record the terminal hop and mark the trace done. Idempotent:
        the first terminal wins (a close() racing a completion must not
        append a second terminal)."""
        with self._lock:
            if self.done:
                return
            self.done = True
            ev = {"t": time.perf_counter(), "kind": kind, "terminal": True}
            if fields:
                ev.update(fields)
            if len(self._events) >= self._max:
                self.truncated = True
                self._events[-1] = ev  # the terminal always survives
            else:
                self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def as_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "plane": self.plane,
                "server": self.server, "tenant": self.tenant,
                "t0": self.t0, "ts0": self.ts0, "done": self.done,
                "truncated": self.truncated, "events": self.events()}


def start_trace(plane: str, server: str, tenant: str,
                sample: Optional[float] = None) -> Optional[Trace]:
    """Mint a trace for one request, or ``None`` when tracing is off or
    the sampling draw misses. The ``None`` path takes no lock — the
    contract every hop's ``event(trace, ...)`` call relies on."""
    if not _registry.ENABLED:
        return None
    rate = _sample_rate() if sample is None else float(sample)
    if rate <= 0.0:
        return None
    if rate < 1.0 and _random.random() >= rate:
        return None
    trace = Trace(uuid.uuid4().hex[:16], plane, server, tenant,
                  max_events=max(8, get_env("MXNET_TRACE_MAX_EVENTS",
                                            _DEFAULT_MAX_EVENTS, int,
                                            cache=False)))
    cap = max(1, get_env("MXNET_TRACE_CAPACITY", _DEFAULT_CAPACITY, int,
                         cache=False))
    with _LOCK:
        _TRACES[trace.trace_id] = trace
        while len(_TRACES) > cap:
            _TRACES.popitem(last=False)
    TRACES_STARTED.inc(plane=plane)
    return trace


def event(trace: Optional[Trace], kind: str, **fields) -> None:
    """Record one hop on a (possibly unsampled) request. The unsampled
    path is a single ``is None`` check — keep instrumentation points
    unconditional."""
    if trace is None:
        return
    trace.event(kind, **fields)


def finish(trace: Optional[Trace], kind: str, **fields) -> None:
    """Record the terminal hop (complete/evict/timeout/shed/error)."""
    if trace is None:
        return
    trace.finish(kind, **fields)


def get_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """The retained trace for ``trace_id`` (dict with the typed event
    list), or None when unknown/evicted."""
    with _LOCK:
        trace = _TRACES.get(trace_id)
    return trace.as_dict() if trace is not None else None


def trace_ids() -> List[str]:
    with _LOCK:
        return list(_TRACES)


def clear() -> None:
    with _LOCK:
        _TRACES.clear()


def export_chrome(path: Optional[str] = None) -> Dict[str, Any]:
    """Every retained trace as chrome://tracing events, merged with the
    profiler/span event buffer (one file shows request timelines next to
    the executor/kvstore lanes). Returns the trace document; writes it
    to ``path`` when given.

    Rendering: each request becomes one ``tid`` lane; consecutive hops
    become ``X`` (complete) slices named by the earlier hop — the gap
    between ``enqueue`` and ``admit`` IS the queue wait — and the final
    hop an instant event. The device lane (``tid 0``, devprof's sampled
    replays) places each slice at the HOST time its replay was launched:
    a CUDA event pair measures a duration on the card, not a point on
    the host clock, so the slice's start is the launch, its length the
    card's time.
    """
    import os as _os

    with _LOCK:
        traces = list(_TRACES.values())
    pid = _os.getpid()
    out: List[Dict[str, Any]] = []
    for tid_n, trace in enumerate(traces, 1):
        # map the monotonic clock onto the wall-anchored us timeline the
        # profiler buffer uses (span t0 * 1e6 of the same perf_counter)
        evs = trace.events()
        meta = "%s %s/%s" % (trace.trace_id, trace.server, trace.tenant)
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid_n, "args": {"name": "trace " + meta}})
        for i, ev in enumerate(evs):
            start_us = ev["t"] * 1e6
            if i + 1 < len(evs):
                dur_us = max(0.0, evs[i + 1]["t"] * 1e6 - start_us)
                out.append({"name": ev["kind"], "cat": "trace", "ph": "X",
                            "ts": start_us, "dur": dur_us, "pid": pid,
                            "tid": tid_n,
                            "args": {k: v for k, v in ev.items()
                                     if k not in ("t", "kind")}})
            else:
                # the terminal hop's WHY-fields (reason/error/tokens/
                # latency_ms) ride along like the slice branch's do
                out.append({"name": ev["kind"], "cat": "trace", "ph": "i",
                            "ts": start_us, "s": "t", "pid": pid,
                            "tid": tid_n,
                            "args": {k: v for k, v in ev.items()
                                     if k not in ("t", "kind")}})
    # merge the profiler/span buffer: spans.py feeds it the same
    # perf_counter-based microsecond timeline, so the two interleave
    with _profiler._lock:
        out.extend(list(_profiler._events))
    # device lane (tid 0): devprof's sampled dispatch slices on the same
    # timeline — a request's hop gaps line up against where the device
    # actually was. Lazy import: devprof loads after tracing in the
    # package sequence; empty when nothing was sampled.
    from . import devprof as _devprof

    out.extend(_devprof.chrome_events(pid))
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
