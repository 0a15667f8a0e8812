"""Profiler: chrome-trace events + aggregate per-op tables + device traces.

The port of ``mxnet_tpu/profiler.py`` (reference ``src/profiler/`` and
``python/mxnet/profiler.py``: set_config/set_state/dump/dumps,
pause/resume, Domain/Task/Frame/Counter/Marker/Event).

Two sources, as in the JAX package:

* framework events (telemetry spans and request traces, user
  Tasks/Frames/Counters/Markers, ``timed_op``/``profiled`` regions) are
  timestamped into an in-process buffer and emitted as chrome://tracing
  JSON by :func:`dump`, with aggregate min/max/avg tables from
  :func:`dumps`;
* the device timeline comes from ``torch.profiler`` — when
  ``profile_all``/``profile_symbolic`` is set, ``set_state('run')`` also
  starts a ``torch.profiler`` session (CPU activity, plus CUDA where a
  card is present) and ``set_state('stop')`` exports its chrome trace
  beside ``filename`` as ``<filename>.torchtrace.json``, the counterpart
  of the JAX package's ``<filename>.jaxtrace/``.

Host-side timing wraps dispatch only (CUDA launches are asynchronous);
the device truth lives in the ``torch.profiler`` trace.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .base import MXNetError

__all__ = ["set_config", "set_state", "pause", "resume", "dump", "dumps",
           "profiler_set_config", "profiler_set_state",
           "Domain", "Task", "Frame", "Counter", "Marker"]

_lock = threading.Lock()
_config: Dict[str, Any] = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": True,
    "aggregate_stats": False,
}
_events: List[Dict[str, Any]] = []
_agg: Dict[str, List[float]] = {}
_state = "stop"
_paused = False
_device_trace = None  # the live torch.profiler session, if any

# fast-path flag read by the eager dispatch hook; avoids any work when off
ENABLED = False

_TELEMETRY = None


def _telemetry():
    """The telemetry package, lazily: telemetry.spans imports this module,
    so the reverse edge must resolve at call time, not import time."""
    global _TELEMETRY
    if _TELEMETRY is None:
        from . import telemetry
        _TELEMETRY = telemetry
    return _TELEMETRY


def _now_us() -> float:
    return time.perf_counter() * 1e6


def set_config(**kwargs):
    """Configure the profiler (reference profiler.py:33 set_config /
    MXSetProcessProfilerConfig). Unknown keys are rejected."""
    for k, v in kwargs.items():
        if k not in _config and k not in ("profile_process",):
            raise MXNetError("profiler.set_config: unknown option %r" % k)
        if k != "profile_process":
            _config[k] = v


def set_state(state="stop", profile_process="worker"):
    """Start/stop profiling (reference profiler.py set_state).

    ``set_state('run')`` while already running is a no-op that warns: the
    session keeps its original event buffer AND the device trace keeps
    recording for the filename configured at start — a
    ``set_config(filename=...)`` between two run calls does NOT rotate
    the trace. Stop first, then run, to restart under a new filename.
    """
    global _state, ENABLED
    if state not in ("run", "stop"):
        raise MXNetError("profiler state must be 'run' or 'stop'")
    with _lock:
        if state == "run" and _state == "run":
            import warnings

            warnings.warn(
                "profiler.set_state('run') while already running is a "
                "no-op: the active session (and any device trace chosen "
                "at start) continues; call set_state('stop') first to "
                "restart with the current filename", stacklevel=2)
            return
        if state == "run" and _state != "run":
            _state = "run"
            ENABLED = not _paused
            # each run starts a fresh session: without this, periodic
            # dump() calls re-emit every event since process start and the
            # buffer grows unboundedly
            _events.clear()
            _agg.clear()
            if _config["profile_all"] or _config["profile_symbolic"]:
                _start_device_trace()
        elif state == "stop" and _state == "run":
            _state = "stop"
            ENABLED = False
            _stop_device_trace()


def _start_device_trace():
    """Start a ``torch.profiler`` session for this run (CPU activity,
    plus CUDA where a card is present)."""
    global _device_trace
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.__enter__()
    except RuntimeError:  # another profiler session is already live
        import logging

        logging.getLogger("mxnet_tpu_torch.profiler").warning(
            "torch.profiler session could not start (another is live?); "
            "this run has no device trace", exc_info=True)
        return
    _device_trace = prof


def _stop_device_trace():
    """Stop the run's ``torch.profiler`` session and write its chrome
    trace to ``<filename>.torchtrace.json``."""
    global _device_trace
    prof, _device_trace = _device_trace, None
    if prof is None:
        return
    try:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(_config["filename"] + ".torchtrace.json")
    except (RuntimeError, OSError) as exc:  # stop is best-effort
        # a failed stop loses the device timeline but must not take
        # the run down with it; say so instead of hiding it
        import logging

        logging.getLogger("mxnet_tpu_torch.profiler").warning(
            "torch.profiler stop/export failed: %s (device trace for "
            "this session may be missing or truncated)", exc)


def pause(profile_process="worker"):
    """Suspend event collection without ending the session (reference
    profiler.py pause). Holds ``_lock``: pause/resume race ``set_state``
    from other threads, and an unlocked write could otherwise interleave
    with a concurrent stop->run transition and leave ENABLED stale-on for
    a stopped session (or stale-off for a running one)."""
    global _paused, ENABLED
    with _lock:
        _paused = True
        ENABLED = False


def resume(profile_process="worker"):
    """Re-enable collection for the active session (no-op when stopped)."""
    global _paused, ENABLED
    with _lock:
        _paused = False
        ENABLED = _state == "run"


def record_event(name: str, category: str, start_us: float, dur_us: float):
    """Append one complete ('ph: X') event; aggregates ride along."""
    if not ENABLED:
        return
    with _lock:
        _events.append({"name": name, "cat": category, "ph": "X",
                        "ts": start_us, "dur": dur_us, "pid": os.getpid(),
                        "tid": threading.get_ident() % 100000})
        _agg.setdefault("%s::%s" % (category, name), []).append(dur_us)


class _timed:
    """Context manager timing a region into the event buffer."""

    def __init__(self, name, category):
        self.name, self.category = name, category

    def __enter__(self):
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        record_event(self.name, self.category, self.t0, _now_us() - self.t0)


def timed_op(name):
    """Hook used by the eager dispatch path (category 'operator')."""
    return _timed(name, "operator")


def timed_exec(name):
    """Hook used by executor forward/backward (category 'executor')."""
    return _timed(name, "executor")


def profiled(category, label):
    """Decorator instrumenting a function as a profiler region. ``label``
    is either a string or a callable over the wrapped function's arguments
    (e.g. the op name). Zero work when profiling is off."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ENABLED:
                return fn(*args, **kwargs)
            lbl = label(*args, **kwargs) if callable(label) else label
            with _timed(lbl, category):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def dump(finished=True, profile_process="worker"):
    """Write collected events as chrome://tracing JSON to the configured
    filename (reference profiler.py dump → profiler.h:437 emitter)."""
    if finished:
        set_state("stop")
    with _lock:
        doc = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
        with open(_config["filename"], "w") as f:
            json.dump(doc, f)


def dumps(reset=False):
    """Aggregate per-op summary table string (reference profiler.py dumps →
    aggregate_stats.cc), sorted by total time."""
    with _lock:
        rows = []
        for key, durs in _agg.items():
            rows.append((sum(durs), key, len(durs), min(durs), max(durs)))
        rows.sort(reverse=True)
        lines = ["%-40s %8s %12s %12s %12s %12s" %
                 ("Name", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                  "Avg(ms)")]
        for total, key, n, mn, mx in rows:
            lines.append("%-40s %8d %12.3f %12.3f %12.3f %12.3f" %
                         (key[:40], n, total / 1e3, mn / 1e3, mx / 1e3,
                          total / n / 1e3))
        if reset:
            _agg.clear()
        return "\n".join(lines)


# legacy aliases kept by the reference module
profiler_set_config = set_config
profiler_set_state = set_state


# ---------------------------------------------------------------------------
# user-defined profiling objects (reference profiler.py:198-)
# ---------------------------------------------------------------------------


class Domain:
    """Grouping namespace for user events (reference profiler.py Domain)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)

    def __str__(self):
        return self.name


class _Span:
    """start()/stop() duration event (Task and Frame semantics)."""

    _category = "task"

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = _now_us()

    def stop(self):
        if self._t0 is None:
            raise MXNetError("%s %r stopped before start"
                             % (type(self).__name__, self.name))
        record_event("%s::%s" % (self.domain, self.name), self._category,
                     self._t0, _now_us() - self._t0)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_Span):
    _category = "task"


class Frame(_Span):
    _category = "frame"


class Counter:
    """Numeric counter emitting 'C' events (reference profiler.py Counter).

    Value updates are guarded by a per-counter lock: serving and data
    pipelines increment counters from many threads, and an unguarded
    read-modify-write in ``increment`` loses updates under contention.
    """

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self._value = 0
        self._vlock = threading.Lock()
        if value is not None:
            self.set_value(value)

    def _emit(self, value):
        if ENABLED:
            with _lock:
                _events.append({
                    "name": "%s::%s" % (self.domain, self.name),
                    "cat": "counter", "ph": "C", "ts": _now_us(),
                    "pid": os.getpid(),
                    "args": {self.name: value}})
        # registry bridge: the chrome-trace counter lane and the scrapable
        # mxnet_profiler_counter gauge are fed by the same update (the
        # gauge records regardless of whether a profiling session is live)
        _telemetry().PROFILER_COUNTER.set(value, domain=str(self.domain),
                                          counter=self.name)

    def set_value(self, value):
        with self._vlock:
            self._value = value
            # emit under the value lock so concurrent updates cannot land
            # in the event buffer out of order (the counter lane would end
            # on a stale value); _vlock -> _lock nests only here
            self._emit(value)

    def increment(self, delta=1):
        with self._vlock:
            self._value += delta
            self._emit(self._value)

    def decrement(self, delta=1):
        self.increment(-delta)


class Marker:
    """Instant event (reference profiler.py Marker)."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        if ENABLED:
            with _lock:
                _events.append({
                    "name": "%s::%s" % (self.domain, self.name),
                    "cat": "marker", "ph": "i", "ts": _now_us(),
                    "pid": os.getpid(), "s": scope[0]})


def dump_profile():
    """Deprecated alias of dump() (reference profiler.py:143)."""
    import warnings

    warnings.warn("profiler.dump_profile() is deprecated. "
                  "Please use profiler.dump() instead")
    dump()


def set_kvstore_handle(handle):
    """Kept for API parity (reference profiler.py:29 wires server-side
    profiling through the kvstore command channel; this build's kvstore is
    in-process, so its ops are already profiled by the same collector)."""
    global profiler_kvstore_handle
    profiler_kvstore_handle = handle


profiler_kvstore_handle = None


class Event(_Span):
    """User-defined duration event (reference profiler.py:341): a plain
    named start()/stop() span without a Domain."""

    def __init__(self, name):
        super().__init__("event", name)
