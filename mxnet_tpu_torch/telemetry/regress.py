"""Bench-regression sentinel: noise-aware verdicts over bench history.

Ported from ``mxnet_tpu/telemetry/regress.py`` (pure host logic, the same
verdicts on the same lines). Every bench line becomes a point on a
per-(metric, config-signature) trajectory and gets a verdict against that
trajectory's history, so a slowdown (or a dead round) is flagged the
moment the line is emitted: :func:`stamp_line` judges and absorbs a line;
``python -m mxnet_tpu_torch.tools.benchwatch`` replays the committed
history from the command line; ``/debug/perf`` shows the latest verdicts
live. A line measured on the card carries ``extra.device_kind`` (the
card's name), which is part of its trajectory key: it is never judged
against a TPU or CPU line of the same metric.

Verdict semantics (the part that must not cry wolf):

* **history** for a key is the prior *clean* points — ``value`` present,
  warm-up laps excluded. Fewer than ``MXNET_REGRESS_MIN_HISTORY``
  (default 3) of those → ``insufficient_history``/``no_history``:
  informational, never rc-affecting. A ``value: null`` line (dead round)
  is ``no_value`` — the *error* is the signal there, not a delta.
* with history, the center is the **median** and the noise scale is the
  **MAD** (median absolute deviation, ×1.4826 ≈ one robust sigma) — both
  survive the exact pathology this repo has (a 52 img/s point sitting
  next to nulls and partials). The regression threshold is
  ``max(MXNET_REGRESS_SIGMA × robust_sigma, MXNET_REGRESS_REL_FLOOR ×
  |median|)``: the sigma term absorbs run-to-run noise, the relative
  floor (default 5%, matching the bench's vs-baseline gates) keeps a
  zero-MAD history (identical repeated values) from flagging a 0.1%
  wobble.
* direction comes from the unit/metric name: ``ms``/latency-like keys
  regress *upward*, throughput regresses *downward*. Beyond the
  threshold the verdict is ``regression`` (``confirmed: true`` — the
  history gate already passed) or ``improvement``; inside it, ``ok``.

Config signatures keep apples with apples: the key hashes the metric
name, unit and the config-describing ``extra`` keys (batch, device_kind,
slots, …) — NOT the measured values — so a batch-size change starts a
new trajectory instead of "regressing" the old one.

Everything here is stdlib-only; ingestion
never raises on malformed files (a corrupt history file must not take
the bench down — it just contributes no points).
"""
from __future__ import annotations

import collections
import glob
import hashlib
import json
import os
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..base import get_env

__all__ = ["config_signature", "direction", "TrajectoryStore",
           "iter_bench_lines", "snapshot_rows", "default_paths",
           "build_store", "default_store", "stamp_line",
           "recent_verdicts", "reset"]

#: ``extra`` keys that describe the *configuration* of a bench line (not
#: its measurements) — part of the trajectory key, so runs are only
#: compared against runs of the same shape.
_CONFIG_KEYS = ("batch", "device_kind", "slots", "dp", "chips", "level",
                "mode", "dtype", "steps_per_call", "requests", "waves")

#: substrings marking a metric as lower-is-better even without a time unit
_LOWER_HINTS = ("latency", "ttft", "tpot", "duration", "p50", "p90", "p99",
                "seconds", "overhead")


def config_signature(line: Dict[str, Any]) -> str:
    """Stable 12-hex signature of a bench line's configuration."""
    extra = line.get("extra") or {}
    cfg: Dict[str, Any] = {"metric": line.get("metric"),
                           "unit": line.get("unit")}
    if isinstance(extra, dict):
        for key in _CONFIG_KEYS:
            if key in extra:
                cfg[key] = extra[key]
    blob = json.dumps(cfg, sort_keys=True, default=repr)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def direction(line: Dict[str, Any]) -> str:
    """``"higher"`` or ``"lower"`` — which way is better for this line."""
    unit = str(line.get("unit") or "").lower()
    metric = str(line.get("metric") or "").lower()
    if unit.endswith("ms") or unit in ("s", "sec", "seconds", "ns", "us"):
        return "lower"
    if any(h in metric for h in _LOWER_HINTS):
        return "lower"
    return "higher"


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class TrajectoryStore:
    """Bounded per-(metric, config-signature) history with verdicts."""

    def __init__(self, max_points: Optional[int] = None):
        self._lock = threading.Lock()
        self._max = max_points if max_points is not None else get_env(
            "MXNET_REGRESS_MAX_POINTS", 64, int, cache=False)
        self._hist: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}

    @staticmethod
    def key(line: Dict[str, Any]) -> Optional[Tuple[str, str]]:
        metric = line.get("metric")
        if not metric or not isinstance(line, dict):
            return None
        return (str(metric), config_signature(line))

    def add(self, line: Dict[str, Any], source: str = "",
            warmup: bool = False) -> Optional[Tuple[str, str]]:
        """Append one bench line as a trajectory point (``value: null``
        points are kept — they carry the dead-round error — but never
        count as history)."""
        key = self.key(line)
        if key is None:
            return None
        value = line.get("value")
        extra = line.get("extra")
        if isinstance(extra, dict) and extra.get("warmup"):
            warmup = True
        point = {"value": float(value) if isinstance(value, (int, float))
                 else None,
                 "warmup": bool(warmup),
                 "error": line.get("error"), "source": source}
        with self._lock:
            hist = self._hist.setdefault(key, [])
            hist.append(point)
            if len(hist) > self._max:
                del hist[:len(hist) - self._max]
        return key

    def history(self, key: Tuple[str, str]) -> List[float]:
        """The key's clean history: valued, non-warmup points, oldest
        first."""
        with self._lock:
            pts = list(self._hist.get(key, ()))
        return [p["value"] for p in pts
                if p["value"] is not None and not p["warmup"]]

    def keys(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._hist)

    def verdict(self, line: Dict[str, Any]) -> Dict[str, Any]:
        """Judge ``line`` against the history accumulated so far (call
        BEFORE :meth:`add`-ing the line itself)."""
        key = self.key(line)
        doc: Dict[str, Any] = {
            "metric": line.get("metric"), "unit": line.get("unit"),
            "config": key[1] if key else None,
            "value": line.get("value"), "confirmed": False,
        }
        if key is None:
            doc["verdict"] = "unkeyed"
            return doc
        hist = self.history(key)
        doc["history_points"] = len(hist)
        doc["direction"] = direction(line)
        value = line.get("value")
        if not isinstance(value, (int, float)):
            # a dead round: the error on the line is the finding, a
            # delta verdict would be fiction
            doc["verdict"] = "no_value"
            if line.get("error"):
                doc["error"] = str(line["error"])[:200]
            return doc
        min_hist = get_env("MXNET_REGRESS_MIN_HISTORY", 3, int, cache=False)
        if len(hist) < max(1, min_hist):
            doc["verdict"] = "no_history" if not hist \
                else "insufficient_history"
            return doc
        med = _median(hist)
        mad = _median([abs(v - med) for v in hist])
        sigma = 1.4826 * mad
        k = get_env("MXNET_REGRESS_SIGMA", 4.0, float, cache=False)
        floor = get_env("MXNET_REGRESS_REL_FLOOR", 0.05, float, cache=False)
        threshold = max(k * sigma, floor * abs(med))
        delta = float(value) - med
        worse = -delta if doc["direction"] == "higher" else delta
        doc.update(median=round(med, 6), mad=round(mad, 6),
                   threshold=round(threshold, 6), delta=round(delta, 6),
                   delta_pct=round(delta / med, 4) if med else None)
        if threshold <= 0:
            doc["verdict"] = "ok"
        elif worse > threshold:
            doc["verdict"] = "regression"
            doc["confirmed"] = True
        elif -worse > threshold:
            doc["verdict"] = "improvement"
        else:
            doc["verdict"] = "ok"
        return doc


# -- ingestion ---------------------------------------------------------------

def _maybe_bench_line(obj) -> Optional[Dict[str, Any]]:
    return obj if isinstance(obj, dict) and obj.get("metric") else None


def _lines_from_text(text: str) -> Iterable[Dict[str, Any]]:
    """Bench JSON lines embedded in arbitrary output (the bench harness's
    ``tail`` capture mixes them with tracebacks and log noise)."""
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        try:
            obj = json.loads(raw)
        except ValueError:
            continue
        line = _maybe_bench_line(obj)
        if line is not None:
            yield line


def snapshot_rows(snap: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Derive trajectory points from a telemetry ``snapshot()`` document
    (one Emitter JSONL line): per-site device-time p50s and the decode
    throughput gauge become synthetic bench lines so the sentinel also
    watches long-running serving processes, not only bench runs."""
    rows: List[Dict[str, Any]] = []
    mets = snap.get("metrics")
    if not isinstance(mets, dict):
        return rows
    dt = mets.get("mxnet_device_time_ms") or {}
    for series in dt.get("series", ()):
        site = (series.get("labels") or {}).get("site")
        if site and series.get("p50") is not None and series.get("count"):
            rows.append({"metric": "devprof p50 device ms [%s]" % site,
                         "value": series["p50"], "unit": "ms"})
    tok = mets.get("mxnet_tokens_per_device_second") or {}
    for series in tok.get("series", ()):
        server = (series.get("labels") or {}).get("server")
        if server and series.get("value"):
            rows.append({"metric": "devprof tokens/device-s [%s]" % server,
                         "value": series["value"], "unit": "tok/s"})
    return rows


def iter_bench_lines(path: str) -> Iterable[Dict[str, Any]]:
    """Yield every trajectory point a history file contributes. Handles
    all three committed shapes: harness wrappers (``{"n", "rc", "tail",
    "parsed"}``), raw bench lines, and JSONL (bench lines and/or
    telemetry snapshots). Never raises — unreadable files contribute
    nothing."""
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            text = fh.read()
    except OSError:
        return
    text = text.strip()
    if not text:
        return
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        line = _maybe_bench_line(doc)
        if line is not None:  # a raw bench line (BENCH_CPU_QUICK shape)
            yield line
            return
        if "parsed" in doc or "tail" in doc:  # harness wrapper
            parsed = _maybe_bench_line(doc.get("parsed"))
            if parsed is not None:
                yield parsed
            elif isinstance(doc.get("tail"), str):
                # dead wrapper: the tail may still carry emitted lines
                for line in _lines_from_text(doc["tail"]):
                    yield line
            return
    if isinstance(doc, list):
        for obj in doc:
            line = _maybe_bench_line(obj)
            if line is not None:
                yield line
        return
    # not one JSON document: treat as JSONL (emitter output / bench logs)
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        try:
            obj = json.loads(raw)
        except ValueError:
            continue
        line = _maybe_bench_line(obj)
        if line is not None:
            yield line
        elif isinstance(obj, dict) and "metrics" in obj:
            for row in snapshot_rows(obj):
                yield row


def _round_key(path: str) -> Tuple[int, str]:
    """Sort BENCH files chronologically: rNN rounds in order, everything
    else (one-off captures) ahead of them by name."""
    base = os.path.basename(path)
    m = re.search(r"_r(\d+)\.json$", base)
    return (int(m.group(1)) if m else -1, base)


def default_paths(root: Optional[str] = None) -> List[str]:
    """The committed history next to bench.py: every ``BENCH_*.json``
    (round order) plus the Emitter JSONL when it exists."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    paths = sorted(glob.glob(os.path.join(root, "BENCH_*.json")),
                   key=_round_key)
    emit = get_env("MXNET_TELEMETRY_EMIT_PATH", "telemetry.jsonl", str,
                   cache=False)
    if not os.path.isabs(emit):
        emit = os.path.join(root, emit)
    if os.path.exists(emit):
        paths.append(emit)
    return paths


def build_store(paths: Iterable[str],
                store: Optional[TrajectoryStore] = None) -> TrajectoryStore:
    store = store or TrajectoryStore()
    for path in paths:
        for line in iter_bench_lines(path):
            store.add(line, source=os.path.basename(path))
    return store


_STORE_LOCK = threading.Lock()
_DEFAULT_STORE: Optional[TrajectoryStore] = None

#: latest stamped verdicts for /debug/perf (append GIL-atomic)
_RECENT: "collections.deque" = collections.deque(maxlen=32)


def default_store(refresh: bool = False) -> TrajectoryStore:
    """The memoized history store over :func:`default_paths` — built on
    first use so importing telemetry never reads bench files."""
    global _DEFAULT_STORE
    with _STORE_LOCK:
        if _DEFAULT_STORE is None or refresh:
            _DEFAULT_STORE = build_store(default_paths())
        return _DEFAULT_STORE


def stamp_line(line: Dict[str, Any],
               store: Optional[TrajectoryStore] = None) -> Dict[str, Any]:
    """Verdict ``line`` against history, then absorb it as the newest
    point. The returned verdict is what bench.py attaches as
    ``perf_verdict``."""
    store = store if store is not None else default_store()
    verdict = store.verdict(line)
    store.add(line, source="live")
    _RECENT.append(verdict)
    return verdict


def recent_verdicts() -> List[Dict[str, Any]]:
    for _ in range(16):  # deque iteration can race appends
        try:
            return list(_RECENT)
        except RuntimeError:
            continue
    return []


def reset() -> None:
    """Drop the memoized store and recent verdicts (test isolation)."""
    global _DEFAULT_STORE
    with _STORE_LOCK:
        _DEFAULT_STORE = None
    _RECENT.clear()
