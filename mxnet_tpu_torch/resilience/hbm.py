"""HBM pressure governor + OOM classification: survive memory exhaustion.

The port of ``mxnet_tpu/resilience/hbm.py``: the same tiers, knobs,
hysteresis, red latch and survival routine, over the card's caching
allocator instead of PJRT's memory stats.

Two halves:

**The governor** (:class:`PressureGovernor`, one per process via
:func:`governor`). Planes register worst-case byte *bounds* (the KV
pool, the pending-prefill worst case) with
:meth:`~PressureGovernor.register_bound`; the devprof watermark ticks
feed real device samples through
:meth:`~PressureGovernor.observe_device`. Pressure = max(device in-use,
sum of registered bounds) over the capacity. On the card "in use" is
``torch.cuda.memory_allocated``: blocks the caching allocator freed stay
*reserved* for this process and are reused by it, so with
``memory_reserved`` as the numerator pressure would never fall after a
shed and the ladder would stick at red. ``memory_reserved`` and
``mem_get_info``'s free and total ride along in the watermark and in
the OOM diagnostic. Capacity is ``MXNET_HBM_CAPACITY_BYTES``, else
``mem_get_info``'s total (:meth:`~PressureGovernor.set_device_limit`,
fed by the watermark); unknown capacity (the CPU) = no tier pressure —
the governor then acts only on classified OOMs. Pressure maps to
**hysteresis-latched tiers** and a declarative degradation ladder the
planes consult at admission:

==========  ===============================================================
tier        ladder rung (consumed by the decode admission path)
==========  ===============================================================
``green``   normal admission
``yellow``  proactively shed prefix cached-LRU ref-0 pages
            (``mxnet_kvcache_pressure_sheds_total``) — warm capacity is
            the first thing traded for headroom
``orange``  shrink admission quanta (one admission per tick) and defer
            ``batch``-class tenants through the tenancy deferral
            primitive — interactive traffic is never blocked
``red``     stop new admissions, serve 503 on ``/healthz`` (with a
            ``pressure`` field), fire the ``HBMPressureBurn`` SLO alert
==========  ===============================================================

Hysteresis: a tier is entered the sample its threshold is crossed and
released only when pressure falls ``MXNET_HBM_HYSTERESIS`` below that
threshold — a ratio oscillating on a boundary cannot flap the ladder.
Every transition lands in the flight recorder as an ``hbm.pressure``
edge and moves the ``mxnet_hbm_pressure_tier`` gauge.

**OOM classification and survival.** :func:`classify` recognizes the
allocator's ``torch.OutOfMemoryError``, the JAX package's
``RESOURCE_EXHAUSTED``/allocator texts (an OOM raised inside a CUDA-graph
capture reaches the decode plane wrapped in :class:`MXNetError`, whose
text still carries "out of memory") and the chaos harness's injected
:class:`~mxnet_tpu_torch.resilience.chaos.OOMInjected`, so injected and
real OOM take the identical code path. :func:`oom_survival` is the one
survival routine every plane routes a classified OOM through: it records
a structured diagnostic (per-plane registered bounds, the watermark
history and the allocator's counters) as an ``hbm.oom`` flight-recorder
event, commits the ring to a dump, **latches the governor red** and
ticks ``mxnet_hbm_oom_total{plane}``. The red latch holds for
``MXNET_HBM_RED_HOLD`` observations before pressure is allowed to speak
again. The decode engine re-admits at a governed sequence count
(:meth:`~PressureGovernor.governed_admit`: slot shapes stay static — it
admits *fewer*, never recaptures); the training plane emits the
diagnostic and demotes to the eager plane instead of dying bare.

Knobs (the JAX package's names): ``MXNET_HBM_CAPACITY_BYTES``,
``MXNET_HBM_YELLOW`` / ``MXNET_HBM_ORANGE`` / ``MXNET_HBM_RED``,
``MXNET_HBM_HYSTERESIS``, ``MXNET_HBM_HISTORY``, ``MXNET_HBM_RED_HOLD``,
``MXNET_HBM_RED_ADMIT``.
"""
from __future__ import annotations

import collections
import logging
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Union

import torch

from .. import telemetry
from ..base import get_env

_LOG = logging.getLogger(__name__)

__all__ = ["PressureGovernor", "TIERS", "governor", "reset",
           "classify", "oom_survival", "register_bound"]

#: The ladder, least to most severe; gauge value = index.
TIERS = ("green", "yellow", "orange", "red")

_DEF_YELLOW = 0.70
_DEF_ORANGE = 0.85
_DEF_RED = 0.95
_DEF_HYSTERESIS = 0.05
_DEF_HISTORY = 64
_DEF_RED_HOLD = 2

_T_TIER = telemetry.gauge(
    "mxnet_hbm_pressure_tier",
    "HBM pressure governor tier (0=green 1=yellow 2=orange 3=red); red "
    "stops admissions and degrades /healthz")

_T_PRESSURE = telemetry.gauge(
    "mxnet_hbm_pressure_ratio",
    "governor pressure: max(device in-use, sum of plane-registered "
    "bounds) over capacity (0 when capacity is unknown)")

_T_OOMS = telemetry.counter(
    "mxnet_hbm_oom_total",
    "classified out-of-memory failures survived, per plane "
    "(injected chaos OOMs and real RESOURCE_EXHAUSTED count alike)",
    labels=("plane",))

#: substrings that mark an exception text as an allocator/HBM failure —
#: the JAX package's XLA spelling RESOURCE_EXHAUSTED, and the allocators'
#: "out of memory"/"failed to allocate" (PyTorch's CUDA allocator says
#: "CUDA out of memory"); matched case-insensitively
_OOM_PATTERNS = ("RESOURCE_EXHAUSTED", "out of memory",
                 "failed to allocate", "allocation failure",
                 "resource exhausted")


def classify(exc: BaseException) -> Optional[str]:
    """Classify an exception as an out-of-memory failure.

    Returns the OOM kind (``injected`` for the chaos harness's
    ``action=oom``, ``host`` for :class:`MemoryError`, ``device`` for
    ``torch.OutOfMemoryError`` and for an allocator text such as
    ``RESOURCE_EXHAUSTED`` or "out of memory") or ``None`` for anything
    that is not an OOM. The text match keeps an OOM recognised after a
    layer wrapped it (a failed CUDA-graph capture raises
    :class:`MXNetError` with the allocator's message).
    """
    if exc is None:
        return None
    from . import chaos

    if isinstance(exc, chaos.OOMInjected):
        return "injected"
    if isinstance(exc, torch.OutOfMemoryError):
        return "device"
    if isinstance(exc, MemoryError):
        return "host"
    text = "%s: %s" % (type(exc).__name__, exc)
    low = text.lower()
    for pat in _OOM_PATTERNS:
        if pat.lower() in low:
            return "device"
    # the bare acronym only as a whole word — "zoom"/"room" in an
    # unrelated message must not latch the governor red
    if re.search(r"\boom\b", low):
        return "device"
    return None


class PressureGovernor:
    """Hysteresis-latched HBM pressure tiers over watermarks + bounds.

    Thread-safe: planes register bounds and observe from their own
    threads; the /healthz handler and the fleet read the tier
    concurrently. All state sits behind one lock; :meth:`tier` is a
    lock-free read of the latest verdict.
    """

    def __init__(self, capacity_bytes: Optional[int] = None,
                 yellow: Optional[float] = None,
                 orange: Optional[float] = None,
                 red: Optional[float] = None,
                 hysteresis: Optional[float] = None,
                 history: Optional[int] = None,
                 red_hold: Optional[int] = None):
        if capacity_bytes is None:
            capacity_bytes = get_env("MXNET_HBM_CAPACITY_BYTES", 0, int,
                                     cache=False)
        if yellow is None:
            yellow = get_env("MXNET_HBM_YELLOW", _DEF_YELLOW, float,
                             cache=False)
        if orange is None:
            orange = get_env("MXNET_HBM_ORANGE", _DEF_ORANGE, float,
                             cache=False)
        if red is None:
            red = get_env("MXNET_HBM_RED", _DEF_RED, float, cache=False)
        if hysteresis is None:
            hysteresis = get_env("MXNET_HBM_HYSTERESIS", _DEF_HYSTERESIS,
                                 float, cache=False)
        if history is None:
            history = get_env("MXNET_HBM_HISTORY", _DEF_HISTORY, int,
                              cache=False)
        if red_hold is None:
            red_hold = get_env("MXNET_HBM_RED_HOLD", _DEF_RED_HOLD, int,
                               cache=False)
        # thresholds must ascend or the ladder is ill-formed
        self.yellow = max(0.0, float(yellow))
        self.orange = max(self.yellow, float(orange))
        self.red = max(self.orange, float(red))
        self.hysteresis = max(0.0, float(hysteresis))
        self.red_hold = max(1, int(red_hold))
        self._lock = threading.Lock()
        self._capacity = int(capacity_bytes) or None
        self._device_limit: Optional[int] = None
        self._device_used = 0
        #: plane -> worst-case bytes (int) or a zero-arg callable
        self._bounds: Dict[str, Union[int, Callable[[], int]]] = {}
        self._tier = "green"
        self._latched = False
        self._latch_reason: Optional[str] = None
        self._hold_left = 0
        self._oom_count = 0
        self._last_shed: Optional[Dict] = None
        #: (monotonic t, pressure, tier, source) — the watermark history
        #: the oom diagnostic and /debug/state hbm view carry
        self._history: "collections.deque" = collections.deque(
            maxlen=max(4, int(history)))
        #: (monotonic t, from, to, reason) — bounded transition log
        self._transitions: "collections.deque" = collections.deque(
            maxlen=64)

    # -- inputs ------------------------------------------------------------
    def register_bound(self, plane: str,
                       nbytes: Union[int, Callable[[], int]]) -> None:
        """Register (or replace) a plane's worst-case HBM bound: an int
        byte count, or a zero-arg callable re-evaluated per observation
        (exception-isolated — a broken bound reads 0, never breaks a
        sample)."""
        with self._lock:
            self._bounds[str(plane)] = nbytes

    def set_capacity(self, nbytes: Optional[int]) -> None:
        """Override the capacity bound (the bench's pressure ramp and
        tests; production reads ``MXNET_HBM_CAPACITY_BYTES`` or the
        device limit)."""
        with self._lock:
            self._capacity = int(nbytes) if nbytes else None

    def observe_device(self, stats: Dict[int, tuple],
                       source: str = "devprof") -> None:
        """Feed one :func:`~mxnet_tpu_torch.telemetry.accounting.sample_hbm`
        result (``{device_id: (in_use, peak)}``, in use being
        ``memory_allocated``) — the devprof watermark tick calls this, so
        real device usage joins the pressure signal on the card."""
        if not stats:
            return
        with self._lock:
            self._device_used = max(u for (u, _p) in stats.values())
        self.observe(source=source)

    def _bounds_bytes(self) -> Dict[str, int]:
        with self._lock:
            items = list(self._bounds.items())
        out: Dict[str, int] = {}
        for plane, b in items:
            try:
                out[plane] = int(b() if callable(b) else b)
            except Exception:  # noqa: BLE001 - a bound probe must never
                # break an observation (it may read live engine state)
                out[plane] = 0
        return out

    def capacity_bytes(self) -> Optional[int]:
        """``MXNET_HBM_CAPACITY_BYTES``, else the card's memory
        (``mem_get_info``'s total, probed once this process has touched
        a card); None on the CPU."""
        with self._lock:
            cap = self._capacity or self._device_limit
        if cap is None:
            totals = [m["total"] for m in
                      telemetry.accounting.device_memory().values()]
            if totals:
                self.set_device_limit(min(totals))
                cap = min(totals)
        return cap

    def set_device_limit(self, nbytes: Optional[int]) -> None:
        """The card's memory (``torch.cuda.mem_get_info``'s total, fed by
        the watermark); the explicit capacity knob wins over it."""
        with self._lock:
            self._device_limit = int(nbytes) if nbytes else None

    # -- evaluation --------------------------------------------------------
    def _natural_tier(self, pressure: float) -> str:
        if pressure >= self.red:
            return "red"
        if pressure >= self.orange:
            return "orange"
        if pressure >= self.yellow:
            return "yellow"
        return "green"

    def _entry_threshold(self, tier: str) -> float:
        return {"yellow": self.yellow, "orange": self.orange,
                "red": self.red}.get(tier, 0.0)

    def observe(self, source: str = "admission") -> str:
        """One governor sample: recompute pressure from the registered
        bounds + the last device reading, step the tier with hysteresis
        (and the OOM red latch), record the watermark and any edge.
        Returns the resulting tier. Cheap — pure host arithmetic over
        the bound registry; the decode admission path calls this every
        worker pass."""
        bounds = self._bounds_bytes()
        cap = self.capacity_bytes()
        with self._lock:
            used = max([self._device_used, sum(bounds.values())] or [0])
            pressure = (used / cap) if cap else 0.0
            natural = self._natural_tier(pressure)
            prev = self._tier
            if self._latched:
                # the OOM latch outranks pressure for red_hold samples;
                # after the hold, pressure speaks again (on a stat-less
                # backend with no capacity signal pressure reads 0.0, so
                # the latch releases to green after the hold — the CPU
                # CI recovery path)
                self._hold_left -= 1
                if self._hold_left > 0 or natural == "red":
                    nxt = "red"
                else:
                    self._latched = False
                    self._latch_reason = None
                    nxt = natural
            elif TIERS.index(natural) >= TIERS.index(prev):
                nxt = natural
            else:
                # stepping DOWN: release one tier at a time, and only
                # once pressure clears the current tier's entry
                # threshold by the hysteresis margin
                if pressure < self._entry_threshold(prev) \
                        - self.hysteresis:
                    nxt = TIERS[TIERS.index(prev) - 1]
                else:
                    nxt = prev
            now = time.monotonic()
            self._history.append((now, round(pressure, 4), nxt, source))
            changed = nxt != prev
            if changed:
                self._transitions.append((now, prev, nxt, source))
                self._tier = nxt
        _T_PRESSURE.set(pressure)
        _T_TIER.set(TIERS.index(nxt))
        if changed:
            from ..telemetry import flightrec

            flightrec.record("hbm.pressure", tier=nxt, prev=prev,
                             pressure=round(pressure, 4), source=source)
        return nxt

    def tier(self) -> str:
        """The latest verdict (no new sample)."""
        return self._tier

    @property
    def latched(self) -> bool:
        return self._latched

    # -- the OOM latch -----------------------------------------------------
    def latch_red(self, reason: str) -> str:
        """Force red for at least ``red_hold`` observations — the OOM
        survival path's backstop: whatever pressure claims, the
        allocation just failed."""
        with self._lock:
            prev = self._tier
            self._latched = True
            self._latch_reason = str(reason)
            self._hold_left = self.red_hold
            self._tier = "red"
            now = time.monotonic()
            self._history.append((now, -1.0, "red", "latch"))
            if prev != "red":
                self._transitions.append((now, prev, "red", reason))
        _T_TIER.set(TIERS.index("red"))
        if prev != "red":
            from ..telemetry import flightrec

            flightrec.record("hbm.pressure", tier="red", prev=prev,
                             pressure=-1.0, source="latch",
                             reason=str(reason))
        return prev

    def governed_admit(self, active: int) -> int:
        """The sequence count the decode plane re-admits at after an
        OOM: ``MXNET_HBM_RED_ADMIT`` when set, else half the count in
        flight when the allocation failed (floor 1). Slot shapes stay
        static — the engine admits fewer sequences, it never reshapes."""
        fixed = get_env("MXNET_HBM_RED_ADMIT", 0, int, cache=False)
        if fixed > 0:
            return fixed
        return max(1, int(active) // 2)

    def note_oom(self, plane: str, kind: str) -> None:
        with self._lock:
            self._oom_count += 1
        _T_OOMS.inc(plane=plane)

    def note_shed(self, pages: int, cache: str) -> None:
        """Record the ladder's last yellow-tier shed for the debug view."""
        with self._lock:
            self._last_shed = {"pages": int(pages), "cache": str(cache),
                               "t": time.monotonic()}

    # -- reporting ---------------------------------------------------------
    def oom_report(self) -> Dict:
        """The structured OOM diagnostic: tier + latch state, capacity,
        the per-plane registered HBM breakdown, the watermark history and
        the allocator's counters (allocated, reserved, and
        ``mem_get_info``'s free and total, per card; empty on the CPU)
        — what a post-mortem needs to see *which plane's* bound ate the
        headroom."""
        bounds = self._bounds_bytes()
        memory = telemetry.accounting.device_memory()
        cap = self.capacity_bytes()
        with self._lock:
            return {
                "device_memory": memory,
                "tier": self._tier,
                "latched": self._latched,
                "latch_reason": self._latch_reason,
                "oom_count": self._oom_count,
                "capacity_bytes": cap,
                "device_used_bytes": self._device_used,
                "bounds_bytes": bounds,
                "watermarks": [
                    {"t": round(t, 3), "pressure": p, "tier": tr,
                     "source": src}
                    for (t, p, tr, src) in list(self._history)[-16:]],
            }

    def debug_view(self) -> Dict:
        """The ``/debug/state`` ``hbm`` view: the report plus the
        transition log and the last yellow-tier shed."""
        out = self.oom_report()
        with self._lock:
            out["transitions"] = [
                {"t": round(t, 3), "from": a, "to": b, "reason": r}
                for (t, a, b, r) in list(self._transitions)]
            out["last_shed"] = dict(self._last_shed) \
                if self._last_shed else None
        out["thresholds"] = {"yellow": self.yellow, "orange": self.orange,
                             "red": self.red,
                             "hysteresis": self.hysteresis}
        return out

    def tiers_seen(self) -> List[str]:
        """Distinct tiers in transition order (green first implicit) —
        what the bench's tier-transition gate asserts against."""
        with self._lock:
            return [b for (_t, _a, b, _r) in self._transitions]

    def healthz_view(self) -> Dict:
        """The small dict /healthz attaches as its ``pressure`` field."""
        with self._lock:
            return {"tier": self._tier, "latched": self._latched,
                    "oom_count": self._oom_count,
                    "latch_reason": self._latch_reason}


# ---------------------------------------------------------------------------
# process-wide governor + the one OOM survival routine
# ---------------------------------------------------------------------------

_GOV_LOCK = threading.Lock()
_GOV: Optional[PressureGovernor] = None


def governor() -> PressureGovernor:
    """The process-wide governor (lazy; thresholds from the knobs). The
    first construction also registers the ``hbm`` debug view with the
    telemetry endpoint."""
    global _GOV
    with _GOV_LOCK:
        if _GOV is None:
            _GOV = PressureGovernor()
            try:
                from ..telemetry import httpd

                httpd.register_debug_view("hbm", _GOV.debug_view)
            except Exception:  # noqa: BLE001 - introspection wiring must
                # never block the governor itself
                _LOG.debug("hbm debug view registration failed",
                           exc_info=True)
        return _GOV


def reset() -> None:
    """Drop the process governor (tests re-read knobs on next use)."""
    global _GOV
    with _GOV_LOCK:
        _GOV = None
    _T_TIER.set(0)
    _T_PRESSURE.set(0.0)


def register_bound(plane: str,
                   nbytes: Union[int, Callable[[], int]]) -> None:
    governor().register_bound(plane, nbytes)


def oom_survival(plane: str, exc: BaseException, dump: bool = True) -> bool:
    """THE classified-OOM survival routine, shared by every plane (and
    by injected and real OOM alike). Returns False — untouched — for a
    non-OOM exception. For an OOM: records the structured diagnostic as
    an ``hbm.oom`` flight-recorder event, commits the ring to a dump
    (``dump=True``; the decode worker's catch-all already dumps, train
    planes want it here), latches the governor red and counts
    ``mxnet_hbm_oom_total{plane}``. The caller then runs its own
    recovery — full eviction + governed re-admission on the decode
    plane, controlled fallback on the train planes."""
    kind = classify(exc)
    if kind is None:
        return False
    gov = governor()
    gov.note_oom(plane, kind)
    from ..telemetry import flightrec

    # the diagnostic goes into the RING before the dump commits it, so
    # the dump file carries the per-plane breakdown next to the edge
    flightrec.record("hbm.oom", plane=plane, oom_kind=kind,
                     error=repr(exc), report=gov.oom_report())
    gov.latch_red("oom:%s" % plane)
    if dump:
        flightrec.dump("hbm oom at %s: %r" % (plane, exc))
    return True
