"""Device-time attribution: where the milliseconds actually went.

The port of ``mxnet_tpu/telemetry/devprof.py``. The accounting plane
counts captures per site and the tracing plane shows *request*
timelines — but neither says how much of a decode tick was device
compute versus host bookkeeping, nor which dispatch site owns the device
time. The port has no ``jit_call``; its dispatch sites are the decode
engine's graph replays (``DecodeEngine._replay``), which ask this module
for a probe under the JAX site names ``serving.decode_step``,
``serving.decode_prefill``, ``serving.decode_prefill_chunk`` and
``serving.decode_cow``:

* ``mxnet_device_time_ms{site=}`` / ``mxnet_device_seconds_total{site=}``
  — the sampled device duration of each site's replays. On the card a
  probe records two ``torch.cuda.Event(enable_timing=True)`` on the
  replay's stream around ``graph.replay()`` and reads ``elapsed_time``
  once, at the tick's end (:func:`note_decode_tick`), and only for a
  sampled tick; a dispatch sampled outside a tick scope reads it at
  once. The pair spans the replay's kernels and the gaps between them.
  On the CPU, which has no events, the probe times the call's wall, as
  the JAX package does where it has no ``block_until_ready``. A first
  run (the capture) is never timed: its cost is compile cost,
  attributed in ``mxnet_compile_seconds_total``;
* ``mxnet_decode_tick_ms{phase=prefill|step|host_gap}`` — the decode
  engine's per-tick breakdown, where host_gap = tick wall time minus
  sampled device time (the scheduler/bookkeeping/fetch budget);
* ``mxnet_train_step_ms{phase=device|host_gap}`` — the training step's
  equivalent (:func:`note_train_step`);
* ``mxnet_host_gap_ratio{plane=}``, ``mxnet_tokens_per_device_second`` and
  ``mxnet_mfu`` — the derived efficiency gauges (MFU needs the model's
  per-step FLOPs declared via :func:`declare_flops`);
* a bounded ring of device slices merged into
  :func:`~mxnet_tpu_torch.telemetry.tracing.export_chrome` as a
  ``device`` lane: each slice starts at the host time of its launch and
  lasts the card's measured time;
* periodic HBM watermarks (:func:`hbm_watermark`) into the flight
  recorder and the pressure governor — the Emitter thread and the decode
  tick loop both call it.

Cost discipline, the tracing module's ladder:

1. ``MXNET_TELEMETRY=0`` wins: no probe is installed;
2. ``MXNET_DEVPROF_SAMPLE`` (0.0–1.0, default 0) decides whether the
   plane is active at all. Inactive, the per-replay cost is ONE
   module-global pointer check (the hook is ``None``) and no event is
   recorded;
3. active, the sampling decision is drawn once per decode tick / train
   step (so a timed tick's breakdown is coherent: every replay in it is
   measured) and per dispatch elsewhere.
"""
from __future__ import annotations

import collections
import logging
import random as _random
import threading
import time
from typing import Any, Dict, List, Optional

from ..base import get_env
from . import accounting as _accounting
from . import flightrec as _flightrec
from . import registry as _registry

_LOG = logging.getLogger(__name__)

__all__ = ["DEVICE_TIME_MS", "DEVICE_SECONDS", "DECODE_TICK_MS",
           "TRAIN_STEP_MS", "HOST_GAP_RATIO", "TOKENS_PER_DEVICE_S", "MFU",
           "set_sample", "sample_rate", "refresh", "active",
           "tick_begin", "tick_device_ms", "tick_end",
           "note_decode_tick", "note_train_step", "declare_flops",
           "hbm_watermark", "chrome_events", "summary", "reset"]

DEVICE_TIME_MS = _registry.histogram(
    "mxnet_device_time_ms",
    "sampled device duration per dispatch site: a CUDA event pair around "
    "the graph replay on the card, the call's wall on the CPU "
    "(MXNET_DEVPROF_SAMPLE-gated; captures excluded — compile cost lands "
    "in mxnet_compile_seconds_total)",
    labels=("site",))

DEVICE_SECONDS = _registry.counter(
    "mxnet_device_seconds_total",
    "cumulative sampled device seconds per dispatch site (top-N by this "
    "counter = where the device time goes)",
    labels=("site",))

DECODE_TICK_MS = _registry.histogram(
    "mxnet_decode_tick_ms",
    "per-tick decode-plane time split (timed ticks only): prefill = "
    "prefill/chunk/CoW dispatches, step = the batched decode step, "
    "host_gap = tick wall minus sampled device time (scheduling, "
    "admission, token fetch, bookkeeping)",
    labels=("phase",))

TRAIN_STEP_MS = _registry.histogram(
    "mxnet_train_step_ms",
    "per-step graph-plane training time split (timed steps only): "
    "device = sampled device time, host_gap = step wall minus device",
    labels=("phase",))

HOST_GAP_RATIO = _registry.gauge(
    "mxnet_host_gap_ratio",
    "1 - (sampled device time / wall time), cumulative over a plane's "
    "timed ticks/steps — the fraction of the plane's wall clock the "
    "device sat idle for",
    labels=("plane",))

TOKENS_PER_DEVICE_S = _registry.gauge(
    "mxnet_tokens_per_device_second",
    "ACCEPTED decode tokens committed per sampled device-second (timed "
    "ticks only) — the device-normalized throughput the autotuner "
    "optimizes; rejected speculative draft rows cost device time but "
    "commit nothing, so they lower this gauge instead of inflating it",
    labels=("server",))

MFU = _registry.gauge(
    "mxnet_mfu",
    "model FLOPs utilization over the timed training steps: "
    "declared_flops_per_step * steps / device_seconds / peak_flops "
    "(requires declare_flops; unset otherwise)",
    labels=("plane",))

_DEFAULT_SLICES = 2048

#: test/bench override of MXNET_DEVPROF_SAMPLE; None = read the env knob.
_SAMPLE_OVERRIDE: List[Optional[float]] = [None]

#: Whether the plane is collecting (sample rate > 0). Module-global bare
#: read — the same discipline as registry.ENABLED.
ACTIVE = False

_RATE = [0.0]
_tls = threading.local()

#: device slices for the chrome lane: (site, t0_perf_counter_s, dur_ms).
#: deque.append is GIL-atomic (the flightrec discipline) — no lock on the
#: record path; readers snapshot with retry.
_SLICES: "collections.deque" = collections.deque(
    maxlen=max(16, get_env("MXNET_DEVPROF_SLICES", _DEFAULT_SLICES, int,
                           cache=False)))

_TOTALS_LOCK = threading.Lock()
#: plane -> [wall_ms, device_ms, units] (units: tokens for decode,
#: steps for train); only touched on TIMED ticks/steps.
_TOTALS: Dict[str, List[float]] = {}

#: (flops_per_step, peak_flops_per_second) — declared by the embedder
#: (bench/training script); the framework cannot derive model FLOPs.
_FLOPS: List[Optional[float]] = [None, None]

_TIMED_TICKS = [0]


def sample_rate() -> float:
    """The effective sampling rate (override, else the env knob)."""
    ov = _SAMPLE_OVERRIDE[0]
    if ov is not None:
        return ov
    return get_env("MXNET_DEVPROF_SAMPLE", 0.0, float, cache=False)


def set_sample(rate: Optional[float]) -> None:
    """Override ``MXNET_DEVPROF_SAMPLE`` in-process (None = back to the
    env knob) and (de)activate the plane, so one process can run the
    same soak sampled at 1.0 and off."""
    _SAMPLE_OVERRIDE[0] = None if rate is None else float(rate)
    refresh()


def refresh() -> None:
    """Re-read the sampling knob and install/uninstall the dispatch
    probe. Inactive means ``accounting._DEVPROF_HOOK is None`` — the
    one-pointer-check off path."""
    global ACTIVE
    rate = max(0.0, min(1.0, float(sample_rate())))
    _RATE[0] = rate
    ACTIVE = rate > 0.0
    _accounting._DEVPROF_HOOK = _probe if ACTIVE else None


def active() -> bool:
    return ACTIVE


def declare_flops(flops_per_step: Optional[float],
                  peak_flops_per_s: Optional[float]) -> None:
    """Declare the model's per-step FLOPs and the chip's peak FLOP/s so
    timed training steps derive the ``mxnet_mfu`` gauge."""
    _FLOPS[0] = float(flops_per_step) if flops_per_step else None
    _FLOPS[1] = float(peak_flops_per_s) if peak_flops_per_s else None


class _Probe:
    """One sampled dispatch: its site, the host time of its launch and,
    on the card, the CUDA event pair recorded on the launching stream
    around it (on the CPU, the wall from :meth:`start` to :meth:`stop`).
    """

    __slots__ = ("site", "t0", "ms", "_ev0", "_ev1")

    def __init__(self, site: str, device):
        self.site = site
        self.ms: Optional[float] = None
        self._ev0 = self._ev1 = None
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch

            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev1 = torch.cuda.Event(enable_timing=True)
        self.t0 = time.perf_counter()
        if self._ev0 is not None:
            self._ev0.record()

    def stop(self) -> None:
        """End of the dispatch: record the closing event (card), or take
        the wall (CPU). Outside a tick scope the reading is taken at
        once; inside one it waits for the scope's end."""
        if self._ev1 is not None:
            self._ev1.record()
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        pending = getattr(_tls, "pending", None)
        if pending is not None:
            pending.append(self)
        else:
            _attribute(self)

    def read(self) -> float:
        """The probe's device ms: the CUDA events' ``elapsed_time`` (once,
        after the closing event completed) or the CPU wall."""
        if self.ms is None:
            self._ev1.synchronize()
            self.ms = float(self._ev0.elapsed_time(self._ev1))
        return self.ms


def _probe(site: str, device) -> Optional[_Probe]:
    """The dispatch hook: installed only while ACTIVE. Decides the
    per-dispatch sample (unless a tick scope already decided) and returns
    a started :class:`_Probe`, or None for an unsampled dispatch (and
    always with ``MXNET_TELEMETRY=0``)."""
    if not _registry.ENABLED:
        return None
    force = getattr(_tls, "force", None)
    if force is None:
        rate = _RATE[0]
        if rate < 1.0 and _random.random() >= rate:
            return None
    elif not force:
        return None
    return _Probe(site, device)


def _attribute(probe: _Probe) -> float:
    """Book one read probe into the site series, the chrome lane and the
    open tick's accumulator."""
    ms = probe.read()
    DEVICE_TIME_MS.observe(ms, site=probe.site)
    DEVICE_SECONDS.inc(ms / 1e3, site=probe.site)
    _SLICES.append((probe.site, probe.t0, ms))
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc[probe.site] = acc.get(probe.site, 0.0) + ms
    return ms


# -- tick/step scopes (thread-local: the engine worker / training loop
# -- thread performs every dispatch of its own tick) ------------------------

def tick_begin() -> bool:
    """Open a tick/step scope on the calling thread. Draws the sampling
    decision ONCE for the whole scope so a timed tick's breakdown is
    coherent (every dispatch in it measured, or none). Returns whether
    this scope is being timed; one module-global read when inactive."""
    if not ACTIVE:
        return False
    rate = _RATE[0]
    on = rate >= 1.0 or _random.random() < rate
    _tls.force = on
    _tls.acc = {} if on else None
    _tls.pending = [] if on else None
    return on


def tick_device_ms() -> Dict[str, float]:
    """Per-site sampled device ms accumulated since ``tick_begin``: the
    scope's pending probes are read here, once (on the card this waits
    for the scope's last closing event)."""
    pending = getattr(_tls, "pending", None)
    if pending:
        _tls.pending = []
        for probe in pending:
            _attribute(probe)
    return dict(getattr(_tls, "acc", None) or {})


def tick_end() -> None:
    """Close the scope without reading it: its pending probes are
    dropped (the eviction path after a failed tick)."""
    _tls.force = None
    _tls.acc = None
    _tls.pending = None


def _decode_phase(site: str) -> str:
    return "prefill" if ("prefill" in site or site.endswith("cow")) \
        else "step"


def note_decode_tick(server: str, wall_ms: float, tokens: int = 0) -> None:
    """Close a timed decode tick: split its sampled device time into
    prefill vs step, derive host_gap = wall - device, and refresh the
    plane's ratio/throughput gauges. ``tokens`` is the tick's COMMITTED
    output-token count (the engine passes its tokens_total delta, which
    under speculative decoding counts accepted tokens only — never the
    proposed draft rows), so tokens-per-device-second stays an honest
    goodput number. Also takes the periodic HBM watermark (every
    MXNET_DEVPROF_HBM_TICKS timed ticks)."""
    acc = tick_device_ms()
    tick_end()
    prefill = step = 0.0
    for site, ms in acc.items():
        if _decode_phase(site) == "prefill":
            prefill += ms
        else:
            step += ms
    device = prefill + step
    gap = max(0.0, wall_ms - device)
    if prefill:
        DECODE_TICK_MS.observe(prefill, phase="prefill")
    if step:
        DECODE_TICK_MS.observe(step, phase="step")
    DECODE_TICK_MS.observe(gap, phase="host_gap")
    with _TOTALS_LOCK:
        t = _TOTALS.setdefault("decode", [0.0, 0.0, 0.0])
        t[0] += wall_ms
        t[1] += device
        t[2] += tokens
        wall_tot, dev_tot, tok_tot = t
    if wall_tot > 0:
        HOST_GAP_RATIO.set(max(0.0, 1.0 - dev_tot / wall_tot),
                           plane="decode")
    if dev_tot > 0:
        TOKENS_PER_DEVICE_S.set(tok_tot / (dev_tot / 1e3), server=server)
    _TIMED_TICKS[0] += 1
    every = get_env("MXNET_DEVPROF_HBM_TICKS", 64, int, cache=False)
    if every > 0 and _TIMED_TICKS[0] % every == 0:
        hbm_watermark("decode")


def note_train_step(wall_ms: float, plane: str = "train") -> None:
    """Close a timed training step: device vs host_gap split, the
    plane's host-gap ratio, and MFU when FLOPs were declared."""
    acc = tick_device_ms()
    tick_end()
    device = sum(acc.values())
    gap = max(0.0, wall_ms - device)
    TRAIN_STEP_MS.observe(device, phase="device")
    TRAIN_STEP_MS.observe(gap, phase="host_gap")
    with _TOTALS_LOCK:
        t = _TOTALS.setdefault(plane, [0.0, 0.0, 0.0])
        t[0] += wall_ms
        t[1] += device
        t[2] += 1
        wall_tot, dev_tot, steps = t
    if wall_tot > 0:
        HOST_GAP_RATIO.set(max(0.0, 1.0 - dev_tot / wall_tot), plane=plane)
    flops, peak = _FLOPS
    if flops and peak and dev_tot > 0:
        MFU.set(flops * steps / (dev_tot / 1e3) / peak, plane=plane)


# -- HBM timeline -----------------------------------------------------------

def hbm_watermark(source: str = "devprof") -> Dict[int, tuple]:
    """One HBM sample into the gauges AND the flight-recorder ring, so a
    dump carries a device-memory timeline: in use and peak
    (``memory_allocated``), ``memory_reserved`` and ``mem_get_info``'s
    free and total. Guarded no-op on the CPU (no stats) and on any probe
    failure — a watermark must never break the thread taking it (the
    Emitter daemon calls this)."""
    try:
        stats = _accounting.sample_hbm()
        memory = _accounting.device_memory() if stats else {}
    except Exception:  # noqa: BLE001 - never break the sampling thread
        return {}
    if stats:
        _flightrec.record(
            "hbm.watermark", source=source,
            devices={str(d): {"in_use": u, "peak": p,
                              "reserved": memory.get(d, {}).get("reserved"),
                              "free": memory.get(d, {}).get("free"),
                              "total": memory.get(d, {}).get("total")}
                     for d, (u, p) in stats.items()})
        # feed the pressure governor: real device usage joins the
        # plane-registered bounds in its tier computation (lazy import —
        # telemetry loads before resilience; guarded like everything
        # else on this sampling path)
        try:
            from ..resilience import hbm as _hbm

            gov = _hbm.governor()
            totals = [m["total"] for m in memory.values()]
            if totals:
                gov.set_device_limit(min(totals))
            gov.observe_device(stats, source=source)
        except Exception:  # noqa: BLE001 - never break the sampler
            _LOG.debug("hbm governor feed failed", exc_info=True)
    return stats


# -- chrome-trace device lane -----------------------------------------------

def _snapshot_slices() -> List[tuple]:
    for _ in range(16):  # deque iteration can race appends (flightrec)
        try:
            return list(_SLICES)
        except RuntimeError:
            continue
    return []


def chrome_events(pid: int) -> List[Dict[str, Any]]:
    """The sampled device slices as chrome://tracing events on the same
    ``perf_counter * 1e6`` microsecond timeline the request traces and
    the profiler/span buffer use — ``tid 0`` is the device lane. A slice
    starts at the host time its dispatch was launched and lasts the
    measured device time (an event pair gives a duration, not a host
    timestamp). Empty (no meta event either) when nothing was sampled."""
    slices = _snapshot_slices()
    if not slices:
        return []
    out: List[Dict[str, Any]] = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "device (devprof sampled)"}}]
    for site, t0, ms in slices:
        out.append({"name": site, "cat": "device", "ph": "X",
                    "ts": t0 * 1e6, "dur": ms * 1e3, "pid": pid,
                    "tid": 0, "args": {"device_ms": round(ms, 3)}})
    return out


# -- the /debug/perf summary --------------------------------------------------

def summary(top_n: int = 10) -> Dict[str, Any]:
    """Point-in-time attribution document: top-N sites by cumulative
    sampled device time, per-plane wall/device/host-gap totals and the
    derived throughput gauges. The ``/debug/perf`` view."""
    sites = sorted(
        ({"site": row["labels"]["site"],
          "device_ms_total": round(row["sum"], 3),
          "dispatches_sampled": row["count"],
          "p50_ms": round(row["p50"], 3),
          "p99_ms": round(row["p99"], 3)}
         for row in DEVICE_TIME_MS.series()),
        key=lambda s: -s["device_ms_total"])
    with _TOTALS_LOCK:
        totals = {k: list(v) for k, v in _TOTALS.items()}
    planes: Dict[str, Any] = {}
    for plane, (wall, dev, units) in totals.items():
        doc = {"wall_ms": round(wall, 3), "device_ms": round(dev, 3),
               "host_gap_ratio": (round(max(0.0, 1.0 - dev / wall), 4)
                                  if wall else None)}
        if plane == "decode":
            doc["tokens"] = int(units)
            if dev > 0:
                doc["tokens_per_device_s"] = round(units / (dev / 1e3), 2)
        else:
            doc["steps"] = int(units)
            flops, peak = _FLOPS
            if flops and peak and dev > 0:
                doc["mfu"] = round(flops * units / (dev / 1e3) / peak, 6)
        planes[plane] = doc
    return {"active": ACTIVE, "sample": _RATE[0],
            "sites": sites[:max(0, int(top_n))], "site_count": len(sites),
            "planes": planes}


def _perf_view() -> Dict[str, Any]:
    """The ``/debug/perf`` document: attribution summary + the latest
    bench-sentinel verdicts (lazy import: regress is a sibling)."""
    doc: Dict[str, Any] = {"devprof": summary()}
    try:
        from . import regress

        doc["perf_verdicts"] = regress.recent_verdicts()
    except Exception as exc:  # noqa: BLE001 - the view must still render
        doc["perf_verdicts"] = {"error": repr(exc)}
    return doc


def reset() -> None:
    """Drop accumulated slices/totals (registry series are cleared
    separately via ``REGISTRY.clear_data()``). Test isolation."""
    _SLICES.clear()
    with _TOTALS_LOCK:
        _TOTALS.clear()
    _TIMED_TICKS[0] = 0
    _FLOPS[0] = _FLOPS[1] = None
    tick_end()


# activate from the env knob (usually off → hook stays None), and publish
# the perf view regardless: verdict/summary structure must be inspectable
# even before the first sample
refresh()

from . import httpd as _httpd  # noqa: E402 - after refresh(): httpd pulls
# exporters/tracing, which are fully imported by the time devprof loads

_httpd.register_debug_view("perf", _perf_view)
