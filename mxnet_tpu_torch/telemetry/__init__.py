"""mxnet_tpu_torch.telemetry — the process-wide metrics registry.

The counterpart of ``mxnet_tpu.telemetry``, ported as far as the decode
plane needs it: :mod:`.registry` (Counter/Gauge/Histogram with labels,
thread-safe, free when ``MXNET_TELEMETRY=0``); each metric's
``series()`` reads it back; and :mod:`.accounting`'s recompile gauges,
which the CUDA-graph captures feed, its optimizer-dispatch counter and
the training plane's step and demotion counters, and the checkpoint
commits' byte counter. The exporters
(Prometheus text, snapshots), tracing, the flight recorder, SLOs, the
HTTP endpoint and device-time profiling wait for later slices.
"""
from __future__ import annotations

from . import accounting, registry
from .accounting import (CKPT_BYTES, COMPILE_SECONDS, OPT_DISPATCHES,
                         RECOMPILES, STEADY_STATE_RECOMPILES, STEP_DISPATCHES,
                         TRAINPLANE_FALLBACKS, note_recompile,
                         set_steady_state_recompiles)
from .registry import (Counter, Gauge, Histogram, Registry, REGISTRY,
                       counter, enabled, gauge, histogram, set_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "enabled", "set_enabled",
    "RECOMPILES", "COMPILE_SECONDS", "STEADY_STATE_RECOMPILES",
    "OPT_DISPATCHES", "STEP_DISPATCHES", "TRAINPLANE_FALLBACKS",
    "CKPT_BYTES", "note_recompile", "set_steady_state_recompiles",
]
