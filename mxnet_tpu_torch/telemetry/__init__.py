"""mxnet_tpu_torch.telemetry — unified runtime observability.

The counterpart of ``mxnet_tpu.telemetry``: one process-wide registry,
fed by every subsystem, read by machine-scrapable exporters.

====================  =====================================================
piece                 what it gives you
====================  =====================================================
:mod:`.registry`      Counter/Gauge/Histogram with labels; thread-safe;
                      bounded-reservoir percentiles; free when
                      ``MXNET_TELEMETRY=0``
:mod:`.spans`         ``telemetry.span("x")`` context manager/decorator —
                      duration histograms in the registry AND chrome-trace
                      events in the profiler buffer from one call site
:mod:`.accounting`    captures + compile seconds per site, device->host
                      transfer count/bytes per path, the caching
                      allocator's HBM gauges, the serving steady-state-
                      recompile gauge, the training and elastic series
:mod:`.exporters`     ``render_prometheus()`` text format, ``snapshot()``
                      JSON, and the ``MXNET_TELEMETRY_EMIT_SECS`` JSONL
                      emitter thread for post-mortems of hung runs
:mod:`.tracing`       per-request causality: ``trace_id`` minted at
                      ``submit()``, typed hop events through the decode
                      engine and the fleet router, ``get_trace()`` +
                      chrome-trace export (``MXNET_TRACE_SAMPLE``-gated)
:mod:`.flightrec`     bounded lock-cheap event ring (breaker trips,
                      ticks, evictions, faults, swaps, OOMs) dumped
                      atomically on death paths — the black box
:mod:`.slo`           the serving burn alerts, evaluated live over the
                      registry (``mxnet_slo_burn`` gauges,
                      ``stats()["alerts"]``)
:mod:`.httpd`         stdlib introspection daemon: ``/metrics``,
                      ``/healthz``, ``/debug/state``,
                      ``/debug/trace/<id>`` (``MXNET_METRICS_PORT``)
:mod:`.devprof`       device-time attribution: sampled per-site CUDA-event
                      timing of the decode engine's graph replays,
                      decode-tick / train-step host-gap breakdowns, MFU
                      and tokens-per-device-second gauges, HBM watermark
                      timeline, chrome-trace device lane
                      (``MXNET_DEVPROF_SAMPLE``-gated)
:mod:`.regress`       bench-regression sentinel: per-(metric, config)
                      trajectories over BENCH_*.json + emitter JSONL,
                      median+MAD verdicts (``/debug/perf``'s
                      ``perf_verdicts``)
====================  =====================================================

The JAX package's ``jit_call``/``jit_cache_size`` have no counterpart
(the port's dispatch sites are graph replays, probed by devprof).

Knobs (the JAX package's names): ``MXNET_TELEMETRY`` (default 1),
``MXNET_TELEMETRY_RESERVOIR`` (2048), ``MXNET_TELEMETRY_EMIT_SECS``
(0 = off), ``MXNET_TELEMETRY_EMIT_PATH`` (``telemetry.jsonl``),
``MXNET_METRICS_PORT`` (0 = off).
"""
from __future__ import annotations

from . import accounting, exporters, registry, spans
from . import flightrec, httpd, slo, tracing
from . import devprof, regress
from .accounting import (CKPT_BYTES, CKPT_CORRUPTION, CKPT_RESTORE_MS,
                         CKPT_SAVE_MS, COMPILE_CACHE_HITS,
                         COMPILE_CACHE_MISSES, COMPILE_SECONDS,
                         ELASTIC_GOODPUT,
                         ELASTIC_RESTARTS, HBM_BYTES_IN_USE, HBM_BYTES_PEAK,
                         OPT_DISPATCHES, PREEMPTIONS, PROFILER_COUNTER,
                         RECOMPILES, STEADY_STATE_RECOMPILES, STEP_DISPATCHES,
                         TRAINPLANE_FALLBACKS, TRANSFER_BYTES, TRANSFERS,
                         note_recompile, record_transfer, sample_hbm,
                         set_steady_state_recompiles)
from .exporters import (Emitter, render_prometheus, snapshot, start_emitter,
                        stop_emitter)
from .httpd import start_httpd, stop_httpd
from .registry import (Counter, Gauge, Histogram, Registry, REGISTRY,
                       counter, enabled, gauge, histogram, set_enabled)
from .spans import span, traced
from .tracing import get_trace, start_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "enabled", "set_enabled",
    "span", "traced",
    "note_recompile", "record_transfer",
    "sample_hbm", "set_steady_state_recompiles",
    "RECOMPILES", "COMPILE_SECONDS", "STEADY_STATE_RECOMPILES",
    "TRANSFERS", "TRANSFER_BYTES", "PROFILER_COUNTER",
    "HBM_BYTES_IN_USE", "HBM_BYTES_PEAK",
    "OPT_DISPATCHES", "STEP_DISPATCHES", "TRAINPLANE_FALLBACKS",
    "COMPILE_CACHE_HITS", "COMPILE_CACHE_MISSES",
    "CKPT_SAVE_MS", "CKPT_RESTORE_MS", "CKPT_BYTES",
    "PREEMPTIONS", "CKPT_CORRUPTION", "ELASTIC_GOODPUT", "ELASTIC_RESTARTS",
    "render_prometheus", "snapshot", "Emitter", "start_emitter",
    "stop_emitter",
    "tracing", "flightrec", "slo", "httpd", "devprof", "regress",
    "start_trace", "get_trace", "start_httpd", "stop_httpd",
]

# Post-mortem channel: MXNET_TELEMETRY_EMIT_SECS > 0 starts the JSONL
# emitter as soon as telemetry loads (start_emitter reads the knob and
# no-ops at <= 0, the default).
start_emitter()

# Introspection endpoint: MXNET_METRICS_PORT > 0 serves /metrics,
# /healthz, /debug/state and /debug/trace/<id> from a stdlib daemon
# thread (start_httpd no-ops at the default of 0). Best-effort at
# import: two processes sharing the configured port must not turn the
# second one's import into an Errno 98 crash — the same degrade-don't-die
# contract the Emitter holds. An explicit start_httpd() call still
# raises, so misconfiguration stays visible.
try:
    start_httpd()
except OSError:
    pass
