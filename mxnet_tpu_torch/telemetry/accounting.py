"""Runtime accounting: the port's copy of the series of
``mxnet_tpu/telemetry/accounting.py``, under the same metric names.

On the card the decode plane's counterpart of a jit compile is the capture
of a CUDA graph (:class:`~mxnet_tpu_torch.serving.DecodeEngine`):

* :func:`note_recompile` counts a capture, or any compile a backend
  reports by hand, at its site (``mxnet_recompiles_total{site=}``), and
  its wall seconds (``mxnet_compile_seconds_total{site=}``);
* :func:`set_steady_state_recompiles` is the serving-facing gauge: after
  ``warmup()`` it must stay 0;
* :func:`record_transfer` accumulates device->host transfer count and
  bytes per *path* (``fetch_host``, ``asnumpy``) — wired into
  ``base.fetch_host`` and ``NDArray.asnumpy``;
* :func:`sample_hbm` samples the caching allocator into the
  ``mxnet_hbm_bytes_*`` gauges: in use is ``memory_allocated`` (what the
  pressure governor divides), peak ``max_memory_allocated``;
  :func:`device_memory` adds ``memory_reserved`` and ``mem_get_info``'s
  free and total for the watermark and the OOM diagnostic. Where the
  device has no stats (the CPU) both are no-ops that leave the gauges
  unset, as the JAX package's are;
* ``OPT_DISPATCHES`` counts optimizer updates by path (``fused``: one
  call over every parameter; ``perparam``: one a parameter);
  ``STEP_DISPATCHES`` the training plane's steps by plane and
  ``TRAINPLANE_FALLBACKS`` its demotions by reason;
  ``PROFILER_COUNTER`` bridges every ``profiler.Counter``; the
  ``CKPT_*``, ``PREEMPTIONS`` and ``ELASTIC_*`` series are the elastic
  plane's (``CKPT_BYTES`` is fed by ``elastic.commit_bytes``).

The port has no ``jit_call``: its dispatch sites are the decode engine's
graph replays, which call devprof's probe (:data:`_DEVPROF_HOOK`) under
the JAX site names ``serving.decode_step``, ``serving.decode_prefill``,
``serving.decode_prefill_chunk`` and ``serving.decode_cow``.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import registry as _registry

__all__ = ["RECOMPILES", "COMPILE_SECONDS", "STEADY_STATE_RECOMPILES",
           "TRANSFERS", "TRANSFER_BYTES", "PROFILER_COUNTER",
           "OPT_DISPATCHES", "STEP_DISPATCHES", "TRAINPLANE_FALLBACKS",
           "COMPILE_CACHE_HITS", "COMPILE_CACHE_MISSES",
           "HBM_BYTES_IN_USE", "HBM_BYTES_PEAK",
           "CKPT_SAVE_MS", "CKPT_RESTORE_MS", "CKPT_BYTES",
           "PREEMPTIONS", "CKPT_CORRUPTION", "ELASTIC_GOODPUT",
           "ELASTIC_RESTARTS",
           "note_recompile", "record_transfer", "sample_hbm",
           "device_memory", "set_steady_state_recompiles"]

RECOMPILES = _registry.counter(
    "mxnet_recompiles_total",
    "XLA (re)compilations observed per jit call site",
    labels=("site",))

COMPILE_SECONDS = _registry.counter(
    "mxnet_compile_seconds_total",
    "cumulative wall seconds of jit calls that triggered a compile",
    labels=("site",))

STEADY_STATE_RECOMPILES = _registry.gauge(
    "mxnet_steady_state_recompiles",
    "recompiles after warmup at a site that promised compile-once "
    "(serving asserts 0)",
    labels=("site",))

TRANSFERS = _registry.counter(
    "mxnet_host_transfers_total",
    "device->host transfer operations per path",
    labels=("path",))

TRANSFER_BYTES = _registry.counter(
    "mxnet_host_transfer_bytes_total",
    "bytes moved device->host per path",
    labels=("path",))

OPT_DISPATCHES = _registry.counter(
    "mxnet_optimizer_update_dispatches_total",
    "optimizer-update calls by path: perparam = one kernel call per "
    "parameter, fused = one call over every parameter of a step",
    labels=("path",))

STEP_DISPATCHES = _registry.counter(
    "mxnet_trainstep_dispatches_total",
    "training-plane step executions by plane: graph = one replay of the "
    "whole captured step (forward, loss, backward and update), eager = "
    "forward, backward and update issued one by one; graph steps with no "
    "optimizer dispatch in between prove one dispatch a step",
    labels=("plane",))

TRAINPLANE_FALLBACKS = _registry.counter(
    "mxnet_trainplane_fallbacks_total",
    "training-plane graph captures declined, by reason",
    labels=("reason",))

# the JAX package's persistent compilation cache counters: registered for
# the same scrape surface; nothing here feeds them (the port keeps no
# compile cache — a CUDA graph is captured per process)
COMPILE_CACHE_HITS = _registry.counter(
    "mxnet_compile_cache_hits_total",
    "XLA executables served from the persistent compilation cache "
    "(MXNET_COMPILE_CACHE_DIR) instead of recompiled")

COMPILE_CACHE_MISSES = _registry.counter(
    "mxnet_compile_cache_misses_total",
    "compilations the persistent cache could not serve (first-ever trace "
    "of that program on this machine)")

HBM_BYTES_IN_USE = _registry.gauge(
    "mxnet_hbm_bytes_in_use",
    "device memory currently allocated, per device, as reported by the "
    "caching allocator (sample_hbm: memory_allocated; absent where the "
    "device has no stats, e.g. CPU)",
    labels=("device",))

HBM_BYTES_PEAK = _registry.gauge(
    "mxnet_hbm_bytes_peak",
    "peak device memory allocated since process start, per device "
    "(sample_hbm: max_memory_allocated; absent where the device has no "
    "stats)",
    labels=("device",))

# -- elastic/checkpoint accounting (the JAX package's elastic plane) --------

CKPT_SAVE_MS = _registry.histogram(
    "mxnet_ckpt_save_duration_ms",
    "wall duration of one training checkpoint save; mode=sync covers the "
    "whole commit, mode=async only the caller-visible snapshot (writes "
    "overlap subsequent steps)",
    labels=("mode",))

CKPT_RESTORE_MS = _registry.histogram(
    "mxnet_ckpt_restore_duration_ms",
    "wall duration of one training checkpoint restore (params + state + "
    "iterator/rng), including any corruption-fallback walk")

CKPT_BYTES = _registry.counter(
    "mxnet_ckpt_bytes_total",
    "bytes committed to checkpoint storage by kind: symbol (the "
    "symbol's JSON), states (the optimizer's states)",
    labels=("kind",))

PREEMPTIONS = _registry.counter(
    "mxnet_preemptions_total",
    "preemption notices honored (SIGTERM / MXNET_PREEMPTION_FILE): a "
    "best-effort checkpoint-now followed by a clean Preempted exit")

CKPT_CORRUPTION = _registry.counter(
    "mxnet_ckpt_corruption_total",
    "committed checkpoints rejected at restore (missing shard/param file "
    "or content-hash mismatch) — each one fell back to an older epoch")

ELASTIC_GOODPUT = _registry.gauge(
    "mxnet_elastic_goodput_ratio",
    "productive train time over wall time across an elastic run's "
    "restarts (attempts that advanced the committed epoch count as "
    "productive; crash-and-replay time does not)")

ELASTIC_RESTARTS = _registry.counter(
    "mxnet_elastic_restarts_total",
    "run_elastic restarts by reason (exception = train_fn raised, "
    "stall = no step progress within MXNET_ELASTIC_STALL_SECS)",
    labels=("reason",))

PROFILER_COUNTER = _registry.gauge(
    "mxnet_profiler_counter",
    "latest value of each profiler.Counter (chrome-trace counter lanes, "
    "bridged)",
    labels=("domain", "counter"))


#: devprof's dispatch probe (``(site, device) -> probe or None``),
#: installed by :mod:`~mxnet_tpu_torch.telemetry.devprof` only while its
#: sampling rate is positive. ``None`` (the default) keeps a replay's cost
#: at ONE module-global pointer check.
_DEVPROF_HOOK = None


def note_recompile(site: str, count: int = 1, seconds: float = 0.0):
    """Manual recompile report for backends without a countable cache."""
    if not _registry.ENABLED or count <= 0:
        return
    RECOMPILES.inc(count, site=site)
    if seconds > 0:
        COMPILE_SECONDS.inc(seconds, site=site)


def set_steady_state_recompiles(site: str, count: int):
    """Publish the post-warmup recompile count for ``site``."""
    if not _registry.ENABLED:
        return
    STEADY_STATE_RECOMPILES.set(count, site=site)


def _cuda_indices(devices):
    if devices is not None:
        return [torch.device(d).index or 0 for d in devices
                if torch.device(d).type == "cuda"]
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def device_memory(devices=None) -> Dict[int, Dict[str, int]]:
    """The caching allocator's counters per card: ``allocated``
    (``memory_allocated``), ``peak`` (``max_memory_allocated``),
    ``reserved`` (``memory_reserved``) and ``free``/``total``
    (``mem_get_info``). ``{}`` on the CPU, and before this process
    touched a card (a probe must not create a CUDA context)."""
    out: Dict[int, Dict[str, int]] = {}
    for i in _cuda_indices(devices):
        try:
            free, total = torch.cuda.mem_get_info(i)
            out[i] = {"allocated": int(torch.cuda.memory_allocated(i)),
                      "peak": int(torch.cuda.max_memory_allocated(i)),
                      "reserved": int(torch.cuda.memory_reserved(i)),
                      "free": int(free), "total": int(total)}
        except RuntimeError:  # a stats probe must never break a step
            continue
    return out


def sample_hbm(devices=None):
    """Sample per-card allocator stats into the ``mxnet_hbm_bytes_*``
    gauges and return ``{device_index: (in_use, peak)}``. Guarded no-op
    where the device exposes no memory stats (the CPU): the gauges stay
    unset rather than lying a zero."""
    if not _registry.ENABLED:
        return {}
    out = {}
    for i, mem in device_memory(devices).items():
        HBM_BYTES_IN_USE.set(mem["allocated"], device=str(i))
        HBM_BYTES_PEAK.set(mem["peak"], device=str(i))
        out[i] = (mem["allocated"], mem["peak"])
    return out


def record_transfer(path: str, arrays):
    """Account one device->host transfer of ``arrays`` (any objects with
    ``nbytes``; others count as 0 bytes) under the given ``path`` label."""
    if not _registry.ENABLED:
        return
    nbytes = 0
    for a in arrays:
        n = getattr(a, "nbytes", 0)
        nbytes += n
    TRANSFERS.inc(1, path=path)
    TRANSFER_BYTES.inc(nbytes, path=path)
