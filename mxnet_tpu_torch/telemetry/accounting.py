"""Compile-once accounting: the port's copy of the recompile gauges of
``mxnet_tpu/telemetry/accounting.py``, under the same metric names.

On the card the decode plane's counterpart of a jit compile is the capture
of a CUDA graph (:class:`~mxnet_tpu_torch.serving.DecodeEngine`):

* :func:`note_recompile` counts a capture, or any compile a backend
  reports by hand, at its site (``mxnet_recompiles_total{site=}``), and
  its wall seconds (``mxnet_compile_seconds_total{site=}``);
* :func:`set_steady_state_recompiles` is the serving-facing gauge: after
  ``warmup()`` it must stay 0;
* ``OPT_DISPATCHES`` counts optimizer updates by path (``fused``: one
  call over every parameter; ``perparam``: one a parameter), as the JAX
  package's counter of that name;
* ``STEP_DISPATCHES`` counts the training plane's steps by plane
  (``graph``: one replay of the whole captured step; ``eager``: forward,
  backward and ``Trainer.step`` issued one by one), and
  ``TRAINPLANE_FALLBACKS`` the plane's demotions to eager by reason
  (``trainplane.FALLBACKS``), as the JAX package's counters;
* ``CKPT_BYTES`` counts the bytes a checkpoint commit wrote, by kind
  (``elastic.commit_bytes``: ``symbol``, ``states``).
"""
from __future__ import annotations

from . import registry as _registry

__all__ = ["RECOMPILES", "COMPILE_SECONDS", "STEADY_STATE_RECOMPILES",
           "OPT_DISPATCHES", "STEP_DISPATCHES", "TRAINPLANE_FALLBACKS",
           "CKPT_BYTES", "note_recompile", "set_steady_state_recompiles"]

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

CKPT_BYTES = _registry.counter(
    "mxnet_ckpt_bytes_total",
    "bytes committed to checkpoint storage by kind: symbol (the "
    "symbol's JSON), states (the optimizer's states)",
    labels=("kind",))


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
