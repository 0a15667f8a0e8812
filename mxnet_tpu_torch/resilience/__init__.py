"""mxnet_tpu_torch.resilience — retry/backoff/breaker policies, chaos and
the HBM pressure governor.

The counterpart of ``mxnet_tpu.resilience``; these modules hold no JAX,
so they port near-verbatim:

====================  =====================================================
piece                 what it gives you
====================  =====================================================
:mod:`.policies`      :class:`RetryPolicy` (exponential backoff + jitter,
                      budget-capped), :class:`Deadline`,
                      :class:`TransientError`; ``mxnet_retries_total``
:mod:`.breaker`       :class:`CircuitBreaker` closed/open/half-open per
                      site; ``mxnet_breaker_state`` /
                      ``mxnet_breaker_transitions_total``
:mod:`.chaos`         deterministic seeded fault injection at named sites
                      (``MXNET_CHAOS="seed=7,site=serving.*,p=0.1"``);
                      free when disabled; ``mxnet_faults_injected_total``
:mod:`.hbm`           :class:`PressureGovernor` — hysteresis-latched HBM
                      pressure tiers (green/yellow/orange/red) over the
                      caching allocator's watermarks + plane-registered
                      bounds, the degradation ladder the decode admission
                      path consults, and OOM classification/survival
                      (``classify``/``oom_survival``);
                      ``mxnet_hbm_pressure_tier`` / ``mxnet_hbm_oom_total``
====================  =====================================================

Knobs: ``MXNET_RESILIENCE_*``, ``MXNET_CHAOS`` and ``MXNET_HBM_*``, the
same names as the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

from . import breaker as breaker_mod
from . import chaos
from . import hbm
from . import policies
from .breaker import CircuitBreaker, CircuitOpenError, breaker
from .chaos import (ChaosAction, DropShard, FaultInjected, Killed,
                    OOMInjected, TornWrite, maybe_fail)
from .hbm import PressureGovernor, classify, governor, oom_survival
from .policies import DEFAULT_RETRY_ON, Deadline, RetryPolicy, TransientError

__all__ = [
    "RetryPolicy", "Deadline", "TransientError", "DEFAULT_RETRY_ON",
    "CircuitBreaker", "CircuitOpenError", "breaker",
    "chaos", "FaultInjected", "ChaosAction", "Killed", "TornWrite",
    "DropShard", "OOMInjected", "maybe_fail",
    "hbm", "PressureGovernor", "classify", "governor", "oom_survival",
    "call", "default_policy", "reset_default_policy", "snapshot",
]

_DEFAULT_POLICY: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
    """The process-wide policy the framework call sites share, built from
    the ``MXNET_RESILIENCE_*`` knobs on first use."""
    global _DEFAULT_POLICY
    if _DEFAULT_POLICY is None:
        _DEFAULT_POLICY = RetryPolicy.from_env()
    return _DEFAULT_POLICY


def reset_default_policy() -> None:
    """Drop the cached default policy so changed env knobs take effect
    (tests; a production process configures the environment up front)."""
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = None


def call(site: str, fn, *args, deadline: Optional[Deadline] = None,
         **kwargs):
    """Run ``fn`` under the default retry policy, attributed to ``site``.
    The one-liner the framework call sites use::

        agg = resilience.call("kvstore.push", attempt)
    """
    return default_policy().call(fn, *args, site=site, deadline=deadline,
                                 **kwargs)


def snapshot() -> Dict:
    """Point-in-time resilience picture: retry counters by site/outcome,
    injected-fault counts, breaker states — the dict bench lines and
    post-mortems attach."""
    from .. import telemetry

    retries: Dict[str, float] = {}
    metric = telemetry.REGISTRY.get("mxnet_retries_total")
    if metric is not None:
        for row in metric.series():
            labels = row["labels"]
            retries["%s/%s" % (labels["site"], labels["outcome"])] = \
                row["value"]
    faults: Dict[str, float] = {}
    metric = telemetry.REGISTRY.get("mxnet_faults_injected_total")
    if metric is not None:
        for row in metric.series():
            faults[row["labels"]["site"]] = row["value"]
    # every breaker (registry-shared AND privately constructed, e.g. the
    # serving Server's per-engine ones) publishes its state to the gauge;
    # read it back so the snapshot sees them all
    state_names = {v: k for k, v in breaker_mod.STATE_VALUE.items()}
    breakers: Dict[str, str] = {}
    metric = telemetry.REGISTRY.get("mxnet_breaker_state")
    if metric is not None:
        for row in metric.series():
            breakers[row["labels"]["site"]] = state_names.get(
                int(row["value"]), str(row["value"]))
    return {
        "retries": retries,
        "faults_injected": faults,
        "breakers": breakers,
        "chaos": chaos.summary(),
        "hbm": hbm.governor().healthz_view(),
    }
