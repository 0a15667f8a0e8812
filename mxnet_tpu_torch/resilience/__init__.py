"""mxnet_tpu_torch.resilience — retry/backoff/breaker policies + chaos.

The counterpart of ``mxnet_tpu.resilience``; these modules hold no JAX,
so they port near-verbatim:

====================  =====================================================
piece                 what it gives you
====================  =====================================================
:mod:`.policies`      :class:`RetryPolicy` (exponential backoff + jitter,
                      budget-capped), :class:`TransientError`;
                      ``mxnet_retries_total``
:mod:`.breaker`       :class:`CircuitBreaker` closed/open/half-open per
                      site; ``mxnet_breaker_state`` /
                      ``mxnet_breaker_transitions_total``
:mod:`.chaos`         deterministic seeded fault injection at named sites
                      (``MXNET_CHAOS="seed=7,site=serving.*,p=0.1"``);
                      free when disabled; ``mxnet_faults_injected_total``
====================  =====================================================

The HBM pressure governor (``mxnet_tpu/resilience/hbm.py``) waits for a
later slice. Knobs: ``MXNET_RESILIENCE_*`` and ``MXNET_CHAOS``, the same
names as the JAX package.
"""
from __future__ import annotations

from typing import Optional


from . import breaker as breaker_mod
from . import chaos
from . import policies
from .breaker import CircuitBreaker, CircuitOpenError, breaker
from .chaos import FaultInjected, OOMInjected, maybe_fail
from .policies import DEFAULT_RETRY_ON, RetryPolicy, TransientError

__all__ = [
    "RetryPolicy", "TransientError", "DEFAULT_RETRY_ON",
    "CircuitBreaker", "CircuitOpenError", "breaker", "breaker_mod",
    "chaos", "FaultInjected", "OOMInjected", "maybe_fail", "policies",
    "call", "default_policy", "reset_default_policy",
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
    """Drop the cached default policy so changed env knobs take effect."""
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = None


def call(site: str, fn, *args, **kwargs):
    """Run ``fn`` under the default retry policy, attributed to ``site``."""
    return default_policy().call(fn, *args, site=site, **kwargs)
