"""Retry policies and deadlines — the *decide* half of the resilience layer.

Ported as it is from ``mxnet_tpu/resilience/policies.py``.

The reference framework's fault handling lives in ps-lite (resender
timeouts, scheduler heartbeats, ``is_recovery`` re-rendezvous); this stack
has no parameter server, so transient faults surface as exceptions at the
call site — a flaky device->host transfer, an ICI collective hiccup, a
checkpoint write racing a disk stall. :class:`RetryPolicy` is the one
uniform answer wired into those sites (kvstore push/pull, io prefetch,
``base.fetch_host``, serving engine runs, checkpoint commits): exponential
backoff with jitter, capped per-delay and by a total sleep budget, retrying
only *transient* error classes so programming errors still fail fast.

Every knob flows through ``base.get_env`` (registry: ``docs/env_var.md``,
all ``MXNET_RESILIENCE_*``, read with ``cache=False`` so launchers and
tests can set them after import). Every retry event lands in telemetry as
``mxnet_retries_total{site,outcome}`` with outcomes:

* ``retry``     — one backoff sleep is about to happen;
* ``recovered`` — the call succeeded after at least one retry;
* ``exhausted`` — attempts/budget/deadline ran out; the last error is
  re-raised unchanged (callers keep their exception types);
* ``oom``       — the failure classified as out-of-memory
  (``hbm.classify``): surfaced immediately without a single retry, even
  when transient-typed — re-dispatching an allocation against a full
  device is not recovery; the owning plane's survival path handles it.

Nothing here is chaos-specific: :mod:`.chaos` raises
:class:`~mxnet_tpu_torch.resilience.chaos.FaultInjected` (a
:class:`TransientError`), so injected faults exercise exactly the retry
machinery real faults would.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Sequence, Tuple

from ..base import MXNetError, get_env

__all__ = ["TransientError", "Deadline", "RetryPolicy", "DEFAULT_RETRY_ON"]


class TransientError(MXNetError):
    """An error the caller may safely retry (nothing was committed).
    Chaos-injected faults subclass this; runtime code can raise it to mark
    a failure as retry-safe."""


#: Error classes retried by default: the explicit transient marker plus the
#: OS-level classes a storage/network hiccup raises. Everything else
#: (ValueError, tracer leaks, assertion failures...) is a bug and fails
#: fast.
DEFAULT_RETRY_ON: Tuple[type, ...] = (TransientError, ConnectionError,
                                      TimeoutError, OSError)

_DEF_MAX_ATTEMPTS = 4
_DEF_BASE_DELAY_MS = 5.0
_DEF_MAX_DELAY_MS = 2000.0
_DEF_MULTIPLIER = 2.0
_DEF_JITTER = 0.1
_DEF_BUDGET_MS = 10000.0


class Deadline:
    """A wall-clock budget carried through a call chain. ``None`` timeout
    means unbounded (``remaining()`` is ``inf``, never expires)."""

    __slots__ = ("_end",)

    def __init__(self, timeout_s: Optional[float] = None):
        self._end = None if timeout_s is None else time.monotonic() + timeout_s

    @classmethod
    def after_ms(cls, timeout_ms: Optional[float]) -> "Deadline":
        return cls(None if timeout_ms is None else float(timeout_ms) / 1e3)

    def remaining(self) -> float:
        if self._end is None:
            return float("inf")
        return max(0.0, self._end - time.monotonic())

    def expired(self) -> bool:
        return self._end is not None and time.monotonic() >= self._end

    def __repr__(self) -> str:
        if self._end is None:
            return "Deadline(unbounded)"
        return "Deadline(%.3fs remaining)" % self.remaining()


def _is_oom(exc: BaseException) -> bool:
    """True when ``exc`` classifies as an out-of-memory failure (lazy
    import: :mod:`.hbm` sits above this module in the package graph).
    OOMs are the one transient-typed class the policy refuses to retry
    — see the ``outcome="oom"`` branch in :meth:`RetryPolicy.call`."""
    try:
        from . import hbm

        return hbm.classify(exc) is not None
    except Exception:  # noqa: BLE001 - the guard must never turn a
        return False   # retryable failure into a policy crash


_RETRIES = None


def retries_counter():
    """``mxnet_retries_total{site,outcome}`` — THE definition of the retry
    counter, resolved lazily because the resilience layer sits below
    telemetry in the import order. Every publisher (the policy itself,
    ``elastic.run_elastic``) goes through here so the name/label schema
    lives in one place."""
    global _RETRIES
    if _RETRIES is None:
        from .. import telemetry

        _RETRIES = telemetry.counter(
            "mxnet_retries_total",
            "retry-policy events per call site "
            "(outcome: retry/recovered/exhausted/oom)",
            labels=("site", "outcome"))
    return _RETRIES


class RetryPolicy:
    """Budget-capped exponential backoff with jitter.

    Delay before retry ``n`` (1-based) is
    ``min(base_delay * multiplier**(n-1), max_delay)`` scaled by a uniform
    jitter in ``[1-jitter, 1+jitter]``; the *total* slept time across one
    :meth:`call` never exceeds ``budget_ms``. Arguments left ``None`` come
    from the ``MXNET_RESILIENCE_*`` environment knobs at construction time.
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 base_delay_ms: Optional[float] = None,
                 max_delay_ms: Optional[float] = None,
                 multiplier: Optional[float] = None,
                 jitter: Optional[float] = None,
                 budget_ms: Optional[float] = None,
                 retry_on: Optional[Sequence[type]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts is None:
            max_attempts = get_env("MXNET_RESILIENCE_MAX_ATTEMPTS",
                                   _DEF_MAX_ATTEMPTS, int, cache=False)
        if base_delay_ms is None:
            base_delay_ms = get_env("MXNET_RESILIENCE_BASE_DELAY_MS",
                                    _DEF_BASE_DELAY_MS, float, cache=False)
        if max_delay_ms is None:
            max_delay_ms = get_env("MXNET_RESILIENCE_MAX_DELAY_MS",
                                   _DEF_MAX_DELAY_MS, float, cache=False)
        if multiplier is None:
            multiplier = get_env("MXNET_RESILIENCE_MULTIPLIER",
                                 _DEF_MULTIPLIER, float, cache=False)
        if jitter is None:
            jitter = get_env("MXNET_RESILIENCE_JITTER", _DEF_JITTER, float,
                             cache=False)
        if budget_ms is None:
            budget_ms = get_env("MXNET_RESILIENCE_BUDGET_MS", _DEF_BUDGET_MS,
                                float, cache=False)
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = max(0.0, float(base_delay_ms)) / 1e3
        self.max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self.multiplier = max(1.0, float(multiplier))
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self.budget_s = max(0.0, float(budget_ms)) / 1e3
        self.retry_on: Tuple[type, ...] = tuple(retry_on) \
            if retry_on is not None else DEFAULT_RETRY_ON
        self._sleep = sleep

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Policy built entirely from the ``MXNET_RESILIENCE_*`` knobs."""
        return cls()

    def delay_s(self, retry_index: int) -> float:
        """Pre-jitter delay before retry ``retry_index`` (1-based)."""
        d = self.base_delay_s * (self.multiplier ** (retry_index - 1))
        return min(d, self.max_delay_s)

    def delays(self):
        """The full pre-jitter backoff schedule (``max_attempts - 1``
        delays) — what the unit tests assert against."""
        return [self.delay_s(i) for i in range(1, self.max_attempts)]

    def call(self, fn: Callable, *args, site: str = "unspecified",
             deadline: Optional[Deadline] = None, **kwargs):
        """Invoke ``fn(*args, **kwargs)``, retrying transient failures.

        Non-transient exceptions (anything outside ``retry_on``) propagate
        immediately. When retries run out — attempts, sleep budget, or the
        optional ``deadline`` — the *last* exception is re-raised unchanged
        and ``mxnet_retries_total{site,outcome="exhausted"}`` ticks.
        """
        spent = 0.0
        attempt = 0
        while True:
            attempt += 1
            try:
                out = fn(*args, **kwargs)
            except self.retry_on as exc:
                if _is_oom(exc):
                    # a classified OOM is transient-shaped (OOMInjected
                    # subclasses TransientError) but NOT retry-curable:
                    # the device is full, and re-dispatching the same
                    # allocation burns the backoff budget against a wall.
                    # Surface it immediately to the owning plane's
                    # survival path (hbm.oom_survival).
                    retries_counter().inc(site=site, outcome="oom")
                    raise
                if attempt >= self.max_attempts:
                    retries_counter().inc(site=site, outcome="exhausted")
                    raise
                delay = self.delay_s(attempt)
                if self.jitter:
                    delay *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
                if spent + delay > self.budget_s:
                    retries_counter().inc(site=site, outcome="exhausted")
                    raise
                if deadline is not None and deadline.remaining() < delay:
                    retries_counter().inc(site=site, outcome="exhausted")
                    raise
                retries_counter().inc(site=site, outcome="retry")
                if delay > 0.0:
                    self._sleep(delay)
                spent += delay
                continue
            if attempt > 1:
                retries_counter().inc(site=site, outcome="recovered")
            return out

    def __repr__(self) -> str:
        return ("RetryPolicy(attempts=%d, base=%.1fms, max=%.0fms, x%.1f, "
                "jitter=%.2f, budget=%.0fms)"
                % (self.max_attempts, self.base_delay_s * 1e3,
                   self.max_delay_s * 1e3, self.multiplier, self.jitter,
                   self.budget_s * 1e3))
