"""Multi-tenant serving control plane: who gets the engine, and when.

Ported from ``mxnet_tpu/serving/tenancy.py`` (no JAX there): the registry,
the weighted-fair queue, the per-tenant breaker and the token bucket,
the per-tenant speculative cap (``spec_k``), the flight-recorder and SLO
hooks, and the fleet's snapshot aggregation (:func:`aggregate_snapshots`),
as they are.

One decode engine (or batch server) fronts many clients. Without a
control plane the sharing is accidental: admission is FIFO, so a hot
client's backlog delays everyone behind it; the queue bound, the KV page
pool and the circuit breaker are all global, so one tenant's overload or
poisoned traffic sheds — or trips the breaker for — the whole fleet.
This module makes the sharing *deliberate*:

* **tenant registry** — every request carries a ``tenant_id``
  (``submit(..., tenant=)``; untagged callers ride the ``default``
  tenant). Tenants declare a **priority class** (``interactive`` /
  ``standard`` / ``batch`` — strict priority between classes), a
  **weight** (fair share within the class), a bounded **sub-queue**, a
  KV **page budget**, and a **token-rate** budget, either
  programmatically or through the ``MXNET_TENANTS`` spec;
* **weighted-fair queueing** — :class:`WeightedFairQueue` replaces the
  single FIFO: per-tenant bounded sub-queues (shed with
  ``QueueFullError`` *before* the global queue fills) drained by
  deficit-round-robin, so admission order is proportional to weight, not
  to arrival order. A tenant that cannot be admitted right now (page
  budget, rate budget, open breaker) is *deferred* — skipped without
  blocking the tenants behind it, which is exactly the head-of-line
  coupling the FIFO had. The HBM pressure governor
  (:mod:`mxnet_tpu_torch.resilience.hbm`) adds one more deferral rung:
  under ``orange``/``red`` tiers the engine defers ``batch``-class
  tenants (``deferred_pressure`` in the stats snapshot) while
  ``interactive`` traffic keeps flowing — degradation never inverts
  priority;
* **per-tenant circuit breakers** — :class:`TenantBreaker` counts a
  tenant's own request failures in a sliding window and sheds *that
  tenant alone* (:class:`TenantUnavailableError`) while the engine-level
  breaker stays reserved for engine-level faults. Visible as
  ``mxnet_tenant_breaker_state{server,tenant}``;
* **resource budgets** — KV page quotas and token-bucket rate limits
  enforced at decode admission: a tenant at its budget defers, everyone
  else keeps flowing.

The queue is NOT internally locked: the owning engine already serializes
submit/admission under its own condition variable, and a second lock
here would only add a deadlock surface. :class:`TenantRegistry` and
:class:`TenantBreaker` ARE thread-safe (submit() touches them before
taking the engine lock).

Spec DSL (``MXNET_TENANTS``, or the ``tenants=`` constructor argument)
— ``;``-separated tenants of ``,``-separated ``key=value`` pairs; a bare
first token is the tenant id::

    MXNET_TENANTS="gold,weight=4,priority=interactive,pages=64,rate=500;
                   bronze,weight=1,priority=batch,depth=32"

Keys: ``id``/bare token, ``weight``, ``priority`` (class name or int),
``depth`` (sub-queue bound), ``pages`` (KV page budget, 0 = unlimited),
``rate`` (tokens/s, 0 = unlimited), ``burst`` (token bucket size, 0 =
auto), ``spec_k`` (speculative draft-depth cap). Defaults come from
the ``MXNET_TENANT_*`` knobs (``docs/env_var.md``).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .. import telemetry
from ..telemetry import flightrec as _flightrec
from ..telemetry import slo as _slo
from ..base import MXNetError, get_env
from ..resilience.breaker import STATE_VALUE
from .batcher import EngineUnavailableError
from .stats import TenantStats

__all__ = ["Tenant", "TenantRegistry", "TenantBreaker",
           "TenantUnavailableError", "WeightedFairQueue", "parse_tenants",
           "aggregate_snapshots", "PRIORITY_CLASSES", "DEFAULT_TENANT",
           "SHARED_TENANT"]

#: The tenant untagged ``submit()`` calls ride.
DEFAULT_TENANT = "default"

#: Reserved pseudo-tenant: prefix-cache pages shared by more than one
#: sequence (refcount > 1) are charged here, to NO real tenant's page
#: budget — a sharer pays only for its exclusive tail and CoW copies, so
#: shared system prompts are never double-charged. The id cannot be
#: registered or submitted against; it appears as a synthetic row in
#: ``stats()["tenants"]`` reporting the engine-wide shared-page count.
SHARED_TENANT = "shared"

#: Strict-priority admission classes: a lower value is admitted first,
#: weights apportion the share *within* a class only. ``batch`` traffic
#: therefore only runs when no ``interactive``/``standard`` request is
#: admissible — the documented starvation trade of strict priority.
PRIORITY_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}

_DEF_WEIGHT = 1.0
_DEF_DEPTH = 64
_DEF_BREAKER_THRESHOLD = 5
_DEF_BREAKER_WINDOW_S = 30.0
_DEF_BREAKER_RESET_S = 10.0

_T_BREAKER = telemetry.gauge(
    "mxnet_tenant_breaker_state",
    "per-tenant circuit breaker state (0 closed, 1 half-open, 2 open)",
    labels=("server", "tenant"))
_T_BREAKER_TRANS = telemetry.counter(
    "mxnet_tenant_breaker_transitions_total",
    "per-tenant circuit breaker state transitions",
    labels=("server", "tenant", "to"))


class TenantUnavailableError(EngineUnavailableError):
    """The *tenant's* breaker is open: this tenant's traffic is shed
    while every other tenant keeps being served (contrast
    :class:`~mxnet_tpu_torch.serving.batcher.EngineUnavailableError`, the
    engine-wide shed)."""

    def __init__(self, tenant_id: str, state: str):
        super().__init__("tenant %r breaker is %s: request shed (other "
                         "tenants unaffected)" % (tenant_id, state))
        self.tenant_id = tenant_id


class TenantBreaker:
    """Sliding-window circuit breaker for one tenant's traffic.

    Differs from the engine :class:`~mxnet_tpu_torch.resilience.CircuitBreaker`
    deliberately: that one counts *consecutive* failures (an engine that
    answers anything is healthy), while a misbehaving tenant's failures
    are *interleaved* with other tenants' successes — so here a success
    does NOT reset the count; the breaker opens when
    ``failure_threshold`` of the tenant's own requests failed within the
    trailing ``window_s`` seconds. ``reset_timeout_s`` later one
    half-open probe request is admitted; its success closes the breaker,
    its failure re-opens it. Thread-safe.
    """

    def __init__(self, server: str, tenant_id: str,
                 failure_threshold: Optional[int] = None,
                 window_s: Optional[float] = None,
                 reset_timeout_s: Optional[float] = None,
                 half_open_max: int = 1):
        if failure_threshold is None:
            failure_threshold = get_env("MXNET_TENANT_BREAKER_THRESHOLD",
                                        _DEF_BREAKER_THRESHOLD, int,
                                        cache=False)
        if window_s is None:
            window_s = get_env("MXNET_TENANT_BREAKER_WINDOW_S",
                               _DEF_BREAKER_WINDOW_S, float, cache=False)
        if reset_timeout_s is None:
            reset_timeout_s = get_env("MXNET_TENANT_BREAKER_RESET_S",
                                      _DEF_BREAKER_RESET_S, float,
                                      cache=False)
        self.server = server
        self.tenant_id = tenant_id
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_s = max(0.001, float(window_s))
        self.reset_timeout_s = max(0.0, float(reset_timeout_s))
        self.half_open_max = max(1, int(half_open_max))
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures: Deque[float] = collections.deque()
        self._opened_at = 0.0
        self._probes = 0
        self._probe_at = 0.0
        _T_BREAKER.set(STATE_VALUE["closed"], server=server,
                       tenant=tenant_id)

    def _transition(self, to: str) -> None:
        # caller holds self._lock
        self._state = to
        _T_BREAKER.set(STATE_VALUE[to], server=self.server,
                       tenant=self.tenant_id)
        _T_BREAKER_TRANS.inc(server=self.server, tenant=self.tenant_id,
                             to=to)
        # black box: "which tenant's breaker tripped right before the
        # death" is the first question a post-mortem asks
        _flightrec.record("tenant_breaker", server=self.server,
                          tenant=self.tenant_id, to=to)

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._failures and self._failures[0] < horizon:
            self._failures.popleft()

    def _elapsed(self, now: float) -> bool:
        return now - self._opened_at >= self.reset_timeout_s

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == "open" and self._elapsed(time.monotonic()):
                return "half_open"
            return self._state

    def allow(self) -> bool:
        """May one of this tenant's requests be admitted right now?
        Open->half-open promotion is time-based, here — like the engine
        breaker, a caller that only asks ``allow`` drives the machine."""
        with self._lock:
            if self._state == "closed":
                return True
            now = time.monotonic()
            if self._state == "open":
                if not self._elapsed(now):
                    return False
                self._transition("half_open")
                self._probes = 1
                self._probe_at = now
                return True
            if self._probes < self.half_open_max:
                self._probes += 1
                self._probe_at = now
                return True
            if now - self._probe_at >= self.reset_timeout_s:
                # probe lease expired: an admitted probe whose request
                # never reported (deferred after allow(), expired at
                # assembly) must not wedge the breaker half-open forever
                self._probe_at = now
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            if self._state != "closed":
                self._transition("closed")
                self._failures.clear()
                self._probes = 0

    def on_failure(self) -> None:
        with self._lock:
            now = time.monotonic()
            self._failures.append(now)
            self._prune(now)
            if self._state == "half_open":
                self._transition("open")
                self._opened_at = now
                self._probes = 0
            elif self._state == "closed" and \
                    len(self._failures) >= self.failure_threshold:
                self._transition("open")
                self._opened_at = now

    def __repr__(self) -> str:
        return "TenantBreaker(%r/%r, state=%s, failures=%d/%d in %.0fs)" % (
            self.server, self.tenant_id, self.state, len(self._failures),
            self.failure_threshold, self.window_s)


class _TokenBucket:
    """Continuous-refill token bucket; ``rate <= 0`` disables (always
    admits). Guarded by the owning Tenant's lock."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float):
        self.rate = max(0.0, float(rate))
        self.burst = float(burst)
        self.tokens = self.burst
        self._last = time.monotonic()

    def try_take(self, cost: float) -> bool:
        if self.rate <= 0.0:
            return True
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class Tenant:
    """One tenant's configuration + runtime state inside one engine.

    Created through :class:`TenantRegistry`; the engine's admission loop
    is the only writer of the queue/deficit fields (under the engine
    lock), while page/rate accounting takes the tenant's own lock so the
    close() path can release concurrently with the worker.
    """

    def __init__(self, registry: "TenantRegistry", tenant_id: str,
                 weight: float, priority: int, queue_depth: int,
                 page_budget: Optional[int], rate: float, burst: float,
                 breaker: TenantBreaker, stats: TenantStats,
                 spec_k: Optional[int] = None):
        self.tenant_id = tenant_id
        self.weight = max(0.01, float(weight))
        self.priority = int(priority)
        self.queue_depth = max(1, int(queue_depth))
        self.page_budget = page_budget if page_budget else None
        # speculative draft-depth CAP for this tenant's slots: None =
        # inherit the engine's MXNET_DECODE_SPEC_K. Can only LOWER the
        # engine k (the verify width K+1 is fixed per engine) — the lever
        # that stops one slow-accepting tenant burning the tick budget on
        # rejected verify rows. Mutable at runtime
        # (DecodeEngine.set_tenant_spec_k); plain int read each tick.
        self.spec_k = None if spec_k is None else max(0, int(spec_k))
        # the SLO engine divides the tenant burn/violation alerts by
        # these (instance key mirrors the registry's sorted-label key:
        # server/tenant)
        inst = "%s/%s" % (registry.server, tenant_id)
        _slo.note_bound("tenant_queue_depth", inst, self.queue_depth)
        if self.page_budget is not None:
            _slo.note_bound("tenant_pages", inst, self.page_budget)
        self.rate = max(0.0, float(rate))
        self.breaker = breaker
        self.stats = stats
        # maxlen is a belt-and-braces backstop: the engine sheds with
        # QueueFullError BEFORE append ever reaches the bound, so maxlen
        # can never silently drop — it just makes "bounded" structural
        self.queue: Deque = collections.deque(maxlen=self.queue_depth)
        self.deficit = 0.0
        self._lock = threading.Lock()
        self._pages_in_use = 0
        if self.rate > 0.0:
            if burst <= 0.0:
                # auto burst: one second of budget, but never so small a
                # single admissible request could not pass
                burst = max(self.rate, float(registry.max_cost))
            self._bucket: Optional[_TokenBucket] = _TokenBucket(self.rate,
                                                                burst)
            self.burst = self._bucket.burst
        else:
            self._bucket = None
            self.burst = 0.0

    # -- budgets -----------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self._pages_in_use

    def within_page_budget(self, need: int) -> bool:
        if self.page_budget is None:
            return True
        with self._lock:
            return self._pages_in_use + int(need) <= self.page_budget

    def charge_pages(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._pages_in_use += int(n)
            pages = self._pages_in_use
        self.stats.set_pages(pages)

    def release_pages(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._pages_in_use = max(0, self._pages_in_use - int(n))
            pages = self._pages_in_use
        self.stats.set_pages(pages)

    def take_tokens(self, cost: float) -> bool:
        if self._bucket is None:
            return True
        with self._lock:
            return self._bucket.try_take(float(cost))

    def refund_tokens(self, cost: float) -> None:
        """Return a charge whose admission was vetoed AFTER the bucket
        was debited (e.g. by the breaker) — without the refund a
        deferred tenant's retried admissions would drain its whole
        burst for work that never ran."""
        if self._bucket is None:
            return
        with self._lock:
            self._bucket.tokens = min(self._bucket.burst,
                                      self._bucket.tokens + float(cost))

    # -- failure attribution ----------------------------------------------
    def on_request_failure(self) -> None:
        """One of this tenant's requests failed (poisoned prompt, fault
        injected against this tenant, prefill error): per-request
        failures feed the TENANT breaker — the engine breaker is
        reserved for tick-level engine faults."""
        self.breaker.on_failure()
        self.stats.on_error()

    def snapshot(self) -> Dict:
        out = self.stats.snapshot()
        out.update({
            "weight": self.weight,
            "priority": self.priority,
            "queue_depth_bound": self.queue_depth,
            "queued": len(self.queue),
            "page_budget": self.page_budget,
            "pages_in_use": self.pages_in_use,
            "rate_tokens_s": self.rate,
            "spec_k": self.spec_k,
            "breaker": self.breaker.state,
        })
        return out


def parse_tenants(spec: str) -> List[Dict]:
    """Parse the ``MXNET_TENANTS`` DSL into register() kwargs dicts;
    malformed input raises (a typo'd tenant spec silently dropping a
    quota would be an isolation hole, not a default)."""
    out: List[Dict] = []
    for chunk in str(spec).split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        cfg: Dict = {}
        for i, tok in enumerate(chunk.split(",")):
            tok = tok.strip()
            if not tok:
                continue
            key, sep, val = tok.partition("=")
            key, val = key.strip(), val.strip()
            if not sep:
                if i == 0:
                    cfg["tenant_id"] = key
                    continue
                raise MXNetError("tenant spec: %r is not key=value" % tok)
            if not val:
                raise MXNetError("tenant spec: empty value in %r" % tok)
            try:
                if key == "id":
                    cfg["tenant_id"] = val
                elif key == "weight":
                    cfg["weight"] = float(val)
                elif key == "priority":
                    cfg["priority"] = (PRIORITY_CLASSES[val]
                                       if val in PRIORITY_CLASSES
                                       else int(val))
                elif key == "depth":
                    cfg["queue_depth"] = int(val)
                elif key == "pages":
                    cfg["page_budget"] = int(val)
                elif key == "rate":
                    cfg["rate"] = float(val)
                elif key == "burst":
                    cfg["burst"] = float(val)
                elif key == "spec_k":
                    cfg["spec_k"] = int(val)
                else:
                    raise MXNetError("tenant spec: unknown key %r in %r"
                                     % (key, tok))
            except (TypeError, ValueError):
                raise MXNetError("tenant spec: bad value in %r" % tok)
        if "tenant_id" not in cfg:
            raise MXNetError("tenant spec: chunk %r names no tenant id"
                             % chunk)
        out.append(cfg)
    return out


class TenantRegistry:
    """Per-engine tenant table: registration-ordered, thread-safe,
    auto-registering (a fleet sees new tenant ids without a deploy —
    unknown ids get the default configuration).

    ``max_cost`` is the largest admission cost a single request can
    carry (the decode plane passes ``max_seq_len`` tokens; the batch
    plane 1) — it sizes the DRR quantum and the auto token-bucket burst.
    """

    def __init__(self, server: str = "serving", spec: Optional[str] = None,
                 max_cost: float = 1.0,
                 default_queue_depth: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_window_s: Optional[float] = None,
                 breaker_reset_s: Optional[float] = None):
        self.server = server
        self.max_cost = max(1.0, float(max_cost))
        self._breaker_kw = dict(failure_threshold=breaker_threshold,
                                window_s=breaker_window_s,
                                reset_timeout_s=breaker_reset_s)
        self._lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {}
        self._order: List[str] = []
        self._def_weight = get_env("MXNET_TENANT_WEIGHT", _DEF_WEIGHT,
                                   float, cache=False)
        # 0 = inherit: an unconfigured tenant's sub-queue is as deep as
        # the engine's global bound (single-tenant traffic then sheds
        # exactly where the pre-tenancy FIFO did); the knob or a spec
        # `depth=` tightens it per tenant
        self._def_depth = get_env("MXNET_TENANT_QUEUE_DEPTH", 0, int,
                                  cache=False)
        if self._def_depth <= 0:
            self._def_depth = (int(default_queue_depth)
                               if default_queue_depth else _DEF_DEPTH)
        self._def_pages = get_env("MXNET_TENANT_PAGE_BUDGET", 0, int,
                                  cache=False)
        self._def_rate = get_env("MXNET_TENANT_RATE", 0.0, float,
                                 cache=False)
        self._def_burst = get_env("MXNET_TENANT_BURST", 0.0, float,
                                  cache=False)
        if spec is None:
            spec = get_env("MXNET_TENANTS", "", str, cache=False)
        for cfg in parse_tenants(spec):
            self.register(**cfg)

    def register(self, tenant_id: str, weight: Optional[float] = None,
                 priority: int = PRIORITY_CLASSES["standard"],
                 queue_depth: Optional[int] = None,
                 page_budget: Optional[int] = None,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_window_s: Optional[float] = None,
                 breaker_reset_s: Optional[float] = None,
                 spec_k: Optional[int] = None) -> Tenant:
        """Create (or return the existing) tenant. Like the telemetry
        get-or-create contract, kwargs only apply on first creation."""
        tenant_id = str(tenant_id)
        if tenant_id == SHARED_TENANT:
            raise MXNetError(
                "tenant id %r is reserved for the prefix-cache shared-"
                "page pseudo-tenant (refcount>1 pages charged to no real "
                "tenant); pick another id" % SHARED_TENANT)
        with self._lock:
            t = self._tenants.get(tenant_id)
            if t is not None:
                return t
            bkw = {
                "failure_threshold": (breaker_threshold
                                      if breaker_threshold is not None
                                      else self._breaker_kw[
                                          "failure_threshold"]),
                "window_s": (breaker_window_s
                             if breaker_window_s is not None
                             else self._breaker_kw["window_s"]),
                "reset_timeout_s": (breaker_reset_s
                                    if breaker_reset_s is not None
                                    else self._breaker_kw[
                                        "reset_timeout_s"]),
            }
            t = Tenant(
                self, tenant_id,
                weight=self._def_weight if weight is None else weight,
                priority=priority,
                queue_depth=(self._def_depth if queue_depth is None
                             else queue_depth),
                page_budget=(self._def_pages if page_budget is None
                             else page_budget),
                rate=self._def_rate if rate is None else rate,
                burst=self._def_burst if burst is None else burst,
                breaker=TenantBreaker(self.server, tenant_id, **bkw),
                stats=TenantStats(self.server, tenant_id),
                spec_k=spec_k)
            self._tenants[tenant_id] = t
            self._order.append(tenant_id)
            return t

    def resolve(self, tenant_id: Optional[str]) -> Tenant:
        """The tenant for a submit(): ``None`` -> the default tenant;
        unknown ids auto-register with default config."""
        return self.register(DEFAULT_TENANT if tenant_id is None
                             else str(tenant_id))

    def get(self, tenant_id: str) -> Optional[Tenant]:
        with self._lock:
            return self._tenants.get(str(tenant_id))

    def tenants(self) -> List[Tenant]:
        """Snapshot list in registration order (safe to iterate while
        other threads register)."""
        with self._lock:
            return [self._tenants[tid] for tid in self._order]

    def __iter__(self):
        return iter(self.tenants())

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def snapshot(self) -> Dict[str, Dict]:
        return {t.tenant_id: t.snapshot() for t in self.tenants()}


# counter-like per-tenant snapshot fields that sum across replicas; gauges
# (queued, pages_in_use, slots_active, ...) also sum — each replica holds
# its own share of the tenant's fleet-wide footprint
_ADDITIVE_SNAPSHOT_FIELDS = (
    "submitted", "completed", "shed", "shed_breaker", "timeouts", "errors",
    "deferred_pages", "deferred_rate", "queued", "queue_depth",
    "slots_active", "pages_in_use", "pages_in_use_now", "pages_in_use_max",
    "pages_cached", "spec_proposed_tokens", "spec_accepted_tokens")


def aggregate_snapshots(snapshots: List[Dict[str, Dict]]) -> Dict[str, Dict]:
    """Merge per-replica :meth:`TenantRegistry.snapshot` dicts into one
    fleet-wide per-tenant view (``FleetRouter.stats()["tenants"]``).

    Counters and footprint gauges sum across replicas; latency
    percentiles take the worst replica's value (a fleet p99 cannot be
    recomputed from per-replica percentiles, and for an SLO read the
    conservative bound is the honest one — the ``*_count`` fields say
    how much traffic stands behind each); config fields (weight,
    priority, budgets) and breaker state come from the first replica
    that carries the tenant — every replica is built from the same spec.
    """
    out: Dict[str, Dict] = {}
    for snap in snapshots:
        for tenant_id, row in (snap or {}).items():
            agg = out.get(tenant_id)
            if agg is None:
                out[tenant_id] = dict(row)
                continue
            for key, val in row.items():
                if key in _ADDITIVE_SNAPSHOT_FIELDS \
                        or key.endswith("_count"):
                    agg[key] = agg.get(key, 0) + val
                elif key.endswith("_ms") and isinstance(val, (int, float)):
                    agg[key] = max(agg.get(key, 0.0), val)
                elif key == "breaker":
                    # surface the worst replica-local verdict: one open
                    # breaker anywhere is fleet-visible
                    order = {"closed": 0, "half_open": 1, "open": 2}
                    if order.get(val, 0) > order.get(agg.get(key), 0):
                        agg[key] = val
    return out


class WeightedFairQueue:
    """Deficit-round-robin admission over per-tenant sub-queues.

    Strict priority between classes, weighted fairness within one: each
    pop scans priority levels ascending; within a level the *turn*
    rotates over tenants with queued work, a tenant receives one quantum
    (``weight * registry.max_cost``) when its turn begins and admits
    requests while its deficit covers their cost — so over time each
    tenant's admitted cost share converges to its weight share, and a
    burst is bounded by one quantum.

    ``guard(tenant, head_request)`` is the admission veto (page budget,
    rate budget, breaker): a vetoed tenant is **deferred** — its turn
    passes without burning deficit or blocking the level, the anti-
    head-of-line property the whole design exists for. Deficit
    accumulation of a long-deferred tenant is capped at one quantum +
    one max-cost request so it cannot bank unbounded catch-up burst.

    NOT self-locking: the owning engine calls every method under its own
    condition variable (both planes already serialized submit/admission
    there).
    """

    def __init__(self, registry: TenantRegistry,
                 cost_fn: Optional[Callable] = None):
        self._reg = registry
        self._cost = cost_fn or (lambda req: 1.0)
        self._turn: Dict[int, str] = {}
        self._last: Dict[int, str] = {}
        self._n_queued = 0

    # -- intake ------------------------------------------------------------
    def push(self, tenant: Tenant, req) -> int:
        """Append to the tenant's sub-queue (the caller has already
        enforced the bound and shed); returns the tenant's new depth."""
        tenant.queue.append(req)
        self._n_queued += 1
        return len(tenant.queue)

    def total_queued(self) -> int:
        return self._n_queued

    def queued(self, tenant: Tenant) -> int:
        return len(tenant.queue)

    def oldest_submit(self) -> Optional[float]:
        """Earliest ``t_submit`` among the sub-queue heads (the batch
        window anchor of :class:`~mxnet_tpu_torch.serving.Server`). None
        when empty."""
        heads = [t.queue[0].t_submit for t in self._reg if t.queue]
        return min(heads) if heads else None

    # -- the DRR pick ------------------------------------------------------
    def pop(self, guard: Optional[Callable] = None):
        """The next admissible ``(tenant, request)`` by priority + DRR,
        or None when nothing is admissible right now."""
        levels = sorted({t.priority for t in self._reg if t.queue})
        for level in levels:
            got = self._pop_level(level, guard)
            if got is not None:
                self._n_queued -= 1
                return got
        return None

    def _grant(self, tenant: Tenant) -> None:
        quantum = tenant.weight * self._reg.max_cost
        tenant.deficit = min(tenant.deficit + quantum,
                             quantum + self._reg.max_cost)

    def _succ(self, ids: List[str], last: Optional[str]) -> str:
        if last in ids:
            return ids[(ids.index(last) + 1) % len(ids)]
        return ids[0]

    def _advance(self, level: int, ids: List[str],
                 by_id: Dict[str, Tenant]) -> None:
        self._last[level] = self._turn[level]
        nxt = self._succ(ids, self._last[level])
        self._turn[level] = nxt
        self._grant(by_id[nxt])

    def _pop_level(self, level: int, guard):
        row = [t for t in self._reg if t.priority == level and t.queue]
        if not row:
            return None
        ids = [t.tenant_id for t in row]
        by_id = {t.tenant_id: t for t in row}
        if self._turn.get(level) not in by_id:
            # turn-holder drained or brand new level: the turn passes to
            # the next active tenant after the last holder, with a grant
            self._turn[level] = self._succ(ids, self._last.get(level))
            self._grant(by_id[self._turn[level]])
        for _ in range(len(ids) + 1):
            t = by_id[self._turn[level]]
            req = t.queue[0]
            cost = self._cost(req)
            if t.deficit >= cost and (guard is None or guard(t, req)):
                t.queue.popleft()
                t.deficit -= cost
                if not t.queue:
                    t.deficit = 0.0  # classic DRR: drained queue banks nothing
                    self._advance(level, ids, by_id)
                return t, req
            self._advance(level, ids, by_id)
        return None

    # -- removal -----------------------------------------------------------
    def expire(self, now: float) -> List[Tuple[Tenant, object]]:
        """Remove and return every queued request whose deadline passed."""
        out: List[Tuple[Tenant, object]] = []
        for t in self._reg:
            if not t.queue:
                continue
            keep: Deque = collections.deque(maxlen=t.queue.maxlen)
            for req in t.queue:
                if req.deadline is not None and now > req.deadline:
                    out.append((t, req))
                else:
                    keep.append(req)
            t.queue = keep
        self._n_queued -= len(out)
        return out

    def drain(self, tenant: Optional[Tenant] = None
              ) -> List[Tuple[Tenant, object]]:
        """Remove and return everything queued (one tenant, or all)."""
        out: List[Tuple[Tenant, object]] = []
        for t in ([tenant] if tenant is not None else list(self._reg)):
            while t.queue:
                out.append((t, t.queue.popleft()))
        self._n_queued -= len(out)
        return out
