"""FleetRouter — N decode replicas behind one DecodeEngine-shaped door.

Ported as it is from ``mxnet_tpu/serving/fleet.py``, with one addition
the card needs: a replica that dies or drains gives back its device
memory (:meth:`DecodeEngine.release` — its CUDA graphs' private memory
pools and its KV pools) before a rebuild makes new ones, so a fleet that
restarts replicas does not grow. Replicas built on one card run in one
process: each replica's worker thread shares the interpreter lock and
the card with the others, so a fleet on one card is for routing,
affinity and containment, not for throughput. The factory's engines run
on the card unless it asks for the CPU.

One :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` tops out at its slot
count; the next unit of scale is a *fleet* of process-local replicas.
The router keeps the single-engine surface (``submit()`` → Future,
``stats()``, ``close(drain=)``) so callers cannot tell a fleet from one
engine, and adds exactly the mechanics a fleet needs:

**Prefix-affinity placement.** A replica's prefix cache only pays off if
requests sharing a prefix land on the SAME replica — random spraying
divides every shared prefix's hit rate by N. The router hashes each
prompt's leading page-aligned chunks with the prefix cache's own rolling
chain hash (:func:`~mxnet_tpu_torch.serving.kvcache._chain_key` —
byte-for-byte the keys the replica's index will hold) and keeps a bounded
prefix→replica map: the deepest known chunk wins, so a fleet's hit ratio
tracks a single replica's. Cold prefixes place by rendezvous (highest-
random-weight) hashing over live replicas — deterministic, no
coordination, minimal reshuffling when membership changes.

**Tenant-aware spillover.** Affinity is a preference, not a pin: when the
affine replica sheds (queue full, tenant breaker) or is already loaded
past ``MXNET_FLEET_SPILL_DEPTH`` in-flight requests, the router spills to
the live replica carrying the least of THIS tenant's traffic (then least
total) — per-tenant weights, budgets and breakers keep holding fleet-wide
because every replica runs the same tenancy config and the spill order
follows the tenant's own footprint.

**Replica lifecycle.** ``add_replica()`` / ``drain_replica()`` ride the
engine's own ``close(drain=True)`` (which reports how many requests
finished during the drain), and ``rolling_swap()`` upgrades weights one
replica at a time so a bad artifact is caught after 1/N of the fleet,
with zero dropped requests end to end.

**Failure containment.** Each replica sits behind its own
:class:`~mxnet_tpu_torch.resilience.breaker.CircuitBreaker` (site
``serving.fleet.<fleet>.replica.<i>``), one level above the engine's
internal breaker. When a replica dies (``kill_replica``, or the chaos
site ``serving.fleet.replica.<i>``), its in-flight requests fail inside
the engine, and each failure's done-callback re-routes the request
through the router — dedup-guarded by the router-owned caller Future, so
a request can never complete twice — while the dead replica's index
entries are tombstoned and a daemon thread rebuilds the replica.

**SLO-driven autoscaling.** ``autoscale_tick()`` (optionally a background
loop via ``MXNET_FLEET_AUTOSCALE_S``) reads the telemetry SLO engine:
a firing ``QueueDepthBurn`` on any replica spawns one (up to
``MXNET_FLEET_MAX_REPLICAS``); sustained occupancy collapse across every
replica drains the coldest. Every decision lands in the flight recorder
(``fleet.scale``).

Lock discipline (the tpulint contract): the router owns ONE plain lock
guarding its maps and counters. Engine calls — ``submit``, ``close``,
``swap_params``, ``stats``, anything that takes the engine's condition
variable or joins a thread — happen strictly OUTSIDE it. The engine
resolves request futures off its own lock, so done-callbacks may take
the router lock without forming a cycle. Replica leases (the
``replica-lease`` protocol row) are acquired when a request routes and
released on its terminal — or transferred when it re-routes.

The router registers a ``fleet`` view on ``/debug/state``
(:func:`~mxnet_tpu_torch.telemetry.httpd.register_debug_view`): per-replica
breaker state, queue depth, pages in use, and the last scale event.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import telemetry
from ..telemetry import flightrec as _flightrec
from ..telemetry import httpd as _httpd
from ..telemetry import slo as _slo
from ..telemetry import tracing as _tracing
from ..base import MXNetError, get_env
from ..resilience import CircuitBreaker, chaos
from .batcher import (EngineUnavailableError, QueueFullError,
                      RequestTimeoutError, ServerClosedError)
from .decode import DecodeEngine
from .kvcache import _chain_key
from .tenancy import (DEFAULT_TENANT, TenantUnavailableError,
                      aggregate_snapshots)

__all__ = ["FleetRouter", "fleet_debug_state"]

_F_REPLICAS = telemetry.gauge(
    "mxnet_fleet_replicas",
    "live replicas behind the fleet router",
    labels=("fleet",))
_F_ROUTED = telemetry.counter(
    "mxnet_fleet_routed_total",
    "routing decisions: affine (prefix-index hit), rendezvous (cold "
    "placement), spill (affinity overridden by load/shed)",
    labels=("fleet", "decision"))
_F_RESUBMITS = telemetry.counter(
    "mxnet_fleet_resubmits_total",
    "requests re-routed off a dead replica (each re-routed request "
    "still completes exactly once)",
    labels=("fleet",))
_F_SCALE = telemetry.counter(
    "mxnet_fleet_scale_events_total",
    "autoscaler decisions (action=up|down)",
    labels=("fleet", "action"))
_F_IMBALANCE = telemetry.gauge(
    "mxnet_fleet_load_imbalance",
    "max/mean in-flight requests over live replicas (1.0 = perfectly "
    "balanced; FleetImbalanceBurn watches this)",
    labels=("fleet",))

_FLEET_SEQ = itertools.count(1)


def _rendezvous_score(key: bytes, name: str) -> int:
    return int.from_bytes(
        hashlib.sha1(key + name.encode("utf-8")).digest()[:8], "big")


class _FleetRequest:
    """One caller request: the router-owned Future plus everything needed
    to (re-)route it. The caller's Future is resolved exactly once —
    every resolution site checks ``done()`` first, and the fleet trace's
    idempotent terminal is the audit trail."""

    __slots__ = ("rid", "prompt", "max_new", "eos_id", "tenant",
                 "tenant_id", "keys", "deadline", "timeout_disabled",
                 "future", "trace", "attempts", "tried", "t0", "replica")

    _RID = itertools.count(1)

    def __init__(self, prompt: np.ndarray, max_new: int,
                 eos_id: Optional[int], tenant: Optional[str],
                 tenant_id: str):
        self.rid = next(self._RID)
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.tenant = tenant
        self.tenant_id = tenant_id
        self.keys: List[bytes] = []
        self.deadline: Optional[float] = None
        self.timeout_disabled = False
        self.future: Future = Future()
        self.trace = None
        self.attempts = 0
        self.tried: set = set()
        self.t0 = time.perf_counter()
        self.replica: Optional[int] = None

    def remaining_ms(self) -> Optional[float]:
        """Per-attempt engine deadline: the ORIGINAL deadline's remaining
        budget, so re-routes don't reset the caller's clock."""
        if self.timeout_disabled:
            return 0.0
        if self.deadline is None:
            return None
        return max(1.0, (self.deadline - time.perf_counter()) * 1e3)


class _Replica:
    """Router-side record of one engine: its state machine (live →
    draining|dead → restarting → live), breaker, and the lease
    bookkeeping behind spillover and imbalance tracking.

    Lease methods are called with the router lock HELD (they touch
    shared maps); they never call into the engine."""

    __slots__ = ("index", "name", "engine", "state", "breaker", "routed",
                 "deaths", "inflight", "tenant_inflight", "__weakref__")

    def __init__(self, index: int, name: str, engine: DecodeEngine,
                 breaker: CircuitBreaker):
        self.index = index
        self.name = name
        self.engine = engine
        self.state = "live"
        self.breaker = breaker
        self.routed = 0
        self.deaths = 0
        self.inflight: Dict[int, _FleetRequest] = {}
        self.tenant_inflight: Dict[str, int] = {}

    def acquire_lease(self, fr: _FleetRequest) -> None:
        """Route-time: the request now occupies one of this replica's
        slots/queue entries (router's view)."""
        self.inflight[fr.rid] = fr
        self.tenant_inflight[fr.tenant_id] = \
            self.tenant_inflight.get(fr.tenant_id, 0) + 1
        self.routed += 1
        fr.replica = self.index

    def release_lease(self, fr: _FleetRequest) -> None:
        """Terminal: the request left this replica (completed, failed, or
        was rejected at its door). Idempotent."""
        if self.inflight.pop(fr.rid, None) is None:
            return
        n = self.tenant_inflight.get(fr.tenant_id, 0) - 1
        if n > 0:
            self.tenant_inflight[fr.tenant_id] = n
        else:
            self.tenant_inflight.pop(fr.tenant_id, None)

    def transfer_lease(self, fr: _FleetRequest) -> None:
        """Re-route: the lease leaves WITH the request (released here,
        re-acquired on whichever replica the router picks next)."""
        self.release_lease(fr)


# every live router, for the /debug/state "fleet" view — weak so a
# dropped router disappears from the view without an unregister call
_ROUTERS: "weakref.WeakValueDictionary[str, FleetRouter]" = \
    weakref.WeakValueDictionary()


def fleet_debug_state() -> Dict[str, dict]:
    """The ``fleet`` key of ``/debug/state``: every live router's
    :meth:`FleetRouter.debug_state`, keyed by fleet name."""
    out = {}
    for name, router in sorted(_ROUTERS.items()):
        try:
            out[name] = router.debug_state()
        except Exception as exc:  # noqa: BLE001 - one wedged fleet must
            # not blank the debug view for the others
            out[name] = {"error": repr(exc)}
    return out


_httpd.register_debug_view("fleet", fleet_debug_state)


class FleetRouter:
    """M process-local :class:`DecodeEngine` replicas behind the
    single-engine surface. See the module docstring for the design.

    ``factory(name)`` must return a fresh, independently-warmed-up-able
    ``DecodeEngine`` named ``name`` — the router calls it at
    construction (``replicas`` times), on ``add_replica()``, and when
    rebuilding a dead replica. Replicas must NOT share tenancy
    registries or caches (each engine owns its own).
    """

    def __init__(self, factory: Callable[[str], DecodeEngine],
                 replicas: Optional[int] = None,
                 name: Optional[str] = None,
                 max_replicas: Optional[int] = None,
                 min_replicas: Optional[int] = None):
        if replicas is None:
            replicas = get_env("MXNET_FLEET_REPLICAS", 1, int, cache=False)
        replicas = max(1, int(replicas))
        self._name = name or ("fleet%d" % next(_FLEET_SEQ))
        self._factory = factory
        self._lock = threading.Lock()
        self._closed = False
        self._replicas: List[_Replica] = []
        self._next_index = 0
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._index_cap = max(
            256, get_env("MXNET_FLEET_INDEX_CAP", 65536, int, cache=False))
        self._affinity_pages = max(
            1, get_env("MXNET_FLEET_AFFINITY_PAGES", 8, int, cache=False))
        self._max_reroutes = max(
            0, get_env("MXNET_FLEET_MAX_REROUTES", 3, int, cache=False))
        self._breaker_threshold = max(
            1, get_env("MXNET_FLEET_BREAKER_THRESHOLD", 1, int, cache=False))
        self._breaker_reset_s = get_env(
            "MXNET_FLEET_BREAKER_RESET_S", 5.0, float, cache=False)
        self._cooldown_s = get_env(
            "MXNET_FLEET_SCALE_COOLDOWN_S", 30.0, float, cache=False)
        self._down_occ = get_env(
            "MXNET_FLEET_SCALE_DOWN_OCC", 0.1, float, cache=False)
        self._down_window_s = get_env(
            "MXNET_FLEET_SCALE_DOWN_WINDOW_S", 60.0, float, cache=False)
        if min_replicas is None:
            min_replicas = get_env("MXNET_FLEET_MIN_REPLICAS", 1, int,
                                   cache=False)
        self._min_replicas = max(1, int(min_replicas))
        if max_replicas is None:
            max_replicas = get_env("MXNET_FLEET_MAX_REPLICAS", 0, int,
                                   cache=False)
        # 0 = "whatever the fleet started with": scale-UP is opt-in
        self._max_replicas = int(max_replicas) if max_replicas else replicas
        self._variants: Dict[str, object] = {}
        # per-tenant speculative draft caps, re-applied to every replica
        # a restart or scale-up builds (mirrors the variant store)
        self._spec_overrides: Dict[str, Optional[int]] = {}
        self._last_scale: Optional[dict] = None
        self._last_scale_t = -float("inf")
        self._restarts: List[threading.Thread] = []
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._resubmitted = 0
        for _ in range(replicas):
            self._replicas.append(self._build_replica())
        first = self._replicas[0].engine
        self._page_size = int(first.page_size)
        spill = get_env("MXNET_FLEET_SPILL_DEPTH", 0, int, cache=False)
        # auto: twice the slot count — past that the affine replica's
        # queue is deep enough that a cold prefill elsewhere wins
        self._spill_depth = int(spill) if spill > 0 else 2 * first.num_slots
        _F_REPLICAS.set(float(len(self._replicas)), fleet=self._name)
        _ROUTERS[self._name] = self
        self._stop_autoscale = threading.Event()
        self._autoscale_thread: Optional[threading.Thread] = None
        autoscale_s = get_env("MXNET_FLEET_AUTOSCALE_S", 0.0, float,
                              cache=False)
        if autoscale_s > 0:
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop, args=(autoscale_s,),
                name="mxnet-fleet-autoscale-%s" % self._name, daemon=True)
            self._autoscale_thread.start()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _build_replica(self) -> _Replica:
        """Build replica #next via the factory — NOT yet in the routing
        set (the caller appends under the lock once it's ready). The
        factory itself runs lock-free: it compiles."""
        with self._lock:
            index = self._next_index
            self._next_index += 1
            variants = list(self._variants.items())
            spec_caps = list(self._spec_overrides.items())
        rname = "%s.r%d" % (self._name, index)
        engine = self._factory(rname)
        for vname, vparams in variants:
            engine.register_variant(vname, vparams)
        for tid, cap in spec_caps:
            engine.set_tenant_spec_k(tid, cap)
        breaker = CircuitBreaker(
            "serving.%s.replica.%d" % (self._name, index),
            failure_threshold=self._breaker_threshold,
            reset_timeout_s=self._breaker_reset_s)
        return _Replica(index, rname, engine, breaker)

    @property
    def name(self) -> str:
        return self._name

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _prefix_keys(self, arr: np.ndarray) -> List[bytes]:
        """The prompt's leading page-aligned chunk keys — the SAME rolling
        chain the replica prefix caches index by, capped at
        ``MXNET_FLEET_AFFINITY_PAGES`` chunks (placement needs the head
        of the prefix, not the whole prompt)."""
        ps = self._page_size
        n = min(arr.size // ps, self._affinity_pages)
        keys: List[bytes] = []
        parent = b""
        for c in range(n):
            parent = _chain_key(parent, arr[c * ps:(c + 1) * ps])
            keys.append(parent)
        if not keys:
            # sub-page prompt: no shareable pages, but a whole-prompt
            # digest still makes repeat placement deterministic
            keys.append(_chain_key(b"", arr))
        return keys

    def _routable_locked(self, fr: _FleetRequest) -> List[_Replica]:
        return [r for r in self._replicas
                if r.state == "live" and r.index not in fr.tried
                and r.breaker.state != "open"]

    def _pick_replica_locked(self, fr: _FleetRequest):
        """Choose a replica (and acquire its lease) under the router
        lock. Returns ``(replica, decision)`` or ``(None, None)`` when
        every live replica has been tried or is breaker-open."""
        live = self._routable_locked(fr)
        if not live:
            return None, None
        rep = None
        decision = "affine"
        for key in reversed(fr.keys):  # deepest known chunk wins
            idx = self._index.get(key)
            if idx is None:
                continue
            rep = next((r for r in live if r.index == idx), None)
            if rep is not None:
                break
        if rep is None:
            decision = "rendezvous"
            rep = max(live, key=lambda r: _rendezvous_score(fr.keys[0],
                                                            r.name))
        if len(rep.inflight) >= self._spill_depth and len(live) > 1:
            # tenant-aware spillover: least of THIS tenant's in-flight
            # traffic first, then least total — weights/budgets keep
            # holding fleet-wide because the spill follows the tenant
            decision = "spill"
            rep = min(live, key=lambda r: (
                r.tenant_inflight.get(fr.tenant_id, 0),
                len(r.inflight), r.index))
        rep.acquire_lease(fr)
        fr.attempts += 1
        fr.tried.add(rep.index)
        self._update_imbalance_locked()
        return rep, decision

    def _update_imbalance_locked(self) -> None:
        counts = [len(r.inflight) for r in self._replicas
                  if r.state == "live"]
        if not counts or sum(counts) == 0:
            val = 1.0
        else:
            val = max(counts) / (sum(counts) / float(len(counts)))
        _F_IMBALANCE.set(val, fleet=self._name)

    def _upsert_index_locked(self, keys: List[bytes], index: int) -> None:
        for key in keys:
            self._index[key] = index
            self._index.move_to_end(key)
        while len(self._index) > self._index_cap:
            self._index.popitem(last=False)

    def _tombstone_locked(self, index: int) -> int:
        """Drop every index entry pointing at a dead/drained replica —
        its pages are gone; affinity to it would be pure miss."""
        stale = [k for k, v in self._index.items() if v == index]
        for k in stale:
            del self._index[k]
        return len(stale)

    # ------------------------------------------------------------------
    # submit path
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Single-engine surface: enqueue one sequence on SOME replica;
        returns a Future resolving to the generated ``np.int32`` token
        ids. Thread-safe. Same rejection semantics as
        :meth:`DecodeEngine.submit` — a request every replica sheds
        raises, with the last replica's reason."""
        arr = np.asarray(prompt, np.int32).ravel()
        if arr.size < 1:
            raise MXNetError("fleet submit needs >= 1 prompt token")
        tid = str(tenant) if tenant is not None else DEFAULT_TENANT
        fr = _FleetRequest(arr, int(max_new_tokens), eos_id, tenant, tid)
        if timeout_ms is not None:
            if float(timeout_ms) <= 0:
                fr.timeout_disabled = True
            else:
                fr.deadline = time.perf_counter() + float(timeout_ms) / 1e3
        fr.keys = self._prefix_keys(arr)
        fr.trace = _tracing.start_trace("fleet", self._name, tid)
        _tracing.event(fr.trace, "submit", prompt_tokens=int(arr.size),
                       max_new=fr.max_new, rid=fr.rid)
        with self._lock:
            if self._closed:
                _tracing.finish(fr.trace, "rejected", reason="closed")
                raise ServerClosedError("submit() on a closed FleetRouter")
            self._submitted += 1
        self._route_and_submit(fr, sync=True)
        return fr.future

    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 tenant: Optional[str] = None) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           tenant=tenant).result(timeout)

    def _route_and_submit(self, fr: _FleetRequest, sync: bool) -> None:
        """Route ``fr`` to a replica and hand it to that engine. Spills
        to the next candidate on door-rejects; exhausting every live
        replica fails the request with the last reason. ``sync`` raises
        (submit-path) instead of failing the caller Future (re-route
        path). Never called with the router lock held."""
        last_exc: Optional[Exception] = None
        while True:
            if fr.future.done():
                return  # dedup guard: the request already resolved
            if fr.deadline is not None and \
                    time.perf_counter() > fr.deadline:
                self._finish_error(
                    fr, RequestTimeoutError(
                        "deadline expired while routing (after %d attempts)"
                        % fr.attempts), sync)
                return
            with self._lock:
                if self._closed:
                    rep = None
                    last_exc = ServerClosedError(
                        "FleetRouter closed while routing")
                else:
                    rep, decision = self._pick_replica_locked(fr)
            if rep is None:
                exc = last_exc or EngineUnavailableError(
                    "no live replica admits the request "
                    "(every breaker open or replica tried)")
                self._finish_error(fr, exc, sync)
                return
            try:
                # the chaos site that kills replica <i> at routing time —
                # the acceptance drill for failure containment
                chaos.maybe_fail("serving.fleet.replica.%d" % rep.index)
            except Exception as exc:  # noqa: BLE001 - any injected fault
                # means "this replica just died": contain and re-route
                with self._lock:
                    rep.transfer_lease(fr)
                self._kill_replica(rep, exc)
                last_exc = exc
                continue
            try:
                sub = rep.engine.submit(
                    fr.prompt, fr.max_new, eos_id=fr.eos_id,
                    timeout_ms=fr.remaining_ms(), tenant=fr.tenant)
            except (QueueFullError, TenantUnavailableError,
                    ServerClosedError) as exc:
                # door-reject: this replica sheds, the next may not —
                # spillover continues through the remaining candidates
                with self._lock:
                    rep.release_lease(fr)
                    self._update_imbalance_locked()
                last_exc = exc
                continue
            except Exception as exc:  # noqa: BLE001 - validation and
                # everything else is request-shaped, identical on every
                # replica: propagate, don't spin through the fleet
                with self._lock:
                    rep.release_lease(fr)
                    self._update_imbalance_locked()
                self._finish_error(fr, exc, sync)
                return
            _F_ROUTED.inc(fleet=self._name, decision=decision)
            _tracing.event(fr.trace, "replica_route", replica=rep.name,
                           decision=decision, attempt=fr.attempts)
            with self._lock:
                self._upsert_index_locked(fr.keys, rep.index)
            sub.add_done_callback(
                lambda f, fr=fr, rep=rep: self._on_replica_done(fr, rep, f))
            return

    def _on_replica_done(self, fr: _FleetRequest, rep: _Replica,
                         sub: Future) -> None:
        """Replica future resolved. Runs on the engine worker (or the
        killer thread) with NO engine lock held — taking the router lock
        here is acyclic by construction."""
        exc = None if sub.cancelled() else sub.exception()
        if exc is None:
            with self._lock:
                rep.release_lease(fr)
                self._update_imbalance_locked()
            rep.breaker.on_success()
            self._finish_ok(fr, rep, sub.result())
            return
        with self._lock:
            reroute = (isinstance(exc, ServerClosedError)
                       and rep.state != "live" and not self._closed
                       and fr.attempts <= self._max_reroutes
                       and not fr.future.done())
            if reroute:
                rep.transfer_lease(fr)
                fr.tried.clear()  # new round: every live replica eligible
                self._resubmitted += 1
            else:
                rep.release_lease(fr)
            self._update_imbalance_locked()
        if reroute:
            _F_RESUBMITS.inc(fleet=self._name)
            _tracing.event(fr.trace, "resubmit", from_replica=rep.name,
                           error=type(exc).__name__)
            self._route_and_submit(fr, sync=False)
        else:
            self._finish_error(fr, exc, sync=False)

    def _finish_ok(self, fr: _FleetRequest, rep: _Replica, tokens) -> None:
        _tracing.finish(
            fr.trace, "complete", replica=rep.name, attempts=fr.attempts,
            tokens=int(np.asarray(tokens).size),
            latency_ms=round((time.perf_counter() - fr.t0) * 1e3, 3))
        if fr.future.done():
            return
        if fr.future.set_running_or_notify_cancel():
            with self._lock:
                self._completed += 1
            fr.future.set_result(tokens)

    def _finish_error(self, fr: _FleetRequest, exc: Exception,
                      sync: bool) -> None:
        if isinstance(exc, (QueueFullError, TenantUnavailableError,
                            EngineUnavailableError)):
            kind = "shed"
        elif isinstance(exc, RequestTimeoutError):
            kind = "timeout"
        else:
            kind = "error"
        _tracing.finish(fr.trace, kind, error=type(exc).__name__,
                        attempts=fr.attempts)
        with self._lock:
            self._failed += 1
        if sync:
            raise exc
        if fr.future.done():
            return
        if fr.future.set_running_or_notify_cancel():
            fr.future.set_exception(exc)

    # ------------------------------------------------------------------
    # replica lifecycle
    # ------------------------------------------------------------------
    def _resolve_replica(self, which) -> _Replica:
        with self._lock:
            for rep in self._replicas:
                if rep.index == which or rep.name == which:
                    return rep
        raise MXNetError("fleet %r has no replica %r" % (self._name, which))

    def add_replica(self, warmup: bool = True) -> str:
        """Spawn (and by default warm up) one more replica; returns its
        name. The new replica takes traffic as soon as it is appended —
        cold prefixes rendezvous onto it, warm ones stay put."""
        with self._lock:
            if self._closed:
                raise ServerClosedError("add_replica() on a closed fleet")
        rep = self._build_replica()
        if warmup:
            rep.engine.warmup()
        stale = False
        with self._lock:
            if self._closed:
                stale = True
            else:
                self._replicas.append(rep)
            n = len([r for r in self._replicas if r.state == "live"])
        if stale:
            rep.engine.close(drain=False)
            raise ServerClosedError("fleet closed while adding a replica")
        _F_REPLICAS.set(float(n), fleet=self._name)
        _flightrec.record("fleet.replica_added", fleet=self._name,
                          replica=rep.name, live=n)
        return rep.name

    def drain_replica(self, which, timeout: Optional[float] = None) -> int:
        """Gracefully retire one replica: stop routing to it, let its
        queued + in-flight requests finish (``close(drain=True)``), then
        drop it from the fleet. Returns the number of requests that
        completed during the drain — the zero-drop receipt."""
        rep = self._resolve_replica(which)
        with self._lock:
            if rep.state != "live":
                raise MXNetError("replica %s is %s, not live"
                                 % (rep.name, rep.state))
            rep.state = "draining"
            tombstoned = self._tombstone_locked(rep.index)
        drained = rep.engine.close(drain=True, timeout=timeout)
        rep.engine.release()
        with self._lock:
            rep.state = "drained"
            self._replicas.remove(rep)
            n = len([r for r in self._replicas if r.state == "live"])
        _F_REPLICAS.set(float(n), fleet=self._name)
        _flightrec.record("fleet.replica_drained", fleet=self._name,
                          replica=rep.name, drained_completed=drained,
                          tombstoned=tombstoned, live=n)
        return drained

    def kill_replica(self, which, restart: bool = True,
                     exc: Optional[Exception] = None) -> None:
        """Abruptly kill one replica (the failure-containment drill the
        chaos site automates): its in-flight requests re-route through
        the router, its breaker opens, its index entries tombstone, and
        (by default) a daemon thread rebuilds it."""
        rep = self._resolve_replica(which)
        self._kill_replica(
            rep, exc or MXNetError("replica %s killed" % rep.name),
            restart=restart)

    def _kill_replica(self, rep: _Replica, exc: Exception,
                      restart: bool = True) -> None:
        with self._lock:
            if rep.state != "live":
                return  # racing kills: first one wins
            rep.state = "dead"
            rep.deaths += 1
            tombstoned = self._tombstone_locked(rep.index)
            inflight = len(rep.inflight)
            restart = restart and not self._closed
        rep.breaker.on_failure()  # threshold 1 → open: routing skips it
        _flightrec.record("fleet.replica_dead", fleet=self._name,
                          replica=rep.name, error=repr(exc),
                          inflight=inflight, tombstoned=tombstoned,
                          restarting=restart)
        # fail-fast close: every queued/slotted future fails with
        # ServerClosedError on THIS thread; each failure's done-callback
        # re-routes its request (dedup-guarded) before close() returns
        dead = rep.engine
        dead.close(drain=False)
        if restart:
            t = threading.Thread(
                target=self._restart_replica, args=(rep, dead),
                name="mxnet-fleet-restart-%s" % rep.name, daemon=True)
            with self._lock:
                self._restarts.append(t)
            t.start()
        else:
            dead.release()

    def _restart_replica(self, rep: _Replica, dead: DecodeEngine) -> None:
        # the dead engine's graphs and pools go back to the card BEFORE
        # the factory builds their replacements (this thread is never
        # that engine's worker, so its exit can be awaited here)
        dead.release()
        with self._lock:
            if self._closed:
                return
            rep.state = "restarting"
            variants = list(self._variants.items())
            spec_caps = list(self._spec_overrides.items())
        try:
            engine = self._factory(rep.name)
            for vname, vparams in variants:
                engine.register_variant(vname, vparams)
            for tid, cap in spec_caps:
                engine.set_tenant_spec_k(tid, cap)
            engine.warmup()
        except Exception as exc:  # noqa: BLE001 - a replica that cannot
            # be rebuilt stays failed; the rest of the fleet carries on
            with self._lock:
                rep.state = "failed"
            _flightrec.record("fleet.restart_failed", fleet=self._name,
                              replica=rep.name, error=repr(exc))
            return
        stale = None
        with self._lock:
            if self._closed:
                stale = engine
            else:
                rep.engine = engine
                rep.state = "live"
        if stale is not None:
            stale.close(drain=False)
            return
        rep.breaker.on_success()  # probe passed: close the breaker
        _flightrec.record("fleet.replica_restarted", fleet=self._name,
                          replica=rep.name, deaths=rep.deaths)

    def register_variant(self, name: str, params) -> None:
        """Stage a named weight set on every replica (current AND future
        — restarts and scale-ups re-register it), for
        :meth:`rolling_swap` by variant name."""
        with self._lock:
            self._variants[str(name)] = params
            reps = [r for r in self._replicas if r.state == "live"]
        for rep in reps:
            rep.engine.register_variant(name, params)

    def configure_speculation(self, tenant_id: str,
                              spec_k: Optional[int]) -> None:
        """Set (or clear, with ``None``) one tenant's speculative draft
        cap fleet-wide: applied to every live replica now and re-applied
        to every replica a restart or scale-up builds — the lever that
        stops one slow-accepting tenant burning every replica's tick
        budget on rejected verify rows. Caps only lower the engines'
        compiled ``spec_k``; no replica recompiles."""
        with self._lock:
            self._spec_overrides[str(tenant_id)] = spec_k
            reps = [r for r in self._replicas if r.state == "live"]
        for rep in reps:
            rep.engine.set_tenant_spec_k(tenant_id, spec_k)

    def rolling_swap(self, params=None, variant: Optional[str] = None,
                     timeout: Optional[float] = None) -> int:
        """Upgrade weights one replica at a time — each swap applies at
        that replica's next tick boundary with zero dropped requests and
        zero recompiles (the engine's live-swap contract), so a bad
        artifact is caught after 1/N of the fleet. Pass ``params`` (with
        an optional ``variant`` label) or just ``variant`` to promote a
        :meth:`register_variant` set. Returns replicas swapped."""
        if params is None and variant is None:
            raise MXNetError("rolling_swap needs params or a variant name")
        with self._lock:
            reps = [r for r in self._replicas if r.state == "live"]
        swapped = 0
        for rep in reps:
            with self._lock:
                if rep.state != "live":
                    continue
            if params is not None:
                rep.engine.swap_params(params, variant=variant, wait=True,
                                       timeout=timeout)
            else:
                rep.engine.use_variant(variant, wait=True, timeout=timeout)
            swapped += 1
            _flightrec.record("fleet.rolling_swap_step", fleet=self._name,
                              replica=rep.name, variant=variant,
                              step=swapped, of=len(reps))
        return swapped

    def warmup(self) -> int:
        """Compile every replica's ladder; returns total compiles."""
        with self._lock:
            reps = [r for r in self._replicas if r.state == "live"]
        return sum(rep.engine.warmup() for rep in reps)

    # ------------------------------------------------------------------
    # autoscaling
    # ------------------------------------------------------------------
    def autoscale_tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One control-loop step against the SLO engine: a firing
        ``QueueDepthBurn`` on any replica spawns one (up to the max);
        occupancy collapse across EVERY live replica (window mean below
        ``MXNET_FLEET_SCALE_DOWN_OCC``) drains the coldest. Returns the
        scale event (also flight-recorded), or None."""
        with self._lock:
            if self._closed:
                return None
        alerts = _slo.evaluate()
        if now is None:
            now = time.monotonic()
        with self._lock:
            if now - self._last_scale_t < self._cooldown_s:
                return None
            live = [r for r in self._replicas if r.state == "live"]
            names = {r.name for r in live}
            # dead/restarting replicas still count toward capacity: a
            # restart in flight IS the scale-up for that deficit
            occupied = len([r for r in self._replicas
                            if r.state in ("live", "dead", "restarting")])
        burning = sorted({a["instance"] for a in alerts
                          if a["alert"] == "QueueDepthBurn"
                          and a["instance"] in names})
        event = None
        if burning and occupied < self._max_replicas:
            added = self.add_replica()
            event = {"action": "up", "replica": added,
                     "reason": "QueueDepthBurn", "instances": burning}
        elif len(live) > self._min_replicas:
            eng = _slo.engine()
            occs = [(eng.mean("mxnet_decode_slot_occupancy", r.name,
                              self._down_window_s), r) for r in live]
            known = [(v, r) for v, r in occs if v is not None]
            if len(known) == len(live) and \
                    all(v < self._down_occ for v, _ in known):
                coldest = min(known, key=lambda t: t[0])[1]
                drained = self.drain_replica(coldest.index)
                event = {"action": "down", "replica": coldest.name,
                         "reason": "occupancy_collapse",
                         "drained_completed": drained}
        if event is not None:
            with self._lock:
                self._last_scale_t = now
                self._last_scale = dict(event)
            _F_SCALE.inc(fleet=self._name, action=event["action"])
            _flightrec.record("fleet.scale", fleet=self._name, **event)
        return event

    def _autoscale_loop(self, interval: float) -> None:
        while not self._stop_autoscale.wait(interval):
            with self._lock:
                if self._closed:
                    return
            try:
                self.autoscale_tick()
            except Exception as exc:  # noqa: BLE001 - the control loop
                # must outlive one bad tick
                _flightrec.record("fleet.autoscale_error",
                                  fleet=self._name, error=repr(exc))

    # ------------------------------------------------------------------
    # observation
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Single-engine surface: fleet-aggregated counters plus each
        replica's full ``DecodeEngine.stats()`` under ``replicas``.
        ``tenants`` is the fleet-wide per-tenant merge
        (:func:`~mxnet_tpu_torch.serving.tenancy.aggregate_snapshots`)."""
        with self._lock:
            reps = list(self._replicas)
            doc = {
                "fleet": self._name,
                "replicas_live": len([r for r in reps
                                      if r.state == "live"]),
                "router": {
                    "submitted": self._submitted,
                    "completed": self._completed,
                    "failed": self._failed,
                    "resubmitted": self._resubmitted,
                    "index_entries": len(self._index),
                    "last_scale": (dict(self._last_scale)
                                   if self._last_scale else None),
                },
            }
        per: Dict[str, dict] = {}
        for rep in reps:
            if rep.state != "live" or rep.engine.closed:
                continue
            try:
                per[rep.name] = rep.engine.stats()
            except Exception as exc:  # noqa: BLE001 - a replica mid-
                # teardown must not fail the fleet-wide read
                per[rep.name] = {"error": repr(exc)}
        good = [s for s in per.values() if "error" not in s]
        hits = sum(s["kvcache"].get("prefix_hits", 0) for s in good)
        misses = sum(s["kvcache"].get("prefix_misses", 0) for s in good)
        doc["replicas"] = per
        doc["queued"] = sum(s.get("queued", 0) for s in good)
        doc["active_slots"] = sum(s.get("active_slots", 0) for s in good)
        doc["slots"] = sum(s.get("slots", 0) for s in good)
        doc["tokens_generated"] = sum(s.get("tokens_generated", 0)
                                      for s in good)
        doc["completed"] = sum(s.get("completed", 0) for s in good)
        doc["steady_state_recompiles"] = sum(
            s.get("steady_state_recompiles", 0) for s in good)
        doc["prefix_hits"] = hits
        doc["prefix_misses"] = misses
        doc["prefix_hit_ratio"] = (hits / (hits + misses)
                                   if hits + misses else 0.0)
        doc["tenants"] = aggregate_snapshots(
            [s.get("tenants", {}) for s in good])
        return doc

    def debug_state(self) -> dict:
        """The ``/debug/state`` ``fleet`` view: cheap, per-replica — no
        full engine stats, no SLO evaluation."""
        with self._lock:
            reps = list(self._replicas)
            doc = {
                "closed": self._closed,
                "replicas": {},
                "index_entries": len(self._index),
                "router": {"submitted": self._submitted,
                           "completed": self._completed,
                           "failed": self._failed,
                           "resubmitted": self._resubmitted},
                "last_scale": (dict(self._last_scale)
                               if self._last_scale else None),
            }
            rows = [(r, len(r.inflight), r.routed, r.deaths, r.state)
                    for r in reps]
        # the pressure governor is process-global (one HBM), so the
        # fleet view carries one tier, not a per-replica copy
        try:
            from ..resilience import hbm as _hbm

            doc["hbm"] = _hbm.governor().healthz_view()
        except Exception:  # noqa: BLE001 - debug view stays up
            doc["hbm"] = None
        for rep, inflight, routed, deaths, state in rows:
            row = {"state": state, "breaker": rep.breaker.state,
                   "inflight": inflight, "routed": routed,
                   "deaths": deaths}
            if state == "live" and not rep.engine.closed:
                try:
                    kv = rep.engine.kvcache_stats()
                    row["pages_in_use"] = kv.get("pages_in_use")
                    row["queue_depth"] = rep.engine.queue_depth()
                except Exception as exc:  # noqa: BLE001 - debug view
                    # stays up when one replica is mid-teardown
                    row["pages_in_use"] = row["queue_depth"] = None
                    row["stats_error"] = repr(exc)
            doc["replicas"][rep.name] = row
        return doc

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> int:
        """Close every replica (``drain=True`` finishes queued + in-
        flight work first). Returns total requests completed during the
        drain across the fleet. Idempotent."""
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
            reps = list(self._replicas)
            restarts = list(self._restarts)
        self._stop_autoscale.set()
        total = 0
        for rep in reps:
            if rep.state in ("live", "draining"):
                total += rep.engine.close(drain=drain, timeout=timeout)
        for t in restarts:
            t.join(timeout if timeout is not None else 10.0)
        if self._autoscale_thread is not None:
            self._autoscale_thread.join(
                timeout if timeout is not None else 10.0)
        _F_REPLICAS.set(0.0, fleet=self._name)
        _flightrec.record("fleet.closed", fleet=self._name,
                          drain=drain, drained_completed=total)
        return total
