"""Server: bounded queue + deadline-driven micro-batcher + robustness policy.

Ported from ``mxnet_tpu/serving/batcher.py`` with its behaviour: concurrent
``submit()`` calls land requests in a bounded queue; a single batcher
thread anchors a micro-batch window (``MXNET_SERVING_MAX_DELAY_MS``) at the
oldest queued request, collects until the top bucket fills or the window
closes, pads to the smallest bucket that fits
(:mod:`~mxnet_tpu_torch.serving.buckets`) and hands one fixed-shape batch to
the :class:`~mxnet_tpu_torch.serving.engine.Engine`. On the card each
bucket is one CUDA graph the engine captured at its first run (at
:meth:`Server.warmup`), so the steady state replays and never captures
again. Every request resolves through its own
``concurrent.futures.Future``.

Robustness policy, in the order a request meets it:

* **validation** — shape/dtype are checked in ``submit`` on the caller's
  thread; malformed input never reaches the batch;
* **load shedding** — a full queue (``MXNET_SERVING_QUEUE_DEPTH``) rejects
  at ``submit`` with :class:`QueueFullError`;
* **per-request timeout** — requests whose queue wait exceeds their
  deadline (``MXNET_SERVING_TIMEOUT_MS``) fail with
  :class:`RequestTimeoutError` at batch-assembly time;
* **engine retry** — each engine run is the ``serving.engine`` chaos site
  and executes under the resilience retry policy;
* **breaker + fallback** — every engine carries a
  :class:`~mxnet_tpu_torch.resilience.CircuitBreaker`
  (site ``serving.<name>.<role>``, role ``primary``/``fallback``); when
  the primary exhausts its retries the batch falls to the next engine in
  the chain (``fallback_engine`` — canonically a :class:`BlockEngine`
  behind a :class:`StableHLOEngine`), and an open breaker skips its
  engine until the reset timeout admits a half-open probe;
* **engine load-shed** — with every breaker open the batch fails fast
  with :class:`EngineUnavailableError`, counted in
  ``stats()['unavailable']``;
* **error isolation** — if a non-transient error poisons a batch, the
  batcher re-runs each member alone: only the poisoned request(s) receive
  the exception;
* **graceful drain** — ``close()`` stops intake, serves everything queued,
  then joins the batcher thread; ``close(drain=False)`` fails queued
  requests with :class:`ServerClosedError` immediately.

The decode engine answers its futures with the same error classes.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np

from .. import resilience, telemetry
from ..base import MXNetError, get_env, np_dtype
from ..resilience import CircuitBreaker, chaos
from ..telemetry import flightrec as _flightrec
from ..telemetry import slo as _slo
from ..telemetry import tracing as _tracing
from .buckets import bucket_ladder, pad_to_bucket, select_bucket
from .engine import Engine
from .stats import ServingStats

__all__ = ["Server", "ServingError", "QueueFullError", "RequestTimeoutError",
           "ServerClosedError", "EngineUnavailableError"]

_DEFAULT_MAX_DELAY_MS = 2.0
_DEFAULT_QUEUE_DEPTH = 256
_DEFAULT_TIMEOUT_MS = 1000.0


class ServingError(MXNetError):
    """Base class of serving-policy failures."""


class QueueFullError(ServingError):
    """Load shed: the bounded submit queue is at capacity."""


class RequestTimeoutError(ServingError):
    """The request's deadline expired while it waited in the queue."""


class ServerClosedError(ServingError):
    """Submitted to (or still queued in) a closed server."""


class EngineUnavailableError(ServingError):
    """Every engine's circuit breaker is open: the request is shed at the
    engine layer (explicit fast failure instead of queueing work no engine
    will run)."""


class _Request:
    __slots__ = ("data", "future", "t_submit", "deadline", "tenant",
                 "trace")

    def __init__(self, data, deadline, tenant=None, trace=None):
        self.data = data
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        self.tenant = tenant
        self.trace = trace


def _tenancy():
    # deferred: tenancy imports this module for the error hierarchy, so
    # the batcher reaches back lazily (first Server construction)
    from . import tenancy
    return tenancy


class _EngineSlot:
    """One engine in the serve chain: the engine, its circuit breaker and
    the name both report under."""

    __slots__ = ("name", "engine", "breaker")

    def __init__(self, name: str, engine: Engine, breaker: CircuitBreaker):
        self.name = name
        self.engine = engine
        self.breaker = breaker


class Server:
    """Thread-safe dynamic-batching inference service over one Engine.

    Parameters mirror the ``MXNET_SERVING_*`` knobs and win over them when
    given explicitly; ``sample_shape`` is the per-request shape without the
    batch axis. Results delivered through futures are views into the
    batched output array (zero-copy); copy before mutating.

    ``name`` must be unique among live servers in the process: serving
    stats series and the per-engine breaker gauge
    (``serving.<name>.<role>``) key on it, and a second server reusing a
    name writes over the first one's series.

    ``fallback_engine`` extends the serve chain for degraded mode (the
    canonical pairing: a StableHLO artifact primary with the live
    BlockEngine behind it); each engine gets its own circuit breaker
    (``breaker_threshold`` consecutive batch failures open it,
    ``breaker_reset_s`` later a half-open probe may close it — defaults
    from ``MXNET_RESILIENCE_BREAKER_*``). ``retry_policy`` overrides the
    shared resilience policy for engine runs.
    """

    def __init__(self, engine: Engine, sample_shape: Sequence[int],
                 dtype="float32", buckets: Optional[Sequence[int]] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 timeout_ms: Optional[float] = None, name: str = "serving",
                 fallback_engine: Optional[Engine] = None,
                 retry_policy: Optional["resilience.RetryPolicy"] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 tenants=None):
        self._engine = engine
        self._sample_shape = tuple(int(d) for d in sample_shape)
        self._dtype = np.dtype(np_dtype(dtype))
        self._ladder = bucket_ladder(buckets)
        if max_delay_ms is None:
            max_delay_ms = get_env("MXNET_SERVING_MAX_DELAY_MS",
                                   _DEFAULT_MAX_DELAY_MS, float, cache=False)
        if queue_depth is None:
            queue_depth = get_env("MXNET_SERVING_QUEUE_DEPTH",
                                  _DEFAULT_QUEUE_DEPTH, int, cache=False)
        if timeout_ms is None:
            timeout_ms = get_env("MXNET_SERVING_TIMEOUT_MS",
                                 _DEFAULT_TIMEOUT_MS, float, cache=False)
        self._max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self._queue_depth = max(1, int(queue_depth))
        self._timeout_s = float(timeout_ms) / 1e3
        self._stats = ServingStats(name)
        self._name = name
        self._retry = retry_policy
        engines = [("primary", engine)]
        if fallback_engine is not None:
            engines.append(("fallback", fallback_engine))
        self._slots = [
            _EngineSlot(role, eng, CircuitBreaker(
                "serving.%s.%s" % (name, role),
                failure_threshold=breaker_threshold,
                reset_timeout_s=breaker_reset_s))
            for role, eng in engines]
        # multi-tenant control plane (docs/serving.md §tenancy): the
        # same weighted-fair sub-queue machinery as the decode engine,
        # costed per REQUEST (batch rows are fungible — no page budgets
        # here, weights apportion batch-slot share)
        ten = _tenancy()
        if isinstance(tenants, ten.TenantRegistry):
            self._tenants = tenants
        else:
            self._tenants = ten.TenantRegistry(
                server=name, spec=tenants, max_cost=1.0,
                default_queue_depth=self._queue_depth)
        self._wfq = ten.WeightedFairQueue(self._tenants)
        # burn-ratio denominator for the SLO engine's QueueDepthBurn
        _slo.note_bound("queue_depth", name, self._queue_depth)
        self._warm_compiles: Optional[int] = None
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mxnet-serving-" + name)
        self._thread.start()

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------
    def submit(self, x, timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one request; returns its Future. Thread-safe.

        ``timeout_ms`` overrides the server default for this request;
        ``<= 0`` disables the deadline. ``tenant`` names the submitting
        tenant (:mod:`~mxnet_tpu_torch.serving.tenancy`; untagged callers ride
        ``default``). Raises :class:`ServerClosedError` /
        :class:`QueueFullError` / :class:`TenantUnavailableError`
        synchronously — shed work costs the caller one host array copy,
        never a device cycle.
        """
        arr = np.asarray(x, dtype=self._dtype)
        if arr.shape != self._sample_shape:
            raise MXNetError(
                "serving request shape %s != sample_shape %s"
                % (arr.shape, self._sample_shape))
        tobj = self._tenants.resolve(tenant)
        # trace minted at submit() (MXNET_TRACE_SAMPLE-gated) — the
        # batch plane's hops: enqueue, batch, complete/timeout/shed
        trace = _tracing.start_trace("batch", self._name, tobj.tenant_id)
        _tracing.event(trace, "submit")
        state = tobj.breaker.state
        if state == "open":
            # per-tenant shed: this tenant's poisoned/failing traffic is
            # refused at the door while every other tenant keeps serving
            tobj.stats.on_shed(breaker=True)
            _tracing.finish(trace, "shed", reason="tenant_breaker")
            raise _tenancy().TenantUnavailableError(tobj.tenant_id, state)
        timeout_s = (self._timeout_s if timeout_ms is None
                     else float(timeout_ms) / 1e3)
        deadline = (None if timeout_s <= 0
                    else time.perf_counter() + timeout_s)
        req = _Request(arr, deadline, tobj, trace)
        shed = None
        depth = 0
        with self._cv:
            if self._closed:
                raise ServerClosedError("submit() on a closed Server")
            if len(tobj.queue) >= tobj.queue_depth:
                shed = "tenant %r queue full (depth %d): request shed " \
                       "before the global queue" \
                       % (tobj.tenant_id, tobj.queue_depth)
            elif self._wfq.total_queued() >= self._queue_depth:
                shed = "serving queue full (depth %d): request shed" \
                       % self._queue_depth
            else:
                depth = self._wfq.push(tobj, req)
                gdepth = self._wfq.total_queued()
                self._cv.notify_all()
        if shed:
            self._stats.on_shed()
            tobj.stats.on_shed()
            _tracing.finish(trace, "shed", reason="queue_full")
            raise QueueFullError(shed)
        _tracing.event(trace, "enqueue", tenant_depth=depth,
                       queue_depth=gdepth)
        self._stats.on_submit(gdepth)
        tobj.stats.on_submit(depth)
        return req.future

    def refresh_params(self) -> int:
        """Live weight swap for the batch plane: re-snapshot the current
        parameter values of every engine in the chain that supports it
        (:meth:`BlockEngine.refresh_params`). The swap lands between
        batch executions — in-flight batches finish on the old weights,
        queued requests serve on the new ones, nothing is dropped.
        Returns the number of engines refreshed."""
        n = 0
        for slot in self._slots:
            fn = getattr(slot.engine, "refresh_params", None)
            if fn is not None:
                fn()
                n += 1
        return n

    def warmup(self) -> int:
        """Run one dummy batch per bucket so every rung is captured (on
        the card, a CUDA graph a rung) before traffic arrives — on EVERY
        engine in the chain, so a breaker trip degrades onto a warm
        fallback instead of capturing under duress; returns the primary
        engine's compile count. After warmup, a steady-state serve
        captures nothing. The worker thread replays what this thread
        captured: each engine runs on its own stream, so the replay does
        not depend on either thread's current stream."""
        for slot in self._slots:
            for b in self._ladder:
                slot.engine.run(np.zeros((b,) + self._sample_shape,
                                         self._dtype))
        count = self._engine.compile_count
        # anchor for the steady-state-recompile gauge: any compile the
        # engine does past this point violates the compile-once promise.
        # No gauge when the engine can't count compiles (-1) — a constant
        # 0 that was never measured would defeat the alert it feeds.
        self._warm_compiles = count if count >= 0 else None
        if self._warm_compiles is not None:
            telemetry.set_steady_state_recompiles("serving." + self._name, 0)
        return count

    def stats(self) -> dict:
        """Snapshot of serving metrics (see ``ServingStats.snapshot``),
        plus the engine's ``compile_count``, the bucket ladder, and — once
        :meth:`warmup` has run — ``steady_state_recompiles`` (compiles
        since warmup; the bucket ladder exists so this stays 0, and the
        ``mxnet_steady_state_recompiles`` gauge lets a scraper alert on
        it)."""
        out = self._stats.snapshot()
        count = self._engine.compile_count
        out["compile_count"] = count
        out["buckets"] = list(self._ladder)
        out["breakers"] = {slot.name: slot.breaker.state
                           for slot in self._slots}
        out["tenants"] = self._tenants.snapshot()
        out["alerts"] = _slo.evaluate()
        if self._warm_compiles is not None and count >= 0:
            steady = count - self._warm_compiles
            out["steady_state_recompiles"] = steady
            telemetry.set_steady_state_recompiles(
                "serving." + self._name, steady)
        return out

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop intake; by default serve everything already queued, then
        stop the batcher thread. ``drain=False`` fails queued requests
        with :class:`ServerClosedError` instead. ``timeout`` bounds the
        thread join (seconds; ``None`` waits for the full drain) — the
        batcher is a daemon thread, so a bounded close abandons a wedged
        in-flight batch rather than hanging the caller. Idempotent."""
        with self._cv:
            self._closed = True
            dropped: List[_Request] = []
            if not drain:
                dropped = [req for _t, req in self._wfq.drain()]
            self._cv.notify_all()
        for req in dropped:
            self._fail(req, ServerClosedError("server closed before serve"))
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def tenants(self):
        """The server's tenant registry
        (:class:`~mxnet_tpu_torch.serving.tenancy.TenantRegistry`)."""
        return self._tenants

    # ------------------------------------------------------------------
    # batcher thread
    # ------------------------------------------------------------------
    def _tenant_guard(self, tenant, req) -> bool:
        """Admission veto for the weighted-fair pick: a tenant whose
        breaker refuses is deferred (its queued work sheds in
        :meth:`_shed_tenant_breakers`), everyone else fills the batch.
        The non-consuming state check runs first; ``allow()`` (which may
        consume the half-open probe) only when the pop will happen."""
        if tenant.breaker.state == "open":
            _tracing.event(req.trace, "defer", reason="breaker")
            return False
        if not tenant.breaker.allow():
            _tracing.event(req.trace, "defer", reason="breaker")
            return False
        return True

    def _shed_tenant_breakers(self):
        """Queued work of tenants whose breaker is OPEN is answered now
        with :class:`TenantUnavailableError` — that tenant alone."""
        dropped = []
        for tenant in self._tenants:
            if tenant.queue and tenant.breaker.state == "open":
                with self._cv:
                    dropped.extend(self._wfq.drain(tenant))
        exc_cls = _tenancy().TenantUnavailableError
        for tenant, req in dropped:
            tenant.stats.on_shed(breaker=True)
            _tracing.finish(req.trace, "shed", reason="tenant_breaker")
            self._fail(req, exc_cls(tenant.tenant_id, "open"))

    def _worker(self):
        top = self._ladder[-1]
        while True:
            self._shed_tenant_breakers()
            batch: List[_Request] = []
            expired: List[_Request] = []
            with self._cv:
                while not self._wfq.total_queued() and not self._closed:
                    self._cv.wait()
                if not self._wfq.total_queued():  # closed and drained
                    return
                # window anchored at the oldest queued request: no
                # request waits on coalescing longer than max_delay,
                # regardless of how traffic trickles in behind it
                oldest = self._wfq.oldest_submit()
                window_end = oldest + self._max_delay_s
                while self._wfq.total_queued() < top and not self._closed:
                    remaining = window_end - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                now = time.perf_counter()
                # weighted-fair batch fill: rows picked by priority class
                # + deficit round robin, not arrival order — a hot
                # tenant's backlog cannot monopolize the bucket
                while len(batch) < top:
                    picked = self._wfq.pop(self._tenant_guard)
                    if picked is None:
                        break
                    tenant, req = picked
                    tenant.stats.set_depth(len(tenant.queue))
                    if req.deadline is not None and now > req.deadline:
                        expired.append(req)
                    else:
                        batch.append(req)
                depth = self._wfq.total_queued()
            for req in expired:
                self._stats.on_timeout()
                if req.tenant is not None:
                    req.tenant.stats.on_timeout()
                _tracing.finish(req.trace, "timeout", where="queued")
                self._fail(req, RequestTimeoutError(
                    "request spent > its deadline queued"))
            if not batch:
                if not expired:
                    # queued work exists but every tenant is deferred
                    # (half-open probes in flight): yield, don't spin
                    time.sleep(0.001)
                continue
            try:
                bucket = select_bucket(len(batch), self._ladder)
                padded = pad_to_bucket([r.data for r in batch], bucket,
                                       self._dtype)
                for req in batch:
                    _tracing.event(req.trace, "batch", bucket=bucket,
                                   real_rows=len(batch),
                                   queue_wait_ms=round(
                                       (now - req.t_submit) * 1e3, 3))
                self._stats.on_batch(len(batch), bucket, depth)
                self._run_batch(batch, padded)
            except Exception as exc:  # noqa: BLE001 - batcher must survive
                # e.g. a custom engine returning malformed output: fail the
                # batch's futures instead of killing the batcher thread and
                # hanging every later request
                self._stats.on_error()
                for req in batch:
                    self._fail(req, exc)

    def _engine_run(self, padded: np.ndarray):
        """One padded batch through the engine chain.

        Each admitted engine runs under the retry policy at chaos site
        ``serving.engine``; an engine that still fails reports to its
        breaker and the batch degrades to the next slot. With no slot
        admitted (every breaker open) the batch is shed with
        :class:`EngineUnavailableError` — serving answers *something* for
        every request, it never wedges on a dead engine.
        """
        # explicit retry_policy wins; otherwise look the shared default up
        # per batch so reset_default_policy()/changed knobs reach a live
        # server (default_policy() is a cached read — no per-batch cost)
        policy = self._retry or resilience.default_policy()
        last_exc: Optional[BaseException] = None
        for slot in self._slots:
            if not slot.breaker.allow():
                continue

            def attempt(engine=slot.engine):
                chaos.maybe_fail("serving.engine")
                return engine.run(padded)

            try:
                out = policy.call(attempt, site="serving.engine")
            except Exception as exc:  # noqa: BLE001 - degrade, don't die
                slot.breaker.on_failure()
                self._stats.on_engine_failure(slot.name)
                _flightrec.record("serving.engine_failure",
                                  server=self._name, engine=slot.name,
                                  error=repr(exc))
                last_exc = exc
                continue
            slot.breaker.on_success()
            if slot is not self._slots[0]:
                # a fallback serve is a fleet-health event (degraded
                # mode), not just a counter — the black box keeps it
                self._stats.on_fallback(slot.name)
                _flightrec.record("serving.fallback", server=self._name,
                                  engine=slot.name)
            return out
        if last_exc is not None:
            raise last_exc
        raise EngineUnavailableError(
            "every engine breaker is open (%s): request shed"
            % {s.name: s.breaker.state for s in self._slots})

    def _run_batch(self, reqs: List[_Request], padded: np.ndarray):
        try:
            out = self._engine_run(padded)
        except EngineUnavailableError as exc:
            # engine-layer load shed: per-request reruns would ask the same
            # open breakers again — answer every future explicitly now
            self._stats.on_unavailable(len(reqs))
            for req in reqs:
                if req.tenant is not None:
                    req.tenant.stats.on_shed()
                _tracing.finish(req.trace, "shed",
                                reason="engine_unavailable")
                self._fail(req, exc)
            return
        except Exception as exc:  # noqa: BLE001 - isolation boundary
            if len(reqs) == 1:
                self._stats.on_error()
                req = reqs[0]
                if req.tenant is not None:
                    # a solo failure is THIS request's fault (the
                    # isolation rerun already exonerated the batch):
                    # feed the tenant's breaker, so a flood of one
                    # tenant's poison sheds that tenant alone
                    req.tenant.on_request_failure()
                self._fail(req, exc)
                return
            # error isolation: the batch is poisoned by (at least) one
            # member — rerun each alone in the bottom bucket so only the
            # guilty request(s) observe the failure
            self._stats.on_isolation_retry()
            bottom = self._ladder[0]
            for req in reqs:
                # each rerun is a real device execution: record it so
                # batches/bucket_counts/batch_fill track what actually ran
                self._stats.on_batch(1, bottom, None)
                self._run_batch([req], pad_to_bucket([req.data], bottom,
                                                     self._dtype))
            return
        self._deliver(reqs, out)

    def _deliver(self, reqs: List[_Request], out):
        multi = isinstance(out, tuple)
        done = time.perf_counter()
        for i, req in enumerate(reqs):
            result = tuple(o[i] for o in out) if multi else out[i]
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(result)
                lat = (done - req.t_submit) * 1e3
                _tracing.finish(req.trace, "complete",
                                latency_ms=round(lat, 3))
                self._stats.on_complete(lat)
                if req.tenant is not None:
                    req.tenant.stats.on_complete(lat)
                    req.tenant.breaker.on_success()

    @staticmethod
    def _fail(req: _Request, exc: BaseException):
        # generic terminal fallback (specific verdicts finished earlier)
        _tracing.finish(req.trace, "error", error=type(exc).__name__)
        if req.future.done():  # already resolved (only the batcher resolves)
            return
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)
