"""Deterministic fault injection — failures as a *tested, first-class input*.

Ported as it is from ``mxnet_tpu/resilience/chaos.py``.

Every hardened path in the framework passes through a named **injection
site** before doing its fault-prone work::

    chaos.maybe_fail("kvstore.push")

With chaos disabled (the default, and whenever ``MXNET_CHAOS`` is unset)
that call is a single module-global boolean read — no lock, no environment
read, no allocation — the same discipline as ``MXNET_TELEMETRY=0``.

Enabled, faults are **seeded and schedule-driven**, so a chaos run is a
reproducible experiment, not a flake generator::

    MXNET_CHAOS="seed=7,site=kvstore.*,p=0.1"

Spec DSL — ``;``-separated rules of ``,``-separated ``key=value`` pairs:

========  ==================================================================
key       meaning
========  ==================================================================
seed      global RNG seed (any rule may set it; the last one wins)
site      glob matched against the site name (default ``*``)
p         per-call fault probability in [0, 1] (default 0)
at        colon-separated 1-based call indices that *always* fault
          (per rule, per site), e.g. ``at=2:5`` — the deterministic
          schedule for "the 3rd push fails" tests
max       cap on total faults injected by the rule (default unlimited)
action    what an injection does (default ``fault``):

          * ``fault`` — raise :class:`FaultInjected` (a transient error,
            exercised by the retry/breaker machinery);
          * ``kill`` — raise :class:`Killed`: an abrupt process death at
            that call (kill-at-step preemption). NOT transient — nothing
            retries it; it unwinds to the elastic supervisor
            (``elastic.run_elastic``), which restarts from the last
            committed checkpoint;
          * ``torn-write`` — raise :class:`TornWrite`: the elastic shard
            writer catches it and commits deliberately truncated bytes
            (a silently torn write — bitrot, a filesystem that lied
            about fsync), proving restore's content-hash fallback;
          * ``drop-shard`` — raise :class:`DropShard`: the shard writer
            skips that shard's file entirely (post-commit loss), proving
            the missing-file fallback;
          * ``oom`` — raise :class:`OOMInjected`: a synthetic
            ``RESOURCE_EXHAUSTED`` allocator failure that
            :func:`~mxnet_tpu_torch.resilience.hbm.classify` recognizes, so an
            injected OOM takes the *identical* survival path as a real
            one (eviction + governor red latch on the decode plane,
            diagnostic dump + fallback on the train planes). Subclasses
            :class:`FaultInjected` but is exempted from retry by the
            retry policy's OOM guard — retrying a failed allocation
            against a full device is not recovery. Aim it at the
            dispatch/transfer/page-write sites: ``serving.decode``
            (mid-tick), ``serving.decode.prefill`` (page writes),
            ``jit.compile`` (any jitted dispatch, incl. train steps),
            ``transfer.fetch_host``.
========  ==================================================================

Determinism contract: each (rule, site) pair draws from its own
``random.Random`` stream seeded by ``seed/rule-index/site``, so the k-th
call at a site faults identically across runs regardless of how other
sites interleave (thread timing cannot leak between streams). Retries
consume draws like any other call, which keeps retried schedules
reproducible too.

Registered sites in this package (grep ``maybe_fail`` for ground truth):
``transfer.fetch_host``, ``transfer.asnumpy``, ``jit.compile`` (a
captured path's replay: the decode engine's and the training plane's),
``serving.decode``, ``serving.decode.prefill``,
``serving.decode.tenant.<id>`` (one site per tenant — scope a schedule to
ONE tenant's requests with e.g. ``site=serving.decode.tenant.A`` to prove
tenant isolation),
``serving.fleet.replica.<i>`` (one site per fleet replica — a fault
there kills the whole replica at routing time and must cost zero
requests: the router re-routes its in-flight set and restarts it),
``ckpt.commit``.

Injected faults raise :class:`FaultInjected` — a
:class:`~mxnet_tpu_torch.resilience.policies.TransientError` — so they
exercise exactly the retry/breaker machinery a real transient fault would,
and every injection ticks ``mxnet_faults_injected_total{site}``.
"""
from __future__ import annotations

import fnmatch
import random
import threading
from typing import Dict, List, Optional, Tuple

from ..base import MXNetError, get_env
from .policies import TransientError

__all__ = ["FaultInjected", "ChaosAction", "Killed", "TornWrite",
           "DropShard", "OOMInjected", "maybe_fail", "configure",
           "disable", "active", "parse_spec", "injected_counts",
           "summary", "ENABLED"]


class FaultInjected(TransientError):
    """A synthetic fault raised by :func:`maybe_fail`."""

    def __init__(self, site: str, call_index: int):
        super().__init__("chaos: injected fault at %s (call #%d)"
                         % (site, call_index))
        self.site = site
        self.call_index = call_index


class ChaosAction(MXNetError):
    """Base of the non-``fault`` schedule actions. Deliberately NOT a
    :class:`TransientError`: a simulated process kill or torn write must
    reach the layer that owns that failure mode (the elastic supervisor,
    the shard writer) — a retry policy "recovering" it would fake the
    very resilience the schedule exists to prove."""

    action = "action"

    def __init__(self, site: str, call_index: int):
        super().__init__("chaos: injected %s at %s (call #%d)"
                         % (self.action, site, call_index))
        self.site = site
        self.call_index = call_index


class Killed(ChaosAction):
    """Simulated abrupt process death (``action=kill`` — kill-at-step)."""

    action = "kill"


class TornWrite(ChaosAction):
    """Simulated silently-torn file write (``action=torn-write``)."""

    action = "torn-write"


class DropShard(ChaosAction):
    """Simulated post-commit loss of one shard file (``action=drop-shard``)."""

    action = "drop-shard"


class OOMInjected(FaultInjected):
    """Simulated allocator exhaustion (``action=oom``): the message
    carries the literal ``RESOURCE_EXHAUSTED`` status text of the JAX
    package's, and ``hbm.classify`` recognizes the type directly —
    injected and real OOM share one survival code path. A
    :class:`FaultInjected` by inheritance (a handler of injected faults
    sees it too), but the
    retry policy's OOM guard refuses to retry it: allocation failures
    are cured by freeing memory, not by calling again."""

    def __init__(self, site: str, call_index: int):
        # deliberately bypass FaultInjected.__init__'s message
        TransientError.__init__(
            self, "chaos: injected oom at %s (call #%d): "
            "RESOURCE_EXHAUSTED: out of memory (synthetic)"
            % (site, call_index))
        self.site = site
        self.call_index = call_index


_ACTIONS = {"fault": None, "kill": Killed, "torn-write": TornWrite,
            "torn": TornWrite, "drop-shard": DropShard, "drop": DropShard,
            "oom": OOMInjected}


#: THE disabled-path switch: ``maybe_fail`` reads this module global and
#: nothing else when chaos is off. Flip only through configure()/disable().
ENABLED = False

_STATE: Optional["_ChaosState"] = None

_FAULTS = None


def _faults_counter():
    global _FAULTS
    if _FAULTS is None:
        from .. import telemetry

        _FAULTS = telemetry.counter(
            "mxnet_faults_injected_total",
            "synthetic faults raised by the chaos harness per site",
            labels=("site",))
    return _FAULTS


class _Rule:
    __slots__ = ("pattern", "p", "at", "max_faults", "injected", "action")

    def __init__(self, pattern: str = "*", p: float = 0.0,
                 at: Tuple[int, ...] = (), max_faults: Optional[int] = None,
                 action: str = "fault"):
        self.pattern = pattern
        self.p = p
        self.at = frozenset(at)
        self.max_faults = max_faults
        self.injected = 0
        self.action = action


def parse_spec(spec: str) -> Tuple[int, List[_Rule]]:
    """Parse the chaos DSL; raises :class:`MXNetError` on malformed input
    (a silently-ignored typo in a chaos spec would fake resilience)."""
    seed = 0
    rules: List[_Rule] = []
    for chunk in str(spec).split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        rule = _Rule()
        for tok in chunk.split(","):
            tok = tok.strip()
            if not tok:
                continue
            key, sep, val = tok.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or not val:
                raise MXNetError("chaos spec: %r is not key=value" % tok)
            try:
                if key == "seed":
                    seed = int(val)
                elif key == "site":
                    rule.pattern = val
                elif key == "p":
                    rule.p = float(val)
                    if not 0.0 <= rule.p <= 1.0:
                        raise ValueError(val)
                elif key == "at":
                    rule.at = frozenset(int(x) for x in val.split(":"))
                    if any(i < 1 for i in rule.at):
                        raise ValueError(val)
                elif key == "max":
                    rule.max_faults = int(val)
                elif key == "action":
                    if val not in _ACTIONS:
                        raise MXNetError(
                            "chaos spec: unknown action %r (choose from %s)"
                            % (val, "/".join(sorted(set(_ACTIONS)))))
                    rule.action = val
                else:
                    raise MXNetError("chaos spec: unknown key %r in %r"
                                     % (key, tok))
            except (TypeError, ValueError):
                raise MXNetError("chaos spec: bad value in %r" % tok)
        if rule.p == 0.0 and not rule.at:
            raise MXNetError(
                "chaos spec: rule %r injects nothing (set p= or at=)" % chunk)
        rules.append(rule)
    return seed, rules


class _ChaosState:
    """All enabled-path state behind one lock: per-(rule, site) call
    counters and RNG streams, per-site injected totals."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed, self.rules = parse_spec(spec)
        self._lock = threading.Lock()
        self._calls: Dict[Tuple[int, str], int] = {}
        self._rngs: Dict[Tuple[int, str], random.Random] = {}
        self._injected: Dict[str, int] = {}

    def maybe_fail(self, site: str) -> None:
        with self._lock:
            for idx, rule in enumerate(self.rules):
                if not fnmatch.fnmatchcase(site, rule.pattern):
                    continue
                key = (idx, site)
                n = self._calls.get(key, 0) + 1
                self._calls[key] = n
                hit = n in rule.at
                if not hit and rule.p > 0.0:
                    rng = self._rngs.get(key)
                    if rng is None:
                        # string seeding is stable across runs and python
                        # versions — the determinism contract rests on it
                        rng = self._rngs[key] = random.Random(
                            "%d/%d/%s" % (self.seed, idx, site))
                    hit = rng.random() < rule.p
                if hit and (rule.max_faults is None
                            or rule.injected < rule.max_faults):
                    rule.injected += 1
                    self._injected[site] = self._injected.get(site, 0) + 1
                    _faults_counter().inc(site=site)
                    # black box: the injected fault is very often THE
                    # event that precedes a death — the dump must name it
                    from ..telemetry import flightrec

                    flightrec.record("chaos.fault", site=site,
                                     action=rule.action, call=n)
                    exc_cls = _ACTIONS.get(rule.action)
                    if exc_cls is not None:
                        raise exc_cls(site, n)
                    raise FaultInjected(site, n)

    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._injected)


def maybe_fail(site: str) -> None:
    """Raise a seeded synthetic fault at ``site`` per the active schedule.
    Disabled (the default): one boolean read, nothing else."""
    if not ENABLED:
        return
    # snapshot: disable() on another thread clears ENABLED then _STATE, and
    # a caller between the two reads must degrade to a no-op, not crash
    state = _STATE
    if state is not None:
        state.maybe_fail(site)


def configure(spec: Optional[str]) -> None:
    """Install a chaos schedule (empty/None disables). Counters and RNG
    streams restart from zero — configure() begins a fresh experiment."""
    global ENABLED, _STATE
    if not spec:
        ENABLED = False
        _STATE = None
        return
    _STATE = _ChaosState(str(spec))
    ENABLED = True


def disable() -> None:
    configure(None)


class active:
    """Context manager scoping a chaos schedule to a block (tests)::

        with chaos.active("seed=7,site=kvstore.*,p=0.1"):
            train()
    """

    def __init__(self, spec: str):
        self.spec = spec
        self._prev = None

    def __enter__(self):
        self._prev = (ENABLED, _STATE)
        configure(self.spec)
        return self

    def __exit__(self, *exc):
        global ENABLED, _STATE
        ENABLED, _STATE = self._prev
        return False


def injected_counts() -> Dict[str, int]:
    """Per-site totals of faults injected by the active schedule (empty
    when disabled — or when nothing fired yet)."""
    state = _STATE
    return state.injected_counts() if state is not None else {}


def summary() -> Dict:
    """One dict for bench/report lines: the active spec + per-site fault
    counts (``{"enabled": False}`` when off)."""
    state = _STATE
    if not ENABLED or state is None:
        return {"enabled": False}
    return {"enabled": True, "spec": state.spec, "seed": state.seed,
            "faults_injected": state.injected_counts()}


# Import-time activation: a launcher exporting MXNET_CHAOS gets injection
# without code changes (tests use configure()/active() instead — the knob
# is read ONCE here, never per call).
_spec = get_env("MXNET_CHAOS", "", str, cache=False)
if _spec:
    configure(_spec)
del _spec
