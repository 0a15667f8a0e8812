"""Flight recorder: the black box a dead process leaves behind.

The port of ``mxnet_tpu/telemetry/flightrec.py``. The JSONL emitter
covers *metrics* over time but says nothing about *events* — which
breaker tripped, which sequences were in flight, which chaos fault fired
on the tick that killed the run. This module keeps a bounded, lock-cheap
ring of structured events published by the planes the framework already
instruments:

* breaker transitions (engine + per-tenant),
* decode-plane ticks (the in-flight request set, per tick), evictions,
  deadline evictions and weight swaps,
* chaos faults, fleet replica lifecycle and scale events,
* HBM pressure-tier edges (``hbm.pressure``), watermarks
  (``hbm.watermark``) and classified-OOM survival diagnostics
  (``hbm.oom``, carrying the governor's full per-plane memory breakdown
  and the caching allocator's counters — the OOM post-mortem artifact).

On a death path — the decode engine-thread catch-all, a classified OOM,
SIGTERM — :func:`dump` commits the ring atomically (tmp + fsync + rename
+ directory fsync) so a death leaves a readable black box.

Cost discipline: :func:`record` checks the ``MXNET_TELEMETRY`` master
switch first (one module-global read, nothing else when off) and appends
to a ``deque(maxlen=)`` — a GIL-atomic operation, no lock on the record
path. Only :func:`dump`/:func:`tail` snapshot the ring.

Knobs (the JAX package's names): ``MXNET_FLIGHTREC_CAPACITY`` (ring
size, default 4096), ``MXNET_FLIGHTREC_PATH`` (dump destination, default
``flightrec.json``).
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, List, Optional

from ..base import get_env
from . import registry as _registry

__all__ = ["record", "tail", "dump", "clear", "configure",
           "install_signal_dump", "last_dump_path"]

_DEFAULT_CAPACITY = 4096
_DEFAULT_PATH = "flightrec.json"

#: The ring. deque.append is atomic under the GIL, so concurrent
#: publishers (engine worker, submit threads, breaker transitions) never
#: need a lock; maxlen makes "bounded" structural.
_RING: "collections.deque" = collections.deque(
    maxlen=max(16, get_env("MXNET_FLIGHTREC_CAPACITY", _DEFAULT_CAPACITY,
                           int, cache=False)))

_LAST_DUMP: List[Optional[str]] = [None]
_SIGNAL_INSTALLED = [False]


def configure(capacity: Optional[int] = None) -> None:
    """Resize the ring (drops recorded events; tests)."""
    global _RING
    if capacity is not None:
        _RING = collections.deque(maxlen=max(16, int(capacity)))


def record(kind: str, /, **fields) -> None:
    """Append one structured event: ``kind`` plus JSON-ish fields (which
    may not themselves be named ``kind`` — positional-only enforces it).
    Free when ``MXNET_TELEMETRY=0`` (one module-global read); otherwise
    one dict build + one GIL-atomic deque append — cheap enough for the
    decode plane to call once per tick."""
    if not _registry.ENABLED:
        return
    ev = dict(fields) if fields else {}
    ev["t"] = time.perf_counter()
    ev["ts"] = time.time()
    ev["kind"] = kind  # authoritative: a same-named field cannot mask it
    _RING.append(ev)


def _snapshot_ring() -> List[Dict[str, Any]]:
    """Copy the ring while publishers keep appending: deque iteration
    raises RuntimeError if it races a mutation, so retry — the ring is
    small and appends are rare relative to the copy."""
    for _ in range(16):
        try:
            return list(_RING)
        except RuntimeError:
            continue
    return []


def tail(n: int = 200) -> List[Dict[str, Any]]:
    """The most recent ``n`` events, oldest first."""
    snap = _snapshot_ring()
    return snap[-int(n):] if n else snap


def clear() -> None:
    _RING.clear()


def last_dump_path() -> Optional[str]:
    """Where the most recent :func:`dump` committed (None if never)."""
    return _LAST_DUMP[0]


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Commit the ring to disk atomically and return the path.

    tmp + fsync + rename + directory fsync, so a power-losing death right
    after the dump still leaves either the previous black box or the new
    one — never a torn file. Never raises:
    a recorder that takes down the run it observes (read-only fs, ring
    holding an unserializable field) would be worse than no recorder;
    unserializable fields degrade through ``default=repr``.
    """
    if path is None:
        path = get_env("MXNET_FLIGHTREC_PATH", _DEFAULT_PATH, str,
                       cache=False)
    doc = {
        "reason": reason,
        "ts": time.time(),
        "t": time.perf_counter(),
        "pid": os.getpid(),
        "events": _snapshot_ring(),
    }
    try:
        data = json.dumps(doc, default=repr).encode()
        _atomic_write(path, data)
    except BaseException:  # noqa: BLE001 - the black box is best-effort
        return None
    _LAST_DUMP[0] = path
    return path


def _atomic_write(path: str, data: bytes) -> None:
    """The elastic commit idiom WITHOUT ``elastic.atomic_write``'s
    ``ckpt.commit`` chaos site or its retry policy: the dump runs on
    death paths where an injected fault or a retry sleep must not stand
    between the evidence and the disk."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)),
                     os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - file-system dependent
        pass
    finally:
        os.close(fd)


def install_signal_dump() -> bool:
    """Install a SIGTERM handler (main thread only) that dumps the ring
    before the process dies — the serving-plane counterpart of the
    elastic preemption listener. Chains any previously-installed
    handler; with none, re-raises the default SIGTERM exit so the
    process still terminates. Idempotent."""
    import threading

    if _SIGNAL_INSTALLED[0]:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        import signal

        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            record("signal", signum=int(signum))
            dump("SIGTERM")
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                # the process deliberately ignored SIGTERM before we
                # installed: keep ignoring — a black-box hook must not
                # turn an ignored signal into process death
                return
            else:
                # default disposition: restore it and re-deliver so the
                # exit status still reads as killed-by-SIGTERM
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, handler)
        _SIGNAL_INSTALLED[0] = True
        return True
    except (ValueError, OSError):  # pragma: no cover - restricted env
        return False
