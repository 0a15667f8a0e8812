"""Preemption-aware elastic training: the port of ``mxnet_tpu/elastic.py``.

- **Liveness**: every rank of a job heartbeats through the job's
  ``TCPStore``; :func:`get_dead_nodes` reports the ranks whose heartbeat
  went stale (reference ``KVStoreDist::GetDeadNodes``, kvstore_dist.h:121).
- **Durability**: :class:`CheckpointManager` commits every file tmp +
  fsync + rename (+ directory fsync), hashes each with sha256 into a
  manifest committed last, keeps a bounded number of epochs and never
  retires the newest committed one. A restore verifies the hashes and
  falls back to the previous committed epoch on a torn or missing file
  (``mxnet_ckpt_corruption_total``). An updater whose states are sharded
  over the job's ranks (``fastpath.zero``) is saved shard by shard, with
  no all-gather: each rank writes its own shard file.
- **Determinism**: a training checkpoint carries the data iterator's
  cursor (``state_dict``/``set_state``), the RNG streams
  (``mx.random.get_state``) and the optimizer's step counters, so a
  killed and resumed run equals the uninterrupted one bit for bit.
- **Preemption**: SIGTERM or ``MXNET_PREEMPTION_FILE`` turns the eviction
  notice into a checkpoint-now at the next :func:`step_boundary` and a
  clean :class:`Preempted` exit.
- **Supervision**: :func:`run_elastic` restarts the training function
  from the last committed epoch, backs off exponentially, treats no
  progress within ``MXNET_ELASTIC_STALL_SECS`` as a hang, resets the
  restart budget when an attempt commits new progress, and sets the
  ``mxnet_elastic_goodput_ratio`` gauge.

Kill-at-step is chaos ``action=kill`` at the ``elastic.step`` site;
``action=torn-write``/``drop-shard`` at ``ckpt.shard`` tear or lose a
committed shard (``resilience.chaos``).

Kept deviations from the JAX package, where one process writes every
shard:

- **A shard file a rank.** In a job each rank writes its own shard,
  ``_shard_path(epoch, rank, dp)``, and its own training-state file (its
  iterator's cursor and RNG streams); rank 0 writes the parameters, the
  sharded layout (``.zmeta``), the replicated slots (``.repl``) or the
  materialized states, and commits the manifest, which names every
  rank's files with their hashes, only after every rank's files are
  committed.
- **The commit's barrier goes through the store.** An async save commits
  on a writer thread; a barrier of collectives on the training group
  issued there, while the main thread issues the step's collectives,
  could cross between ranks. So each rank publishes its entries under a
  key of the save and adds one to the save's count in the job's
  ``TCPStore`` (a connection of the writer's own); rank 0 waits for the
  count, commits the manifest and marks the save done; the other ranks
  wait for that mark. A save is a step of every rank: every rank calls
  ``save_training`` together.
- **No host engine.** ``async_save`` snapshots on the caller and hands
  the writes to one writer thread a manager, which keeps saves in order;
  :meth:`CheckpointManager.wait` joins it and raises what failed.
- **Restore onto any world size.** Every rank reads the manifest and
  every shard, rebuilds the whole per-parameter states
  (``fastpath.zero.states_from_export``) and hands them to
  ``Updater.adopt_states``; the next sharded step takes its own slice.
  The same files restore onto 1, 2 or 4 ranks.
- **Preemption is agreed by every rank.** A SIGTERM or a preemption file
  may reach one rank only, and a sharded save needs all of them: in a
  job, :func:`step_boundary` all-reduces the flag (one small host
  collective a step), so every rank saves the same epoch and raises
  :class:`Preempted` at the same step.
- :meth:`CheckpointManager.save` (the two-file contract) writes this
  process's files only, with no barrier: in a job give each rank its own
  directory, or call it on one rank.
"""
from __future__ import annotations

import atexit
import datetime
import hashlib
import itertools
import json
import logging
import os
import pickle
import queue
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _dist, resilience, telemetry
from .base import MXNetError, get_env
from .resilience import chaos
from .telemetry import CKPT_BYTES
from .telemetry import flightrec as _flightrec

__all__ = ["CheckpointManager", "run_elastic", "commit_bytes",
           "atomic_write", "start_heartbeat", "stop_heartbeat",
           "get_dead_nodes", "Preempted", "StallError", "step_boundary",
           "note_progress", "request_preemption", "clear_preemption",
           "preempt_requested", "start_preemption_watcher"]

_LOG = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# heartbeats over the job's store
# ---------------------------------------------------------------------------

_HB_PREFIX = "mxtpu_heartbeat/"
_hb_thread: Optional[threading.Thread] = None
_hb_stop = threading.Event()


def _hb_key(rank: int) -> str:
    return "%s%d" % (_HB_PREFIX, rank)


def start_heartbeat(interval: float = 2.0) -> bool:
    """Begin publishing this rank's liveness (reference: ps-lite node
    heartbeats to the scheduler). False outside a job of several ranks."""
    global _hb_thread
    grp = _dist.group()
    if grp is None or grp.world <= 1:
        return False
    if _hb_thread is not None and _hb_thread.is_alive():
        return True
    _hb_stop.clear()
    key = _hb_key(grp.rank)
    grp.store.set(key, repr(time.time()))
    conn = _dist.connect_store()

    def beat():
        while not _hb_stop.wait(interval):
            try:
                conn.set(key, repr(time.time()))
            except RuntimeError:  # the store is gone: the job is ending
                return

    _hb_thread = threading.Thread(target=beat, daemon=True,
                                  name="mxtpu-heartbeat")
    _hb_thread.start()
    # joined before the interpreter exits: a thread caught inside a store
    # call at exit aborts the process
    atexit.register(stop_heartbeat)
    return True


def stop_heartbeat() -> None:
    """Stop publishing (the thread is joined); the rank turns stale after
    the readers' timeout."""
    _hb_stop.set()
    if _hb_thread is not None:
        _hb_thread.join(timeout=5.0)


def get_dead_nodes(timeout: float = 10.0) -> List[int]:
    """Ranks whose heartbeat is older than ``timeout`` seconds, or that
    never published one (reference ``KVStoreDist::GetDeadNodes``,
    kvstore_dist.h:121)."""
    grp = _dist.group()
    if grp is None or grp.world <= 1:
        return []
    now = time.time()
    dead = []
    for rank in range(grp.world):
        key = _hb_key(rank)
        if not grp.store.check([key]) or \
                now - float(grp.store.get(key)) > timeout:
            dead.append(rank)
    return dead


# ---------------------------------------------------------------------------
# preemption signal + supervision primitives
# ---------------------------------------------------------------------------


class Preempted(MXNetError):
    """The run is being evicted (SIGTERM or the preemption file): state
    was flushed as far as it could be and the process should exit cleanly
    so the scheduler can reschedule it. :func:`run_elastic` re-raises it
    without spending a restart."""


class StallError(MXNetError):
    """No step progress within ``MXNET_ELASTIC_STALL_SECS``: a hang
    (a wedged device, a deadlocked input pipeline) surfaced as a
    restartable error."""


_PREEMPT = threading.Event()
_PROGRESS_LOCK = threading.Lock()
_PROGRESS = [time.monotonic()]
_SIGTERM_INSTALLED = False
_FILE_WATCHER: Optional[threading.Thread] = None

#: per-thread attempt bookkeeping: the stall watchdog abandons a wedged
#: attempt thread by setting its ``cancelled`` event, and the attempt then
#: stops at its next step boundary
_ATTEMPT_TL = threading.local()


def _attempt_cancelled() -> Optional[threading.Event]:
    return getattr(_ATTEMPT_TL, "cancelled", None)


def note_progress() -> None:
    """Heartbeat of the stall watchdog: :func:`step_boundary` and every
    checkpoint commit call it. An abandoned attempt's calls are dropped."""
    ev = _attempt_cancelled()
    if ev is not None and ev.is_set():
        return
    with _PROGRESS_LOCK:
        _PROGRESS[0] = time.monotonic()


def _last_progress() -> float:
    with _PROGRESS_LOCK:
        return _PROGRESS[0]


def request_preemption() -> None:
    """Raise the preemption flag in this process (tests; operators touch
    ``MXNET_PREEMPTION_FILE`` or send SIGTERM)."""
    _PREEMPT.set()


def clear_preemption() -> None:
    _PREEMPT.clear()


def _preemption_file() -> str:
    return str(get_env("MXNET_PREEMPTION_FILE", "", str, cache=False))


def preempt_requested() -> bool:
    """Whether an eviction notice reached this process: the flag, a
    SIGTERM, or ``MXNET_PREEMPTION_FILE`` existing (polled here too, so
    the notice is seen without the watcher thread)."""
    if _PREEMPT.is_set():
        return True
    path = _preemption_file()
    if path and os.path.exists(path):
        _PREEMPT.set()
        return True
    return False


def start_preemption_watcher(poll_interval: float = 1.0) -> bool:
    """Install the preemption listeners: a SIGTERM handler (on the main
    thread only: CPython delivers signals there) and, when
    ``MXNET_PREEMPTION_FILE`` names a path, a thread polling for it.
    Idempotent; returns whether any listener is active. :func:`run_elastic`
    calls it."""
    global _SIGTERM_INSTALLED, _FILE_WATCHER
    if not _SIGTERM_INSTALLED and \
            threading.current_thread() is threading.main_thread():
        try:
            import signal

            prev = signal.getsignal(signal.SIGTERM)

            def handler(signum, frame):
                _PREEMPT.set()
                # the black box first: a short grace period must not lose
                # the dump to the next step boundary
                _flightrec.record("preemption.sigterm")
                _flightrec.dump("SIGTERM (preemption notice)")
                _LOG.warning("SIGTERM received: the preemption checkpoint "
                             "runs at the next step boundary")
                if callable(prev):
                    try:
                        prev(signum, frame)
                    except Exception:  # noqa: BLE001 - the chained
                        # handler's failure must not lose this notice
                        _LOG.exception("chained SIGTERM handler failed")

            signal.signal(signal.SIGTERM, handler)
            _SIGTERM_INSTALLED = True
        except (ValueError, OSError):  # pragma: no cover - restricted env
            pass
    if (_FILE_WATCHER is None or not _FILE_WATCHER.is_alive()) \
            and _preemption_file():
        def poll():
            while not _PREEMPT.wait(poll_interval):
                path = _preemption_file()
                if path and os.path.exists(path):
                    _PREEMPT.set()
                    return

        _FILE_WATCHER = threading.Thread(target=poll, daemon=True,
                                         name="mxtpu-preempt-watch")
        _FILE_WATCHER.start()
    return _SIGTERM_INSTALLED or _FILE_WATCHER is not None


def _agreed(flag: bool) -> bool:
    """The preemption flag agreed over the job: the maximum of every
    rank's, one small all-reduce of a host tensor (gloo); the flag itself
    outside a job."""
    grp = _dist.group()
    if grp is None or grp.world <= 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    grp.all_reduce([t], "max")
    return bool(t.item())


def step_boundary(manager: Optional["CheckpointManager"] = None,
                  save_fn: Optional[Callable[[], Any]] = None) -> None:
    """The per-step hook of elastic training loops (``trainplane.fit``
    calls it before every batch; a loop of one's own should too):

    1. heartbeats the stall watchdog (:func:`note_progress`);
    2. is the ``elastic.step`` chaos site: ``action=kill`` there is a
       preemption without warning (kill-at-step);
    3. honours a pending preemption, agreed over the job's ranks (a
       collective in a job: every rank calls it at every step): runs
       ``save_fn`` (checkpoint-now, best effort), joins ``manager``'s
       pending saves, counts ``mxnet_preemptions_total`` and raises
       :class:`Preempted` on every rank.

    An attempt the stall watchdog abandoned raises :class:`StallError`
    here, so it cannot train on under its replacement."""
    ev = _attempt_cancelled()
    if ev is not None and ev.is_set():
        raise StallError("attempt was abandoned by the stall watchdog; "
                         "a replacement attempt owns the run now")
    note_progress()
    chaos.maybe_fail("elastic.step")
    if not _agreed(preempt_requested()):
        return
    _PREEMPT.set()
    telemetry.PREEMPTIONS.inc()
    _flightrec.record("preemption.honored")
    if save_fn is not None:
        try:
            save_fn()
        except Exception:  # noqa: BLE001 - best effort by contract: the
            # last committed epoch is still durable
            _LOG.exception("preemption checkpoint-now failed; the run will "
                           "resume from the last committed epoch")
    if manager is not None:
        try:
            manager.wait()
        except Exception:  # noqa: BLE001 - the same best-effort contract
            _LOG.exception("pending async checkpoint failed during "
                           "preemption flush")
    raise Preempted("preemption requested (SIGTERM or %s)"
                    % (_preemption_file() or "request_preemption()"))


# ---------------------------------------------------------------------------
# atomic commits
# ---------------------------------------------------------------------------


def _fsync_file(path: str) -> None:
    """Flush a written file's data to stable storage before it is renamed
    into place."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename) to stable storage; where a
    directory cannot be opened or fsynced, the file system's own ordering
    stands."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - file-system dependent
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable[[str], None]) -> None:
    """tmp + fsync + rename + directory fsync. ``writer(tmp)`` writes the
    contents; a failed attempt removes its temporary file."""
    tmp = path + ".tmp.%d" % os.getpid()
    try:
        writer(tmp)
        _fsync_file(tmp)
        resilience.chaos.maybe_fail("ckpt.commit")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")


def _write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def commit_bytes(path: str, data: bytes, kind: str) -> None:
    """One durable commit of ``data`` to ``path`` under the ``ckpt.commit``
    retry policy, counted in ``mxnet_ckpt_bytes_total{kind}``, recorded
    by the flight recorder and marked as progress for the stall
    watchdog."""
    CKPT_BYTES.inc(len(data), kind=kind)
    resilience.call("ckpt.commit",
                    lambda: atomic_write(path, lambda p: _write_bytes(p, data)))
    _flightrec.record("ckpt.commit", file=os.path.basename(path),
                      artifact=kind, bytes=len(data))
    note_progress()


def _bytes_of(writer: Callable[[str], None]) -> bytes:
    """Run a path-writing serializer into memory: the snapshot half of a
    save (serialize now, on the caller; write later)."""
    fd, tmp = tempfile.mkstemp(suffix=".snap")
    os.close(fd)
    try:
        writer(tmp)
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        os.remove(tmp)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _updater_of(trainer):
    """The state-owning Updater behind a gluon ``Trainer`` or a bare
    ``optimizer.Updater`` (both are taken wherever a ``trainer`` is)."""
    if trainer is None:
        return None
    if hasattr(trainer, "states") and hasattr(trainer, "optimizer"):
        return trainer
    return getattr(trainer, "_updater", None)


def _device_of(trainer):
    ctxs = getattr(trainer, "_contexts", None)
    return ctxs[0].torch_device() if ctxs else None


def _job():
    """This process's group when it is one rank of several, else None."""
    grp = _dist.group()
    return grp if grp is not None and grp.world > 1 else None


class _CorruptCheckpoint(MXNetError):
    """A committed-looking epoch that cannot be restored (a missing file,
    a hash mismatch, an unreadable manifest): restore walks back to an
    older epoch."""


class _Writer(object):
    """One thread that runs a manager's commits in the order they were
    handed over; :meth:`wait` joins them and raises the first failure."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def push(self, fn: Callable[[], None]) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="mxtpu-ckpt-writer")
            self._thread.start()
        self._q.put(fn)

    def _run(self):
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 - raised at wait()
                if self._error is None:
                    self._error = exc
            finally:
                self._q.task_done()

    def wait(self) -> None:
        self._q.join()
        err, self._error = self._error, None
        if err is not None:
            raise err


#: checkpoint managers made in this process, numbered alike on every rank
#: of a job (each rank makes the same managers): the store keys of their
#: saves' barriers
_MANAGERS = itertools.count()


class CheckpointManager(object):
    """Atomic, hashed, bounded-retention checkpoints for elastic resume.

    ==========================  ==========================================
    file                        contents
    ==========================  ==========================================
    ``*.params``                parameters (``Block.save_parameters`` or
                                an ``nd.save`` dict)
    ``*.states``                materialized optimizer states
                                (``Trainer.save_states``)
    ``*.shard{r}-of-{dp}``      rank ``r``'s shards of the sharded states
                                (``fastpath.zero``; no all-gather)
    ``*.repl``                  the replicated slots of a sharded save
                                (the level-1 float32 masters)
    ``*.zmeta``                 the sharded layout and the optimizer with
                                its step counters
    ``*.train``, ``*.train{r}-of-{n}``  the iterator's cursor, the RNG
                                streams and the caller's extra state (one
                                file a rank in a job)
    ``*.manifest.json``         the commit point: every file with its
                                sha256, written last
    ==========================  ==========================================
    """

    def __init__(self, directory: str, prefix: str = "ckpt",
                 max_keep: int = 5):
        self.directory = directory
        self.prefix = prefix
        self.max_keep = max_keep
        self.last_restored_extra: Optional[Dict] = None
        os.makedirs(directory, exist_ok=True)
        self._writer = _Writer()
        self._id = next(_MANAGERS)
        self._saves = itertools.count()
        self._store = None

    # -- paths --------------------------------------------------------------
    def _path(self, epoch: int, suffix: str) -> str:
        return os.path.join(self.directory,
                            "%s-%04d.%s" % (self.prefix, epoch, suffix))

    def _manifest_path(self, epoch: int) -> str:
        return self._path(epoch, "manifest.json")

    def _params_path(self, epoch: int) -> str:
        return self._path(epoch, "params")

    def _states_path(self, epoch: int) -> str:
        return self._path(epoch, "states")

    def _train_path(self, epoch: int, rank: int = 0, world: int = 1) -> str:
        return self._path(epoch, "train" if world <= 1
                          else "train%d-of-%d" % (rank, world))

    def _zmeta_path(self, epoch: int) -> str:
        return self._path(epoch, "zmeta")

    def _repl_path(self, epoch: int) -> str:
        return self._path(epoch, "repl")

    def _shard_path(self, epoch: int, rank: int, dp: int) -> str:
        return self._path(epoch, "shard%d-of-%d" % (rank, dp))

    @staticmethod
    def _torn_write(path: str, data: bytes) -> None:
        """Chaos ``action=torn-write``: a deliberately truncated shard under
        the final name (what a lying fsync or bitrot leaves), which the
        manifest's hash exists to catch."""
        with open(path, "wb") as f:
            f.write(data[:max(1, len(data) // 2)])
        _fsync_file(path)

    # -- save (the two-file contract) ---------------------------------------
    def save(self, epoch: int, net=None, trainer=None,
             params: Optional[Dict] = None,
             metadata: Optional[Dict] = None, async_save: bool = False) -> str:
        """Commit a checkpoint of ``epoch``: ``net``'s parameters (or a raw
        name -> NDArray ``params`` dict) and, with ``trainer``, its
        materialized optimizer states. Everything is serialized now, on
        the caller; with ``async_save`` the files are written by the
        manager's writer thread (:meth:`wait` joins it). This process's
        files only (see the module's docstring)."""
        self.wait()
        payloads = []
        files = {}
        if net is not None:
            payloads.append((self._params_path(epoch), _bytes_of(
                lambda p: net.save_parameters(p)), "params"))
        elif params is not None:
            from .ndarray import io_utils

            payloads.append((self._params_path(epoch), _bytes_of(
                lambda p: io_utils.save(p, params)), "params"))
        if payloads:
            files["params"] = os.path.basename(self._params_path(epoch))
        if trainer is not None:
            payloads.append((self._states_path(epoch), self._states_bytes(
                trainer), "states"))
            files["states"] = os.path.basename(self._states_path(epoch))

        def commit():
            for path, data, kind in payloads:
                commit_bytes(path, data, kind)
            self._commit_manifest(epoch, {
                "epoch": epoch, "time": time.time(), "files": files,
                "metadata": metadata or {}})
            self._retire_old()

        if async_save:
            self._writer.push(commit)
        else:
            commit()
        return self._manifest_path(epoch)

    @staticmethod
    def _states_bytes(trainer) -> bytes:
        if hasattr(trainer, "save_states"):
            return _bytes_of(lambda p: trainer.save_states(p))
        return _updater_of(trainer).get_states(dump_optimizer=True)

    def _commit_manifest(self, epoch: int, manifest: Dict) -> None:
        commit_bytes(self._manifest_path(epoch),
                     json.dumps(manifest).encode("utf-8"), "manifest")

    # -- save (the whole training state) ------------------------------------
    def save_training(self, epoch: int, net=None, trainer=None,
                      params: Optional[Dict] = None, train_iter=None,
                      metadata: Optional[Dict] = None,
                      extra: Optional[Dict] = None, save_rng: bool = True,
                      async_save: bool = False, sharded="auto") -> str:
        """One complete training checkpoint: parameters, optimizer states,
        the iterator's cursor and the RNG streams, committed manifest last
        with a sha256 a file. In a job every rank calls it together.

        Optimizer states (``sharded``): ``"auto"`` saves the shards of a
        sharded updater (``fastpath.zero``; ``MXNET_ZERO`` >= 1 in a job)
        directly, each rank its own, with no all-gather
        (``mxnet_zero_materializations_total`` does not move), and
        otherwise the materialized ``Trainer.save_states``;
        ``MXNET_CKPT_SHARDED=0`` or ``sharded=False`` always materialize.

        ``async_save`` takes only the device-to-host snapshot on the
        caller (``1/N`` of the states a rank on the sharded path) and
        writes, fsyncs and commits on the writer thread while the next
        steps run. A new save first waits for a pending one.
        ``train_iter`` is any iterator with ``state_dict``/``set_state``;
        ``save_rng`` keeps ``mx.random.get_state()``. Returns the
        manifest's path."""
        t0 = time.perf_counter()
        self.wait()
        grp = _job()
        rank, world = (grp.rank, grp.world) if grp is not None else (0, 1)
        lead = rank == 0
        payloads: List[Tuple[str, bytes, str]] = []
        files: Dict[str, str] = {}
        hashes: Dict[str, str] = {}
        mine: Dict[str, List[Dict[str, Any]]] = {"shards": [], "trains": []}

        def add(name: str, path: str, data: bytes, kind: str) -> None:
            payloads.append((path, data, kind))
            files[name] = os.path.basename(path)
            hashes[name] = _sha256(data)

        if lead and net is not None:
            add("params", self._params_path(epoch),
                _bytes_of(lambda p: net.save_parameters(p)), "params")
        elif lead and params is not None:
            from .ndarray import io_utils

            add("params", self._params_path(epoch),
                _bytes_of(lambda p: io_utils.save(p, params)), "params")

        sharded_info = None
        updater = _updater_of(trainer)
        if trainer is not None:
            export = None
            if sharded is not False and \
                    get_env("MXNET_CKPT_SHARDED", 1, int, cache=False):
                export = self._sharded_export(updater)
                if export is None and sharded is True:
                    _LOG.warning("save_training(sharded=True) but no active "
                                 "sharded plane; saving materialized states")
            if export is not None:
                meta, shard, repl = export
                dp = int(meta["dp"])
                data = pickle.dumps(shard)
                path = self._shard_path(epoch, rank, dp)
                payloads.append((path, data, "shard"))
                mine["shards"].append({"file": os.path.basename(path),
                                       "sha256": _sha256(data),
                                       "rank": rank})
                if lead:
                    add("zmeta", self._zmeta_path(epoch),
                        pickle.dumps(meta), "meta")
                    if repl:
                        add("repl", self._repl_path(epoch),
                            pickle.dumps(repl), "repl")
                sharded_info = {"dp": dp, "level": int(meta["level"]),
                                "mesh_shape": meta["mesh_shape"]}
            else:
                from .fastpath import zero

                # materializing is a collective where a plane is attached
                if lead or zero.plane_of(updater) is not None:
                    data = self._states_bytes(trainer)
                    if lead:
                        add("states", self._states_path(epoch), data,
                            "states")

        train_state: Dict[str, Any] = {}
        if train_iter is not None and hasattr(train_iter, "state_dict"):
            train_state["iter"] = train_iter.state_dict()
        if save_rng:
            from . import random as _random

            train_state["rng"] = _random.get_state()
        if extra:
            train_state["extra"] = dict(extra)
        if train_state:
            data = pickle.dumps(train_state)
            path = self._train_path(epoch, rank, world)
            if grp is None:
                add("train", path, data, "train")
            else:
                payloads.append((path, data, "train"))
                mine["trains"].append({"file": os.path.basename(path),
                                       "sha256": _sha256(data),
                                       "rank": rank})

        manifest = {"epoch": epoch, "time": time.time(), "format": 2,
                    "world": world, "files": files, "hashes": hashes,
                    "shards": [], "trains": [], "sharded": sharded_info,
                    "metadata": metadata or {}}
        key = "ckpt/%d/%d" % (self._id, next(self._saves))

        def commit():
            for path, data, kind in payloads:
                if kind == "shard":
                    try:
                        chaos.maybe_fail("ckpt.shard")
                    except chaos.TornWrite:
                        self._torn_write(path, data)
                        continue
                    except chaos.DropShard:
                        continue
                commit_bytes(path, data, kind)
            if grp is None:
                manifest["shards"] = mine["shards"]
                self._commit_manifest(epoch, manifest)
                self._retire_old()
            else:
                self._job_commit(grp, key, epoch, manifest, mine)

        if async_save:
            self._writer.push(commit)
        else:
            commit()
        telemetry.CKPT_SAVE_MS.observe(
            (time.perf_counter() - t0) * 1e3,
            mode="async" if async_save else "sync")
        return self._manifest_path(epoch)

    def _job_commit(self, grp, key: str, epoch: int, manifest: Dict,
                    mine: Dict) -> None:
        """The commit's barrier through the store, after this rank's files
        are committed: its entries under the save's key, one added to the
        save's count; rank 0 waits for every rank, commits the manifest
        naming every rank's files, retires old epochs and marks the save
        done; the other ranks wait for the mark."""
        if self._store is None:
            self._store = _dist.connect_store(timeout=_dist._TIMEOUT_S)
        store = self._store
        store.set("%s/entries/%d" % (key, grp.rank), json.dumps(mine))
        what = "CheckpointManager.save_training (epoch %d)" % epoch
        _dist.store_barrier(store, key, grp.world, _dist._TIMEOUT_S, what,
                            rank=grp.rank, wait_all=False)
        if grp.rank == 0:
            for r in range(grp.world):
                got = json.loads(store.get("%s/entries/%d" % (key, r)))
                manifest["shards"] += got["shards"]
                manifest["trains"] += got["trains"]
            self._commit_manifest(epoch, manifest)
            self._retire_old()
            store.set(key + "/done", "1")
            return
        try:
            store.wait([key + "/done"],
                       datetime.timedelta(seconds=_dist._TIMEOUT_S))
        except RuntimeError as exc:
            raise MXNetError("%s: rank %d saw no manifest committed by rank "
                             "0 within %.0f s" % (what, grp.rank,
                                                  _dist._TIMEOUT_S)) from exc

    def _sharded_export(self, updater):
        """The sharded plane's snapshot of this rank's shards, or None
        where the materialized path runs (no plane, or no live shards)."""
        if updater is None:
            return None
        from .fastpath import zero

        plane = zero.plane_of(updater)
        if plane is None or plane.buckets is None:
            return None
        meta, shard, repl = plane.shard_export()
        meta["optimizer"] = updater.optimizer
        return meta, shard, repl

    # -- manifest bookkeeping -----------------------------------------------
    def _epochs(self) -> List[int]:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith(self.prefix + "-") and \
                    f.endswith(".manifest.json"):
                try:
                    out.append(int(f[len(self.prefix) + 1:
                                     -len(".manifest.json")]))
                except ValueError:
                    continue
        return sorted(out)

    def _read_manifest(self, epoch: int) -> Dict:
        try:
            with open(self._manifest_path(epoch)) as f:
                return json.load(f)
        except (OSError, ValueError) as exc:
            raise _CorruptCheckpoint("manifest for epoch %d unreadable: %s"
                                     % (epoch, exc))

    @staticmethod
    def _manifest_files(manifest: Dict) -> List[str]:
        """Every file a manifest commits to, every rank's included."""
        out = []
        for v in (manifest.get("files") or {}).values():
            out.append(v["file"] if isinstance(v, dict) else v)
        for s in (manifest.get("shards") or []) + \
                (manifest.get("trains") or []):
            out.append(s["file"])
        return out

    def _is_committed(self, epoch: int) -> bool:
        """A manifest whose files are all present (a lost shard makes the
        epoch uncommitted)."""
        try:
            manifest = self._read_manifest(epoch)
        except _CorruptCheckpoint:
            return False
        return all(os.path.isfile(os.path.join(self.directory, f))
                   for f in self._manifest_files(manifest))

    def _retire_old(self) -> None:
        """Bounded retention: ``max_keep`` <= 0 or None keeps everything;
        otherwise at least one epoch is kept, and the newest committed
        epoch never goes, whatever the quota."""
        if not self.max_keep:
            return
        keep = max(1, int(self.max_keep))
        epochs = self._epochs()
        committed = [e for e in epochs if self._is_committed(e)]
        protect = {committed[-1]} if committed else set()
        for e in epochs[:-keep]:
            if e not in protect:
                self._remove_epoch(e)

    def _remove_epoch(self, epoch: int) -> None:
        # the manifest first: a crash mid-retire leaves the epoch reading
        # as uncommitted, never as committed with holes
        try:
            os.remove(self._manifest_path(epoch))
        except OSError:
            pass
        stem = "%s-%04d." % (self.prefix, epoch)
        for f in os.listdir(self.directory):
            if f.startswith(stem):
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass

    def wait(self) -> None:
        """Join the pending async saves, raising a write's failure: the
        barrier a new save and a preemption flush take first."""
        self._writer.wait()

    def flush(self) -> None:
        """:meth:`wait`, under the preemption path's name."""
        self.wait()

    def latest_epoch(self) -> int:
        """The newest committed epoch (manifest readable, every file
        present), or -1; joins pending saves first."""
        self.wait()
        for e in reversed(self._epochs()):
            if self._is_committed(e):
                return e
        return -1

    # -- restore ------------------------------------------------------------
    def restore(self, net=None, trainer=None, epoch: Optional[int] = None):
        """Load the newest (or the given) committed checkpoint into the
        net and the trainer; the epoch restored, or -1."""
        return self.restore_training(net=net, trainer=trainer, epoch=epoch,
                                     restore_rng=False)

    def restore_training(self, net=None, trainer=None, train_iter=None,
                         epoch: Optional[int] = None,
                         restore_rng: bool = True) -> int:
        """Restore what :meth:`save_training` (or :meth:`save`) saved:
        parameters into ``net`` (in place), optimizer states into
        ``trainer`` (sharded checkpoints rebuilt onto any world size and
        adopted, in place where the live states have the shapes), the
        cursor into ``train_iter`` and the RNG streams (in a job each
        rank its own). Walks the committed epochs newest first: an epoch
        with a hash mismatch or a missing file counts
        ``mxnet_ckpt_corruption_total`` and falls back to the previous
        one. Returns the epoch restored (-1: none); the saved ``extra``
        lands in :attr:`last_restored_extra`."""
        t0 = time.perf_counter()
        self.wait()
        self.last_restored_extra = None
        explicit = epoch is not None
        candidates = [epoch] if explicit else list(reversed(self._epochs()))
        for e in candidates:
            try:
                extra = self._restore_epoch(e, net, trainer, train_iter,
                                            restore_rng)
            except _CorruptCheckpoint as exc:
                telemetry.CKPT_CORRUPTION.inc()
                if explicit:
                    raise MXNetError("checkpoint epoch %d unusable: %s"
                                     % (e, exc))
                _LOG.warning("checkpoint epoch %d unusable (%s); falling "
                             "back to the previous committed epoch", e, exc)
                continue
            self.last_restored_extra = extra
            telemetry.CKPT_RESTORE_MS.observe(
                (time.perf_counter() - t0) * 1e3)
            return e
        return -1

    @staticmethod
    def _want_hash(manifest: Dict, name: str, fname: str) -> Optional[str]:
        want = (manifest.get("hashes") or {}).get(name)
        if want is None and name in ("shard", "train"):
            want = next((s["sha256"] for s in
                         (manifest.get("shards") or []) +
                         (manifest.get("trains") or [])
                         if s["file"] == fname), None)
        return want

    def _verified_read(self, manifest: Dict, name: str,
                       fname: str) -> bytes:
        """Read an artifact consumed from memory (shards, zmeta, repl,
        train), checking its hash."""
        path = os.path.join(self.directory, fname)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as exc:
            raise _CorruptCheckpoint("missing %s file %s: %s"
                                     % (name, fname, exc))
        want = self._want_hash(manifest, name, fname)
        if want is not None and _sha256(data) != want:
            raise _CorruptCheckpoint("content hash mismatch on %s (%s)"
                                     % (fname, name))
        return data

    def _verify_file(self, manifest: Dict, name: str, fname: str) -> None:
        """Stream-check the hash of an artifact its consumer loads from
        disk (params, states)."""
        want = self._want_hash(manifest, name, fname)
        if want is None:
            return
        digest = hashlib.sha256()
        try:
            with open(os.path.join(self.directory, fname), "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    digest.update(chunk)
        except OSError as exc:
            raise _CorruptCheckpoint("missing %s file %s: %s"
                                     % (name, fname, exc))
        if digest.hexdigest() != want:
            raise _CorruptCheckpoint("content hash mismatch on %s (%s)"
                                     % (fname, name))

    def _restore_epoch(self, epoch: int, net, trainer, train_iter,
                       restore_rng) -> Optional[Dict]:
        manifest = self._read_manifest(epoch)
        missing = [f for f in self._manifest_files(manifest)
                   if not os.path.isfile(os.path.join(self.directory, f))]
        if missing:
            raise _CorruptCheckpoint("missing files: %s" % ", ".join(missing))
        fnames = {n: (v["file"] if isinstance(v, dict) else v)
                  for n, v in (manifest.get("files") or {}).items()}
        # every hash is checked before anything is written: a half-applied
        # restore would be worse than the corruption it found
        blobs: Dict[str, bytes] = {}
        for name, fname in fnames.items():
            if name in ("params", "states"):
                self._verify_file(manifest, name, fname)
            else:
                blobs[name] = self._verified_read(manifest, name, fname)
        shard_blobs = [(int(s.get("rank", i)),
                        self._verified_read(manifest, "shard", s["file"]))
                       for i, s in enumerate(manifest.get("shards") or [])]
        trains = manifest.get("trains") or []
        if trains and "train" not in blobs:
            rank = _dist.rank()
            entry = next((s for s in trains if int(s["rank"]) == rank),
                         trains[0])
            blobs["train"] = self._verified_read(manifest, "train",
                                                 entry["file"])

        if net is not None and "params" in fnames:
            net.load_parameters(os.path.join(self.directory,
                                             fnames["params"]))
        if trainer is not None:
            if manifest.get("sharded"):
                self._restore_sharded(trainer, blobs, shard_blobs)
            elif "states" in fnames:
                path = os.path.join(self.directory, fnames["states"])
                if hasattr(trainer, "load_states"):
                    trainer.load_states(path)
                else:
                    with open(path, "rb") as f:
                        _updater_of(trainer).set_states(f.read())

        train_state: Dict[str, Any] = {}
        if "train" in blobs:
            try:
                train_state = pickle.loads(blobs["train"])
            except Exception as exc:  # noqa: BLE001 - treat as corruption
                raise _CorruptCheckpoint("train-state pickle unreadable: %s"
                                         % exc)
        if train_iter is not None and hasattr(train_iter, "set_state") \
                and "iter" in train_state:
            train_iter.set_state(train_state["iter"])
        if restore_rng and "rng" in train_state:
            from . import random as _random

            _random.set_state(train_state["rng"])
        return train_state.get("extra")

    def _restore_sharded(self, trainer, blobs: Dict[str, bytes],
                         shard_blobs: List[Tuple[int, bytes]]) -> None:
        """Rebuild the plain per-parameter states from every rank's shard
        file (the pieces in rank order, then the saved flat layout) and
        adopt them; the next sharded step shards them again over the
        ranks that are live."""
        from .fastpath import zero

        try:
            meta = pickle.loads(blobs["zmeta"])
        except Exception as exc:  # noqa: BLE001 - treat as corruption
            raise _CorruptCheckpoint("zmeta pickle unreadable: %s" % exc)
        pieces: Dict[str, List[Tuple[int, np.ndarray]]] = {}
        for rank, data in shard_blobs:
            try:
                shard = pickle.loads(data)
            except Exception as exc:  # noqa: BLE001 - treat as corruption
                raise _CorruptCheckpoint("shard %d unreadable: %s"
                                         % (rank, exc))
            for key, arr in shard.items():
                pieces.setdefault(key, []).append((rank, arr))
        slot_arrays = {key: np.concatenate([a for _, a in sorted(
            parts, key=lambda p: p[0])]) for key, parts in pieces.items()}
        if "repl" in blobs:
            try:
                slot_arrays.update(pickle.loads(blobs["repl"]))
            except Exception as exc:  # noqa: BLE001 - treat as corruption
                raise _CorruptCheckpoint("repl pickle unreadable: %s" % exc)
        try:
            trees = zero.states_from_export(meta, slot_arrays)
        except (KeyError, ValueError) as exc:
            raise _CorruptCheckpoint("sharded state incomplete: %s" % exc)
        states = dict(zip(meta["indices"], trees))
        optimizer = meta.get("optimizer")
        _updater_of(trainer).adopt_states(states, optimizer=optimizer,
                                          device=_device_of(trainer))
        if optimizer is not None and hasattr(trainer, "_optimizer"):
            trainer._optimizer = optimizer
            optimizer.param_dict = dict(enumerate(trainer._params))

    def load_params(self, epoch: Optional[int] = None) -> Dict:
        """The parameters of the newest (or the given) committed epoch, as
        ``nd.load`` gives them (on the current context)."""
        from .ndarray import io_utils

        if epoch is None:
            epoch = self.latest_epoch()
        if epoch < 0:
            raise MXNetError("no committed checkpoint to load")
        return io_utils.load(self._params_path(epoch))


# ---------------------------------------------------------------------------
# the elastic run loop
# ---------------------------------------------------------------------------


def _invoke_attempt(train_fn, start_epoch: int, manager: CheckpointManager,
                    stall_timeout: float):
    """One attempt. With a stall timeout the attempt runs on a thread of
    its own (its context stack starts empty: enter the context inside
    ``train_fn``) and the supervisor watches :func:`note_progress`;
    silence longer than the timeout raises :class:`StallError`, and the
    abandoned thread stops at its next step boundary."""
    if stall_timeout <= 0:
        return train_fn(start_epoch, manager)
    box: Dict[str, Any] = {}
    done = threading.Event()
    cancelled = threading.Event()

    def runner():
        _ATTEMPT_TL.cancelled = cancelled
        try:
            box["result"] = train_fn(start_epoch, manager)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["exc"] = exc
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name="mxtpu-elastic-train")
    note_progress()
    t.start()
    poll = max(0.01, min(0.25, stall_timeout / 4.0))
    while not done.wait(poll):
        if time.monotonic() - _last_progress() > stall_timeout:
            cancelled.set()
            _flightrec.record("elastic.stall",
                              stall_timeout_s=stall_timeout)
            _flightrec.dump("elastic stall watchdog (no progress in "
                            "%.1fs)" % stall_timeout)
            raise StallError(
                "no step progress in %.1fs (MXNET_ELASTIC_STALL_SECS); "
                "treating the attempt as hung" % stall_timeout)
    if "exc" in box:
        raise box["exc"]
    return box["result"]


def run_elastic(train_fn: Callable[[int, CheckpointManager], object],
                manager: CheckpointManager, max_restarts: int = 3,
                restart_delay: float = 1.0, restart_backoff: float = 2.0,
                max_restart_delay: float = 60.0,
                stall_timeout: Optional[float] = None,
                watch_preemption: bool = True):
    """Run ``train_fn(start_epoch, manager)`` with automatic resume from
    ``manager.latest_epoch() + 1`` after a failure (the reference's
    restarted-worker recovery, ``is_recovery``, kvstore_dist.h:52); the
    last failure is raised.

    * The budget is ``max_restarts`` consecutive attempts without
      progress: an attempt that committed a newer epoch before failing
      resets it.
    * Restart ``n`` waits ``restart_delay * restart_backoff**(n-1)``
      seconds, at most ``max_restart_delay`` (``restart_delay=0``: none).
    * ``stall_timeout`` (default ``MXNET_ELASTIC_STALL_SECS``, 0 = off)
      arms the hang watchdog.
    * :class:`Preempted` joins pending saves and is raised without
      spending a restart: rescheduling is the cluster's.
    * Telemetry: ``mxnet_elastic_restarts_total{reason}``,
      ``mxnet_retries_total{site="elastic.restart"}`` and
      ``mxnet_elastic_goodput_ratio`` (productive attempt time over wall
      time) at every transition."""
    if stall_timeout is None:
        stall_timeout = float(get_env("MXNET_ELASTIC_STALL_SECS", 0.0,
                                      float, cache=False))
    if watch_preemption:
        start_preemption_watcher()
    restarts = resilience.policies.retries_counter()
    attempt = 0
    wall0 = time.monotonic()
    productive = 0.0

    def goodput() -> None:
        wall = time.monotonic() - wall0
        if wall > 0:
            telemetry.ELASTIC_GOODPUT.set(min(1.0, productive / wall))

    while True:
        start_epoch = manager.latest_epoch() + 1
        committed_before = start_epoch - 1
        t_attempt = time.monotonic()
        try:
            result = _invoke_attempt(train_fn, start_epoch, manager,
                                     stall_timeout)
        except KeyboardInterrupt:
            raise
        except Preempted:
            try:
                manager.wait()
            except Exception:  # noqa: BLE001 - exiting anyway
                _LOG.exception("pending async checkpoint failed during "
                               "preemption exit")
            # productive only if the attempt committed progress
            try:
                if manager.latest_epoch() > committed_before:
                    productive += time.monotonic() - t_attempt
            except Exception:  # noqa: BLE001 - the gauge must not mask
                # the preemption exit
                _LOG.exception("goodput accounting failed during "
                               "preemption exit")
            goodput()
            raise
        except Exception as exc:  # noqa: BLE001 - the point of the loop
            duration = time.monotonic() - t_attempt
            try:
                committed_now = manager.latest_epoch()
            except Exception:  # noqa: BLE001 - a failed async save joined
                # here must not mask the restart decision
                _LOG.exception("joining pending saves after a crash failed")
                committed_now = committed_before
            if committed_now > committed_before:
                productive += duration
                attempt = 1  # progress resets the budget
            else:
                attempt += 1
            reason = "stall" if isinstance(exc, StallError) else "exception"
            telemetry.ELASTIC_RESTARTS.inc(reason=reason)
            _flightrec.record("elastic.restart", reason=reason,
                              attempt=attempt, error=repr(exc))
            goodput()
            if attempt > max_restarts:
                restarts.inc(site="elastic.restart", outcome="exhausted")
                raise
            restarts.inc(site="elastic.restart", outcome="retry")
            delay = min(restart_delay * (restart_backoff ** (attempt - 1)),
                        max_restart_delay) if restart_delay else 0.0
            _LOG.warning("train_fn failed (%s); restart %d/%d from epoch %d "
                         "in %.1fs", exc, attempt, max_restarts,
                         committed_now + 1, delay)
            if delay:
                time.sleep(delay)
        else:
            productive += time.monotonic() - t_attempt
            goodput()
            return result
