"""The atomic file commit of checkpoints: the port's copy of
``mxnet_tpu/elastic.py``'s ``commit_bytes`` (``:381-394``) and
``CheckpointManager._atomic_write`` (``:513-535``).

:func:`commit_bytes` writes a temporary file beside the target, fsyncs
it, renames it over the target and fsyncs the directory, so a crash
leaves the old file or the new one, never a torn one. It runs under the
resilience retry policy at the site ``ckpt.commit`` (also a chaos site),
and counts the bytes in ``mxnet_ckpt_bytes_total{kind}``
(``telemetry.CKPT_BYTES``). ``Symbol.save`` and
``Module.save_optimizer_states`` commit through it, as in the JAX
package; the ``.params`` writers (``nd.save``) write with a plain
``open``, as there.

The JAX module's ``CheckpointManager``, ``run_elastic`` and their
manifests, the flight recorder's ``ckpt.commit`` event and the stall
watchdog's progress mark wait for a later slice.
"""
from __future__ import annotations

import os
from typing import Callable

from . import resilience
from .telemetry import CKPT_BYTES

__all__ = ["commit_bytes", "atomic_write"]


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
    retry policy, counted in ``mxnet_ckpt_bytes_total{kind}``."""
    CKPT_BYTES.inc(len(data), kind=kind)
    resilience.call("ckpt.commit",
                    lambda: atomic_write(path, lambda p: _write_bytes(p, data)))
