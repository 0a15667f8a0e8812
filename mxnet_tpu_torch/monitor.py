"""Monitor: a statistic of named tensors every few batches, the port of
``mxnet_tpu/monitor.py`` (reference ``python/mxnet/monitor.py:33``:
install/tic/toc/toc_print).

An executor with the monitor's hook (:meth:`Monitor.install`, or
``Module.install_monitor``) hands it each output after every forward;
while a batch is due the hook records ``stat_func(array)`` for the names
that match ``pattern``. :meth:`Monitor.toc` adds the arguments and
auxiliary states of the executors given to :meth:`Monitor.install` and
renders every row with one batched transfer to the host.

Through a ``Module`` (``fit(monitor=)``) the hook is set without
``install``, as the JAX package sets it (``mxnet_tpu/module/
executor_group.py:197-199``), so the rows are the graph's outputs only:
MXNet 1.3's ``install_monitor`` would report the arguments too.
"""
from __future__ import annotations

import logging
import math
import re

from .base import fetch_host
from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


def _rms(x):
    """The default statistic: ``|x|_2 / sqrt(size)``."""
    return x.norm() / math.sqrt(x.size)


def _fmt(stat):
    """One row's statistic as text: a scalar bare, an array as numpy
    prints it; ``stat`` may be a list of NDArrays (reference contract)."""
    vals = stat if isinstance(stat, list) else [stat]
    for v in vals:
        if not isinstance(v, NDArray):
            raise TypeError("stat_func must return NDArray(s)")
    parts = []
    for a in fetch_host([v._data for v in vals]):
        parts.append(str(a.reshape(-1)[0]) if a.size == 1 else str(a))
    return "\t".join(parts) + "\t"


class Monitor(object):
    """Record ``stat_func`` of the tensors whose name matches ``pattern``
    every ``interval`` batches (reference monitor.py:33)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _rms
        self.sort = sort
        self._match = re.compile(pattern).match
        self._armed = False
        self._step = 0
        self._rows = []  # (step, name, stat NDArray) while armed
        self._exes = []

    def stat_helper(self, name, array):
        """The executor's hook."""
        if self._armed and self._match(name):
            self._rows.append((self._step, name, self.stat_func(array)))

    def install(self, exe):
        """Hook into ``exe``; :meth:`toc` adds its arguments (reference
        monitor.py:73)."""
        exe.set_monitor_callback(self.stat_helper)
        self._exes.append(exe)

    def tic(self):
        """Arm for the coming batch if it is due (reference
        monitor.py:85)."""
        if self._step % self.interval == 0:
            self._rows = []
            self._armed = True
        self._step += 1

    def toc(self):
        """Disarm and return ``[(step, name, stat text)]``, with the
        installed executors' arguments and auxiliary states (reference
        monitor.py:99)."""
        if not self._armed:
            return []
        for exe in self._exes:
            sym = exe._symbol
            for names, arrays in ((sym.list_arguments(), exe.arg_arrays),
                                  (sym.list_auxiliary_states(),
                                   exe.aux_arrays)):
                for name, arr in zip(names, arrays):
                    if self._match(name):
                        self._rows.append(
                            (self._step, name, self.stat_func(arr)))
        self._armed = False
        rows = sorted(self._rows, key=lambda r: r[1]) if self.sort \
            else self._rows
        out = [(step, name, _fmt(stat)) for step, name, stat in rows]
        self._rows = []
        return out

    def toc_print(self):
        """:meth:`toc`, each row logged (reference monitor.py:139)."""
        for step, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, stat)

    @property
    def step(self):
        return self._step

    @property
    def activated(self):
        return self._armed
