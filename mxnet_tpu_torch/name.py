"""Auto-naming of blocks and symbols: the port of ``mxnet_tpu/name.py``
(``NameManager`` and ``Prefix``)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager(object):
    """Hands out ``<hint><n>`` names, one counter per hint."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @staticmethod
    def current():
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        return NameManager._current.value


class Prefix(NameManager):
    """Prepends ``prefix`` to every name it gives (reference
    ``name.py:Prefix``, ``mxnet_tpu/name.py:49``)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
