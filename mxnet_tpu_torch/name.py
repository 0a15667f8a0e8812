"""Auto-naming of blocks: the port of ``mxnet_tpu/name.py``'s
``NameManager`` (the part Gluon's name scopes use)."""
from __future__ import annotations

import threading

__all__ = ["NameManager"]


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
