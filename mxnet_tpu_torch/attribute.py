"""Attribute scoping for symbol construction: the port of
``mxnet_tpu/attribute.py``.

API parity with the reference ``python/mxnet/attribute.py`` (AttrScope:
a with-block whose attributes — ``ctx_group``, ``__lr_mult__``, custom
``__key__`` attrs — attach to every Symbol created inside it; nested scopes
merge, inner wins). The attributes land in ``Symbol.attr_dict()`` and the
symbol JSON; ``bind``/``simple_bind(group2ctx=)`` place each ``ctx_group``
on its context (``Symbol.eval_torch``).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current"]


class AttrScope(object):
    """Attach attributes to symbols created within the scope
    (reference attribute.py:AttrScope)."""

    _tls = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("attributes need to be strings")
        self._attr = kwargs
        self._old_scope: Optional[AttrScope] = None

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        """Merge the scope's attrs under explicitly-given ones."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        if not hasattr(AttrScope._tls, "value"):
            AttrScope._tls.value = AttrScope()
        self._old_scope = AttrScope._tls.value
        merged = self._old_scope._attr.copy()
        merged.update(self._attr)
        self._attr = merged
        AttrScope._tls.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_scope is not None
        AttrScope._tls.value = self._old_scope

    @classmethod
    def current(cls) -> "AttrScope":
        if not hasattr(cls._tls, "value"):
            cls._tls.value = AttrScope()
        return cls._tls.value


def current() -> AttrScope:
    return AttrScope.current()
