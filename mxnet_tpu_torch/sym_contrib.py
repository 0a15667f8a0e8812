"""``mx.sym.contrib``: every registered ``_contrib_*`` op under its short
name (``sym.contrib.MultiBoxPrior``, ``sym.contrib.MultiBoxTarget``, ...),
the port of ``mxnet_tpu/sym_contrib.py``'s ``_export_contrib_ops``.

The symbolic control flow of that module (``foreach``, ``while_loop``,
``cond``) is not ported yet and raises.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["foreach", "while_loop", "cond"]


def _not_ported(name):
    def fn(*args, **kwargs):
        raise MXNetError("sym.contrib.%s is not ported yet" % name)

    fn.__name__ = name
    return fn


foreach = _not_ported("foreach")
while_loop = _not_ported("while_loop")
cond = _not_ported("cond")


def _export_contrib_ops():
    from . import symbol as sym_mod

    for flat in dir(sym_mod):
        if flat.startswith("_contrib_"):
            globals().setdefault(flat[len("_contrib_"):],
                                 getattr(sym_mod, flat))


_export_contrib_ops()
