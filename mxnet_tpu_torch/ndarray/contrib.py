"""``mx.nd.contrib``: every registered ``_contrib_*`` op under its short
name (``nd.contrib.box_nms``, ``nd.contrib.MultiBoxPrior``, ...), the
port of ``mxnet_tpu/ndarray/contrib.py:114``.

The imperative control flow of that module (``foreach``, ``while_loop``,
``cond``) is not ported yet and raises.
"""
from __future__ import annotations

import sys

from ..base import MXNetError

__all__ = ["foreach", "while_loop", "cond"]


def _not_ported(name):
    def fn(*args, **kwargs):
        raise MXNetError("nd.contrib.%s is not ported yet" % name)

    fn.__name__ = name
    return fn


foreach = _not_ported("foreach")
while_loop = _not_ported("while_loop")
cond = _not_ported("cond")


def _export_contrib_ops():
    pkg = sys.modules["mxnet_tpu_torch.ndarray"]
    for flat in dir(pkg):
        if flat.startswith("_contrib_"):
            globals().setdefault(flat[len("_contrib_"):], getattr(pkg, flat))


_export_contrib_ops()
