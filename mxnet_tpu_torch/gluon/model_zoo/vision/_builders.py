"""Shared construction helpers for the vision model zoo (the port of
``mxnet_tpu/gluon/model_zoo/vision/_builders.py``; ``load_pretrained`` is
not ported: it reads the model store's downloads, and
:func:`refuse_pretrained` raises in its place)."""
from __future__ import annotations

import sys

from ....base import MXNetError
from ... import nn

__all__ = ["seq", "named_factory", "refuse_pretrained"]


def seq(*layers, prefix=""):
    """HybridSequential from a flat layer list."""
    s = nn.HybridSequential(prefix=prefix)
    for layer in layers:
        s.add(layer)
    return s


def named_factory(builder, name, doc, *bound_args):
    """A zero-config model constructor (``resnet50_v1()``-style) delegating
    to ``builder(*bound_args, **kwargs)``; picklable as an attribute of the
    caller's module under ``name``."""

    def make(**kwargs):
        return builder(*bound_args, **kwargs)
    make.__name__ = name
    make.__qualname__ = name
    make.__module__ = sys._getframe(1).f_globals.get("__name__", __name__)
    make.__doc__ = doc
    return make


def refuse_pretrained(pretrained):
    """Raise for ``pretrained=True``: the model store downloads the
    weights, which the port does not do."""
    if pretrained:
        raise MXNetError("pretrained weights are not ported: the model "
                         "store downloads them; load a local file, or carry "
                         "a JAX net's weights with gluon.params_from_jax")
