"""Gluon: the imperative NN API, the port of ``mxnet_tpu/gluon/``
(Block/HybridBlock run eagerly, with hooks, ``summary``, a symbolic trace
and ``export``; ``SymbolBlock``; Parameter, Constant; nn, ``contrib``'s
``nn``, ``rnn`` and ``data``; loss, Trainer, the vision ``model_zoo``,
``rnn``'s cells and fused layers, ``data`` with its vision datasets and
transforms, ``utils``) and :func:`params_from_jax`, which carries a
JAX-package net's weights over.
"""
import re as _re

import numpy as _np

from ..base import MXNetError as _MXNetError
from . import block, loss, model_zoo, nn, parameter, rnn, trainer
from . import data, contrib, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict", "DeferredInitializationError", "Trainer",
           "params_from_jax", "block", "contrib", "data", "loss",
           "model_zoo", "nn", "parameter", "rnn", "trainer", "utils"]

_COUNTED = _re.compile(r"([A-Za-z]+)(\d+)")


def _canonical_names(names):
    """Parameter names with every block counter (``dense5``) renumbered in
    order of first appearance within its scope: the same structure built
    in two processes (or two packages) gets the same names, whatever the
    processes' name counters were."""
    seen = {}
    out = []
    for name in names:
        parts = name.split("_")
        canon = []
        for tok in parts[:-1]:
            m = _COUNTED.fullmatch(tok)
            if m:
                nums = seen.setdefault(("_".join(canon), m.group(1)), {})
                tok = "%s%d" % (m.group(1),
                                nums.setdefault(m.group(2), len(nums)))
            canon.append(tok)
        out.append("_".join(canon + parts[-1:]))
    return out


def params_from_jax(net, arrays):
    """Load ``{name: numpy array}`` (a JAX-package net's
    ``{k: p.data().asnumpy() for k, p in net.collect_params().items()}``)
    into the port's ``net`` (initialized; a deferred parameter takes the
    value at its first forward, and its unknown dims match any size).

    Names match once each side's block counters are renumbered in order
    of appearance (the top prefix included): counters differ between
    processes. A missing name, an extra name or a shape mismatch raises.
    """
    params = net.collect_params()
    ours = dict(zip(_canonical_names(list(params.keys())), params.values()))
    theirs = dict(zip(_canonical_names(list(arrays.keys())),
                      arrays.values()))
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise _MXNetError("params_from_jax: missing %s, extra %s"
                          % (missing, extra))
    for name, p in ours.items():
        value = _np.asarray(theirs[name])
        if len(value.shape) != len(p.shape) or any(
                want not in (0, got) for got, want in zip(value.shape,
                                                         p.shape)):
            raise _MXNetError("params_from_jax: %s has shape %s, the net "
                              "wants %s" % (name, value.shape, p.shape))
    for name, p in ours.items():
        p.set_data(_np.asarray(theirs[name]))
