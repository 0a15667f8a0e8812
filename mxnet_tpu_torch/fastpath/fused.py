"""The fused optimizer apply (the port of ``mxnet_tpu/fastpath/fused.py``).

The per-parameter path (``Optimizer.update`` from ``Updater.__call__``
in a Python loop) runs an optimizer's list kernel once per parameter, six
to nine small device kernels each. Here the host prologue (update
counting, lr/wd multipliers, schedule scalars) runs per parameter exactly
as the loop runs it, and the kernel runs once over the lists of every
parameter: each ``torch._foreach_*`` op of it is one multi-tensor launch
per chunk of parameters. Because both paths call the same kernel, they
give the same bits.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..optimizer import _tensor
from ..telemetry import OPT_DISPATCHES

__all__ = ["FusedApplyError", "fused_apply", "apply_updater"]


class FusedApplyError(MXNetError):
    """Misuse of the fused apply (incapable optimizer, ragged input)."""


def fused_apply(optimizer, indices, grads, weights, states):
    """Apply ``optimizer`` to every parameter in one call of its kernel.

    ``indices`` are the optimizer indices (lr/wd multiplier keys),
    ``grads``/``weights`` NDArrays (or tensors) parallel to them, and
    ``states`` their optimizer states. The weights and states are updated
    in place; returns the list of states."""
    n = len(indices)
    if not (n == len(grads) == len(weights) == len(states)):
        raise FusedApplyError("fused_apply: ragged inputs")
    if n == 0:
        return []
    if not getattr(optimizer, "fastpath_capable", False):
        raise FusedApplyError(
            "%s has no list kernel; use the per-parameter path"
            % type(optimizer).__name__)
    ts, lrs, wds = [], [], []
    for i in indices:
        optimizer._update_count(i)
        lr, wd = optimizer._host_scalars(i)
        ts.append(optimizer._index_update_count[i])
        lrs.append(lr)
        wds.append(wd)
    states = list(states)
    OPT_DISPATCHES.inc(path="fused")
    with torch.no_grad():
        optimizer._leaf_step([_tensor(w) for w in weights],
                             [_tensor(g) for g in grads], states, ts, lrs,
                             wds)
    return states


def apply_updater(updater, triples, positions: int = 1):
    """Run an ``optimizer.Updater`` over ``(index, grad, weight)`` triples
    in one fused call: the replacement for the ``for ...: updater(i, g,
    w)`` loop in Trainer and Module. Creates missing states as
    ``Updater.__call__`` would. ``positions`` (the caller's device
    positions) is kept for the JAX package's signature; the port trains on
    one."""
    if not triples:
        return
    opt = updater.optimizer
    for index, _grad, weight in triples:
        if index not in updater.states:
            updater.states[index] = opt.create_state(index, weight)
    indices = [t[0] for t in triples]
    new_states = fused_apply(
        opt, indices, [t[1] for t in triples], [t[2] for t in triples],
        [updater.states[i] for i in indices])
    for i, s in zip(indices, new_states):
        updater.states[i] = s
