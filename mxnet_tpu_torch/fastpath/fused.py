"""The fused optimizer apply (the port of ``mxnet_tpu/fastpath/fused.py``).

The per-parameter path (``Optimizer.update`` from ``Updater.__call__``
in a Python loop) runs an optimizer's list kernel once per parameter, six
to nine small device kernels each. Here the host prologue (update
counting, lr/wd multipliers, schedule scalars and extras) runs per
parameter exactly as the loop runs it, in the same parameter order, and
the kernel runs once over the lists of every parameter: each
``torch._foreach_*`` op of it is one multi-tensor launch per chunk of
parameters. Because both paths call the same kernel, they
give the same bits.

A ``multi_precision`` pair (a float16 or bfloat16 weight with its float32
master, ``mxnet_tpu/fastpath/fused.py:44-80``) enters the kernel as its
master, its float32-cast gradient and its base state; the weight is then
the master cast back, as ``Optimizer.update_multi_precision`` does one
parameter at a time. :func:`tree_kernel` is that composition, shared with
``trainplane``'s captured step.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..optimizer import _is_mp_dtype, _is_mp_pair, _tensor, ensure_mp_state
from ..telemetry import OPT_DISPATCHES

__all__ = ["FusedApplyError", "fused_apply", "apply_updater", "tree_kernel"]


class FusedApplyError(MXNetError):
    """Misuse of the fused apply (incapable optimizer, ragged input)."""


def _is_mp_state(optimizer, index, weight, state):
    """Whether ``state`` is a ``(float32 master, base state)`` pair for
    this weight."""
    return (optimizer.multi_precision and _is_mp_dtype(_tensor(weight).dtype)
            and _is_mp_pair(optimizer, index, weight, state))


def tree_kernel(optimizer, ws, gs, states, mp_flags, ts, lrs, wds,
                extras=None):
    """One call of ``optimizer._leaf_step`` over every parameter, in place,
    under ``torch.no_grad()``: tensors ``ws``/``gs``, their ``states``,
    per parameter whether its state is a master pair, and the prologue's
    counts, learning rates, weight decays and extras (``_host_scalars``'
    third item: Nadam's schedule). A pair steps its master with the
    float32-cast gradient, then the master is cast back into the
    weight."""
    kw, kg, ks, back = [], [], [], []
    with torch.no_grad():
        for w, g, s, mp in zip(ws, gs, states, mp_flags):
            if mp:
                master, base = s
                kw.append(master)
                kg.append(g.to(torch.float32))
                ks.append(base)
                back.append((w, master))
            else:
                kw.append(w)
                kg.append(g)
                ks.append(s)
        optimizer._leaf_step(kw, kg, ks, ts, lrs, wds,
                             extras=extras if extras is not None
                             else [()] * len(kw))
        for w, master in back:
            w.copy_(master)


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
    ts, lrs, wds, extras, mp_flags = [], [], [], [], []
    for i, w, s in zip(indices, weights, states):
        optimizer._update_count(i)
        lr, wd, ex = optimizer._host_scalars(i)
        ts.append(optimizer._index_update_count[i])
        lrs.append(lr)
        wds.append(wd)
        extras.append(tuple(ex))
        mp_flags.append(_is_mp_state(optimizer, i, w, s))
    states = list(states)
    OPT_DISPATCHES.inc(path="fused")
    tree_kernel(optimizer, [_tensor(w) for w in weights],
                [_tensor(g) for g in grads], states, mp_flags, ts, lrs, wds,
                extras)
    return states


def apply_updater(updater, triples, positions: int = 1):
    """Run an ``optimizer.Updater`` over ``(index, grad, weight)`` triples
    in one fused call: the replacement for the ``for ...: updater(i, g,
    w)`` loop in Trainer and Module. Creates missing states as
    ``Updater.__call__`` would, and moves a state that predates its
    weight's master layout to it, as ``update_multi_precision`` does.
    Under ``MXNET_ZERO`` the sharded plane (:mod:`.zero`) takes the
    update first (``mxnet_tpu/fastpath/fused.py:253-283``); what it
    declines, counted by reason, runs here replicated, its states
    materialized first (a collective in a job, where a plane was
    attached). ``positions`` is the caller's count of device positions
    (contexts, executors): the sharded plane takes one only, and declines
    more with the reason "multi-position eager update"."""
    if not triples:
        return
    from . import zero

    opt = updater.optimizer
    for index, _grad, weight in triples:
        if index not in updater.states:
            updater.states[index] = opt.create_state_multi_precision(
                index, weight)
        elif not zero.is_sharded(updater.states[index]):
            updater.states[index] = ensure_mp_state(
                opt, index, weight, updater.states[index])
    if zero.level() and zero.apply(updater, triples, positions):
        return
    indices = [t[0] for t in triples]
    # a declined sharded step (or the knob turned off) leaves plain
    # states; a formerly sharded one may predate a multi_precision flip
    states = [ensure_mp_state(opt, i, w, s) for (i, _g, w), s in
              zip(triples, zero.ensure_materialized(updater, indices))]
    new_states = fused_apply(
        opt, indices, [t[1] for t in triples], [t[2] for t in triples],
        states)
    for i, s in zip(indices, new_states):
        updater.states[i] = s
