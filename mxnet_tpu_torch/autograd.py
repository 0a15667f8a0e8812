"""Autograd over torch autograd: the port of ``mxnet_tpu/autograd.py``.

``record()`` turns recording on; :func:`mxnet_tpu_torch.ndarray.invoke`
then runs each op with torch autograd enabled when one of its inputs is
in the graph, so torch builds the tape. A leaf is an NDArray marked by
``attach_grad`` (or :func:`mark_variables`): its tensor is a torch leaf
that requires grad. :func:`backward` takes ``torch.autograd.grad`` from
the heads to every live leaf, lets torch tell which ones the heads
reach, and lands each gradient in the leaf's ``.grad`` buffer under its
``grad_req``, as the JAX package does:

* ``write`` replaces the buffer, ``add`` adds to it, ``null`` leaves it;
* the buffer NDArray stays the same object (``Parameter.grad()`` hands
  it out), only its tensor is rebound;
* the leaf's fresh-grad bit turns on (``Trainer`` checks it).

A rebind inside ``record()`` does not change what an earlier op saw:
NDArrays rebind their tensor and never write into it under record.

:class:`Function` (a differentiable function written as a forward and a
backward on NDArrays) runs on a ``torch.autograd.Function``, so torch's
tape calls the user's backward.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.recomputing = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_recomputing() -> bool:
    """Whether the forward is being run again for its backward
    (``parallel.TrainStep(remat=True)``): a layer's side effects, such as
    BatchNorm's moving statistics, happened in the first run and must not
    happen twice."""
    return _STATE.recomputing


@contextlib.contextmanager
def _recompute_scope(training: bool):
    """Record, in train mode ``training``, flagged as a recompute."""
    prev = (_STATE.recording, _STATE.training, _STATE.recomputing)
    _STATE.recording, _STATE.training, _STATE.recomputing = \
        True, training, True
    try:
        yield
    finally:
        _STATE.recording, _STATE.training, _STATE.recomputing = prev


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record: Optional[bool],
                 train_mode_flag: Optional[bool]):
        self._enter_record = is_record
        self._enter_train = train_mode_flag
        self._prev_record = None
        self._prev_train = None

    def __enter__(self):
        if self._enter_record is not None:
            self._prev_record = set_recording(self._enter_record)
        if self._enter_train is not None:
            self._prev_train = set_training(self._enter_train)
        return self

    def __exit__(self, *a):
        if self._prev_record is not None:
            set_recording(self._prev_record)
        if self._prev_train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True):
    """``with autograd.record():`` — turn on recording (+ train mode)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` leaves whose gradients land in ``gradients``."""
    from .ndarray.ndarray import _make_leaf

    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        _make_leaf(v, req)
        v._grad = g


def _candidates():
    """Every live marked NDArray that takes a gradient, with its leaf
    tensor. Which of them the heads reach is left to
    ``torch.autograd.grad(..., allow_unused=True)``, public API: a walk
    of ``grad_fn.next_functions`` that looks for ``AccumulateGrad``
    nodes by their attributes leans on internals that differ between
    torch builds (under torch 2.11 such a walk reached no leaf)."""
    from .ndarray.ndarray import _MARKED, _MARKED_LOCK

    with _MARKED_LOCK:  # another thread may mark a leaf meanwhile
        marked = list(_MARKED)
    return [nd for nd in marked
            if nd._marked and nd._grad_req != "null"
            and nd._leaf is not None]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run backward from ``heads``, writing into the leaves' ``.grad``."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]

    leaf_grads = {}  # id(leaf) -> (leaf, summed grad) of this pass

    def _add(leaf, g):
        prev = leaf_grads.get(id(leaf))
        leaf_grads[id(leaf)] = (leaf, g if prev is None else prev[1] + g)

    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        g = torch.ones_like(h._data) if hg is None else hg._data
        if h._data.grad_fn is None:
            # the head is itself a leaf: its gradient is the head grad
            if h._marked and h._grad_req != "null":
                _add(h, g)
            continue
        outs.append(h._data)
        grads.append(g)
    if not outs and not any(h._marked for h in heads):
        raise MXNetError(
            "cannot differentiate: no recorded graph reaches the heads (did "
            "you call attach_grad() and compute inside autograd.record()?)")
    found = _candidates() if outs else []
    if found:
        gs = torch.autograd.grad(outs, [nd._leaf for nd in found], grads,
                                 retain_graph=retain_graph,
                                 allow_unused=True)
        for leaf, g in zip(found, gs):
            if g is not None:
                _add(leaf, g)

    for leaf, g in leaf_grads.values():
        g = g.detach().to(leaf._data.dtype)
        if leaf._grad is None:
            leaf._grad = NDArray(torch.zeros_like(leaf._data.detach()))
        if leaf._grad_req == "add":
            leaf._grad._data = leaf._grad._data + g
        else:
            leaf._grad._data = g
        leaf._fresh_grad = True


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (reference
    autograd.py:270), returned as new NDArrays; no ``.grad`` buffer is
    touched. A variable the heads do not reach gets zeros. With
    ``create_graph=True`` the gradients are themselves in the graph
    (``torch.autograd.grad(..., create_graph=True)``): an op on them
    inside ``record()`` can be differentiated again."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if head_grads is None:
        hgs = [torch.ones_like(h._data) for h in heads]
    else:
        if not isinstance(head_grads, (list, tuple)):
            head_grads = [head_grads]
        hgs = [g._data if isinstance(g, NDArray) else torch.as_tensor(g)
               for g in head_grads]
    # the tensor the graph holds for each variable: a marked leaf's own
    # leaf (its _data may have been rebound since)
    wrt = [v._leaf if v._leaf is not None else v._data for v in variables]
    if not any(h._data.requires_grad for h in heads):
        raise MXNetError(
            "cannot differentiate: no recorded graph reaches the heads (did "
            "you call attach_grad() and compute inside autograd.record()?)")
    with torch.enable_grad():
        gs = torch.autograd.grad(
            [h._data for h in heads], wrt, hgs,
            retain_graph=create_graph if retain_graph is None
            else bool(retain_graph),
            create_graph=create_graph, allow_unused=True)
    out = []
    for v, g in zip(variables, gs):
        if g is None:
            g = torch.zeros_like(v._data)
        out.append(NDArray(g if create_graph else g.detach()))
    return out


def get_symbol(x):
    """Not supported, as in the JAX package: a recorded graph is torch's
    tape, not a Symbol (build a HybridBlock or a Symbol instead)."""
    raise MXNetError("autograd.get_symbol is not supported; build the "
                     "network as a Symbol or a gluon HybridBlock instead")


class _FunctionBridge(torch.autograd.Function):
    """The torch node of one :class:`Function` call: forward and backward
    run the user's methods on NDArrays around the tensors, paused."""

    @staticmethod
    def forward(ctx, fn, inputs, info, *tensors):
        from .ndarray.ndarray import NDArray

        args = list(inputs)
        for slot, t in zip(info["slots"], tensors):
            args[slot] = NDArray(t)
        with pause():
            outputs = fn.forward(*args)
        info["single"] = isinstance(outputs, NDArray)
        ctx.fn = fn
        outs = (outputs,) if info["single"] else tuple(outputs)
        # an input handed back as it is would alias the node's own input
        return tuple(o._data.clone() if any(o._data is t for t in tensors)
                     else o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        with pause():
            igs = ctx.fn.backward(*[NDArray(g) for g in grads])
        if isinstance(igs, NDArray) or igs is None:
            igs = (igs,)
        return (None, None, None) + tuple(
            ig._data if ig is not None and need else None
            for ig, need in zip(igs, ctx.needs_input_grad[3:]))


class Function:
    """Custom differentiable function (reference autograd.py:363).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)``; both take and return NDArrays and
    run with recording paused. ``backward`` returns one gradient per
    NDArray input (None for none).
    """

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        slots = [i for i, x in enumerate(inputs) if isinstance(x, NDArray)]
        if not (is_recording() and any(inputs[i]._in_graph for i in slots)):
            with pause():
                return self.forward(*inputs)
        info = {"slots": slots}
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, inputs, info,
                                         *[inputs[i]._data for i in slots])
        result = [NDArray(o) for o in outs]
        return result[0] if info["single"] else tuple(result)
