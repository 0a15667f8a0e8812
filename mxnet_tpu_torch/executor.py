"""Executor: a bound Symbol, the port of ``mxnet_tpu/executor.py``.

Where the JAX executor jits the whole graph and takes a ``jax.vjp`` of it
(``mxnet_tpu/executor.py:87-183``), this one walks the graph eagerly
(:meth:`Symbol.eval_torch`):

* ``forward(is_train=True)`` evaluates under torch autograd, with each
  argument whose ``grad_req`` is not ``null`` entered as a fresh leaf
  tensor (sharing the argument's storage), and keeps the outputs' graph
  for one backward;
* ``forward(is_train=False)`` evaluates under ``torch.no_grad()``;
* ``backward(out_grads)`` takes ``torch.autograd.grad`` from the outputs
  to those leaves, feeding ones to every output when ``out_grads`` is
  None (``executor.py:275-277``). Outputs that carry no gradient
  (``BlockGrad``, ``MultiBoxDetection``, whose JAX forms stop gradients)
  are left out; ops with a gradient of their own (``SoftmaxOutput``,
  ``MakeLoss``) apply it. Gradients land in ``grad_dict`` under
  ``grad_req``: ``write`` rebinds, ``add`` accumulates, ``null`` skips.

``forward(is_train=True)`` also moves the BatchNorm moving statistics,
written in place into ``aux_dict`` (``executor.py:225-227`` rebinds
them). A callback set by :meth:`Executor.set_monitor_callback` (a
``Monitor``) gets each output by name after every forward. The graph is held from forward to backward and freed by it.
``trainplane.module_plane`` captures the same forward, backward and
update as one CUDA graph a step. :meth:`Executor.reshape` binds the graph
anew for other input shapes, keeping every array whose shape holds.
"""
from __future__ import annotations

from typing import List

import torch

from . import autograd
from .base import MXNetError
from .context import Context, current_context
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]


def _same_memory(a, b):
    """Whether tensors ``a`` and ``b`` are the same elements in memory."""
    return a.data_ptr() == b.data_ptr() and a.device == b.device \
        and a.shape == b.shape and a.dtype == b.dtype \
        and a.stride() == b.stride()


class Executor(object):
    """A bound computation graph (reference executor.py:45).

    ``args``/``args_grad``/``aux_states`` are dicts, or lists of NDArrays
    in ``list_arguments()`` order, as for ``Symbol.bind``."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else current_context()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        self.arg_dict = self._as_dict(args, self.arg_names, "args")
        self.arg_arrays = [self.arg_dict[n] for n in self.arg_names]
        self.grad_dict = {} if args_grad is None else self._as_dict(
            args_grad, self.arg_names, "args_grad", allow_missing=True)
        self.grad_arrays = [self.grad_dict.get(n) for n in self.arg_names]
        self.aux_dict = self._as_dict(aux_states or {}, self.aux_names,
                                      "aux_states")
        self.aux_arrays = [self.aux_dict[n] for n in self.aux_names]

        if isinstance(grad_req, str):
            self.grad_req = dict.fromkeys(self.arg_names, grad_req)
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self.grad_req = dict(grad_req)
        bad = {r for r in self.grad_req.values()
               if r not in ("write", "add", "null")}
        if bad:
            raise MXNetError("grad_req must be write, add or null, got %s"
                             % sorted(bad))

        self.outputs: List[NDArray] = []
        self._heads = None  # (output tensors, leaves, names) for backward
        self._monitor_callback = None

    @staticmethod
    def _as_dict(vals, names, what, allow_missing=False):
        if isinstance(vals, dict):
            missing = [n for n in names if n not in vals]
            if missing and not allow_missing:
                raise MXNetError("%s: missing bindings for %s"
                                 % (what, missing))
            return {n: vals[n] for n in names if n in vals}
        vals = list(vals)
        if len(vals) != len(names):
            raise MXNetError("%s: expected %d arrays, got %d"
                             % (what, len(names), len(vals)))
        return dict(zip(names, vals))

    def forward(self, is_train=False, **kwargs):
        """Run the graph (reference executor.py:114); keyword arrays
        rebind arguments first."""
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("unknown argument %r" % name)
            self.arg_dict[name]._data = val._data if isinstance(
                val, NDArray) else torch.as_tensor(
                    val, device=self.arg_dict[name]._data.device)
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update((n, a._data) for n, a in self.aux_dict.items())
        self._heads = None
        if is_train:
            diff = [n for n in self.arg_names
                    if self.grad_req.get(n, "null") != "null"
                    and n in self.grad_dict]
            outs, leaves = self._train_forward(values, diff)
            self._heads = (outs, leaves, diff)
        else:
            with autograd.predict_mode(), torch.no_grad():
                outs = self._symbol.eval_torch(
                    values, device=self._ctx.torch_device())
        self.outputs = [NDArray(o.detach()) for o in outs]
        if self._monitor_callback is not None:
            # the graph's outputs, as the JAX executor hands them
            # (mxnet_tpu/executor.py:231-233)
            for name, out in zip(self.output_names, self.outputs):
                self._monitor_callback(name, out)
        return self.outputs

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, array)`` for each output after every
        forward (reference executor.py:set_monitor_callback)."""
        self._monitor_callback = callback

    def _train_forward(self, values, diff):
        """The graph in train mode over ``values`` (name -> tensor), with
        the arguments ``diff`` entered as fresh leaves sharing their
        storage; the BatchNorm moving statistics are written in place into
        the auxiliary arrays (their addresses stay: ``trainplane``'s
        captured step replays this). Returns ``(outputs, leaves)``."""
        leaves = []
        for n in diff:
            leaf = values[n].detach().requires_grad_(True)
            values[n] = leaf
            leaves.append(leaf)
        aux_updates = {}
        with autograd.train_mode(), torch.enable_grad():
            outs = self._symbol.eval_torch(
                values, aux_updates=aux_updates,
                device=self._ctx.torch_device())
        with torch.no_grad():
            for name, val in aux_updates.items():
                if name in self.aux_dict:
                    self.aux_dict[name]._data.copy_(val)
        return outs, leaves

    @staticmethod
    def _head_grads(outs, leaves, cts):
        """Gradients of ``outs`` seeded with ``cts`` with respect to
        ``leaves``; zeros for a leaf no output reaches."""
        pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        if pairs and leaves:
            grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                        [c for _, c in pairs],
                                        allow_unused=True)
        else:
            grads = [None] * len(leaves)
        return [torch.zeros_like(leaf) if g is None else g
                for leaf, g in zip(leaves, grads)]

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last ``forward(is_train=True)`` into
        ``grad_dict`` (reference executor.py:155)."""
        if self._heads is None:
            raise MXNetError("backward needs a fresh forward(is_train=True)")
        outs, leaves, names = self._heads
        self._heads = None  # one backward per forward, as in the JAX one
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cts = [g._data if isinstance(g, NDArray)
                   else torch.as_tensor(g, device=o.device)
                   for g, o in zip(out_grads, outs)]
        grads = self._head_grads(outs, leaves, cts)
        for name, g in zip(names, grads):
            tgt = self.grad_dict[name]
            if self.grad_req[name] == "add":
                tgt._data = tgt._data + g
            else:
                tgt._data = g

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values into the bound arrays (reference
        executor.py:copy_params_from), in place where the value has the
        bound array's shape and dtype, so a CUDA graph holding the array
        replays with the new value; a value of another shape or dtype is
        rebound (on this executor's device) instead. A value that is the
        bound array's own memory (a bucket's executors share their
        parameters) costs no copy."""
        dev = self._ctx.torch_device()
        for src, dst, what in ((arg_params, self.arg_dict, "arguments"),
                               (aux_params or {}, self.aux_dict,
                                "auxiliary states")):
            for name, array in src.items():
                if name in dst:
                    held, value = dst[name]._data, array._data.detach()
                    if _same_memory(held, value):
                        continue
                    if held.shape == value.shape and \
                            held.dtype == value.dtype:
                        with torch.no_grad():
                            held.copy_(value)
                    else:
                        dst[name]._data = value.to(dev)
                elif not allow_extra_params:
                    raise MXNetError("Found name \"%s\" that is not in the "
                                     "%s" % (name, what))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor of the same graph for the input shapes in
        ``kwargs`` (reference executor.py:372; ``mxnet_tpu/executor.py:
        295-323``): every argument, gradient and auxiliary array whose
        shape is unchanged is this executor's own NDArray, the others are
        new zeros on this executor's device. ``partial_shaping`` and
        ``allow_up_sizing`` are accepted and unused, as in the JAX
        package: nothing is preallocated to outgrow."""
        from .ndarray import ndarray as nd_mod

        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def keep(old, shape):
            if old is not None and tuple(old.shape) == tuple(shape):
                return old
            return nd_mod.zeros(shape, ctx=self._ctx, dtype=old.dtype)

        new_args = {n: keep(self.arg_dict[n], s)
                    for n, s in zip(self.arg_names, arg_shapes)}
        new_grads = {n: keep(g, new_args[n].shape)
                     for n, g in self.grad_dict.items()} or None
        new_aux = {n: keep(self.aux_dict[n], s)
                   for n, s in zip(self.aux_names, aux_shapes)}
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self.grad_req, new_aux)

    @property
    def output_dict(self):
        """name -> the last forward's output NDArray."""
        return dict(zip(self.output_names, self.outputs))

    def debug_str(self):
        return ("Symbolic executor over %d args, %d outputs (an eager "
                "graph walk under torch autograd)"
                % (len(self.arg_names), len(self.output_names)))
