"""Step executors on one card: the port of ``mxnet_tpu/parallel.py``'s
``device_mesh`` (``:52-76``), ``TrainStep`` and ``InferStep``
(``:479-848``).

The JAX package compiles a whole training step (forward, loss, backward,
optimizer update) into one XLA module per input shape, and ``multi_call``
scans K steps inside one module. The port's counterpart is a CUDA graph:
at the first call for a shape, :class:`TrainStep` runs the step once
eagerly on a side stream (cuDNN picks its algorithms there, and the
step's state is put back afterwards), then captures forward, backward
and the fused optimizer apply (``Optimizer.pure_step`` over every
parameter) as one ``torch.cuda.CUDAGraph`` over static tensors: the
batch, the label, the step count and the learning rate (0-d device
tensors), the step's own parameters, optimizer states and BatchNorm
moving statistics. A call copies its batch into the static inputs and
replays the graph; ``multi_call`` does that K times. Nothing in the step
reads a value back to the host, and each graph has its own memory pool.
A capture that fails raises: the step never goes on eagerly. The capture
runs in CUDA's relaxed mode: inside it cuDNN may pick another algorithm
than in the eager pass, whose kernel module CUDA then loads lazily, and
the thread-local mode refuses that load (on the card a capture failed so,
CUDNN_STATUS_INTERNAL_ERROR, after other steps had run in the process,
and passed with ``CUDA_MODULE_LOADING=EAGER``). A read back to the host
still fails the capture: it synchronizes the capturing stream.

``compile_count`` counts captures (on the CPU, where there are no graphs,
the first run of each shape), and ``steady_state_recompiles`` the
captures made after the first call, which stay 0 while the shapes do.

A net cast to bfloat16 (``net.cast("bfloat16")``) trains as the JAX
step trains it (``mxnet_tpu/parallel.py:552-563``, ``:605-610``): the
optimizer states are made, then kept, in float32; the update's math runs
in float32 (``Optimizer._scale_lr`` promotes where JAX does); the stored
weight keeps the model's dtype; the loss is bfloat16.

``TrainStep(remat=True)`` checkpoints the forward and the loss
(``torch.utils.checkpoint``, non-reentrant) where the JAX step wraps
them in ``jax.checkpoint``; the recompute leaves BatchNorm's moving
statistics alone. ``memory_analysis()`` reports the last single-step
path's memory under the attribute names of XLA's ``CompiledMemoryStats``
(:class:`MemoryStats`).

Departures: one device (``device_mesh`` of more raises "not ported
yet"). The parameters are copied once at the first call and updated in
place, where the JAX package donates and rebinds them.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch
import torch.utils.checkpoint

from . import autograd
from .base import MXNetError, resolve_device
from .context import Context, from_device
from .gluon.parameter import DeferredInitializationError
from .ndarray.ndarray import NDArray
from .telemetry import accounting as _accounting

__all__ = ["Mesh", "device_mesh", "TrainStep", "InferStep",
           "MemoryStats"]


class Mesh(object):
    """A one-device mesh: ``devices`` (a list of one ``torch.device``) and
    ``axis_names``, the JAX mesh's two attributes a step reads."""

    def __init__(self, device, axis_names=("dp",)):
        self.device = device
        self.devices = [device]
        self.axis_names = tuple(axis_names)

    def __repr__(self):
        return "Mesh(%s, axis_names=%s)" % (self.device, self.axis_names)


def _as_device(dev) -> torch.device:
    if isinstance(dev, Context):
        dev = dev.torch_device()
    return resolve_device(dev)


def device_mesh(n_devices=None, axis_names=("dp",), shape=None,
                devices=None) -> Mesh:
    """A mesh of one device: the card unless ``devices`` names another
    (``[mx.cpu()]``, ``["cpu"]``, a ``torch.device``). More than one
    device is not ported yet."""
    if devices is None:
        devices = [None]  # the card; raises when there is none
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    size = int(np.prod(shape)) if shape is not None else len(devices)
    if len(devices) != 1 or size != 1 or (n_devices or 1) != 1:
        raise MXNetError("a mesh of %d devices is not ported yet: the port "
                         "runs a step on one" % max(len(devices), size,
                                                    n_devices or 1))
    return Mesh(_as_device(devices[0]), axis_names)


@contextlib.contextmanager
def _bound(params, tensors):
    """Run the net on ``tensors`` (name -> tensor) in place of its
    parameters' own arrays, as the JAX package's ``_base_fn`` does: each
    Parameter's data is swapped for an NDArray over the step's tensor, so
    a BatchNorm layer's in-place moving-statistic update lands there."""
    saved = {}
    try:
        for name, t in tensors.items():
            p = params[name]
            saved[name] = p._data
            p._data = OrderedDict([(from_device(t.device), NDArray(t))])
        yield
    finally:
        for name, data in saved.items():
            params[name]._data = data


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.asarray(x))


class MemoryStats(object):
    """A step's memory, under the attribute names of XLA's
    ``CompiledMemoryStats`` that ``example/memcost/memonger.py`` reads.

    ``temp_size_in_bytes`` is the memory the step needs beyond what was
    resident before it, measured at the path's first run. On the card
    that is the peak of ``torch.cuda.max_memory_allocated`` during the
    eager pass that precedes the capture, less what was allocated before
    it: activations kept for the backward, workspaces and gradients
    together (the pass resets the device's peak statistics). On the CPU
    it is the bytes of the tensors autograd saves for the backward
    (``torch.autograd.graph.saved_tensors_hooks``, each storage once),
    the parameters and the batch left out: the activation workspace
    alone. ``argument_size_in_bytes`` counts the parameters, the
    optimizer states, the batch and the step's scalars;
    ``output_size_in_bytes`` the loss, the parameters and the states, as
    the JAX step returns them; ``alias_size_in_bytes`` the parameters and
    the states, which the port updates in place (the JAX step donates
    them); ``generated_code_size_in_bytes`` is 0 (the port generates no
    code)."""

    def __init__(self, temp, argument, output, alias):
        self.temp_size_in_bytes = int(temp)
        self.argument_size_in_bytes = int(argument)
        self.output_size_in_bytes = int(output)
        self.alias_size_in_bytes = int(alias)
        self.generated_code_size_in_bytes = 0

    def __repr__(self):
        return ("MemoryStats(temp=%d, argument=%d, output=%d, alias=%d)"
                % (self.temp_size_in_bytes, self.argument_size_in_bytes,
                   self.output_size_in_bytes, self.alias_size_in_bytes))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _measure(device, fn, resident):
    """Run ``fn`` once; return ``(its result, its temp bytes)`` as
    :class:`MemoryStats` defines them. ``resident`` are the tensors the
    step holds (left out of the count on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        torch.cuda.synchronize(device)
        return out, torch.cuda.max_memory_allocated(device) - base
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved.setdefault(st.data_ptr(), st.nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    skip = {t.untyped_storage().data_ptr() for t in resident}
    return out, sum(n for ptr, n in saved.items() if ptr not in skip)


class _Path(object):
    """One shape: its static inputs, the function over them, and once
    ``ready`` its graph and the graph's output (no graph on the CPU, or
    with ``capture=False``: the function runs at every call).
    ``temp_bytes`` and ``out_bytes`` are measured at the function's first
    run."""

    def __init__(self, inputs, fn):
        self.inputs = inputs
        self.fn = fn
        self.ready = False
        self.graph = None
        self.out = None
        self.temp_bytes = None
        self.out_bytes = 0


def _param_snapshot(params, device) -> OrderedDict:
    """name -> a copy of each parameter's value on ``device``."""
    return OrderedDict((n, p.data()._data.detach().to(device, copy=True))
                       for n, p in params.items())


class _Graphs(object):
    """The capture and replay of paths, one CUDA graph a path, on one
    device and a side stream: what the step executors here and the
    serving engines (``serving/engine.py``) share. ``compile_count``
    counts captures (on the CPU: paths run), ``graph_replays`` replays."""

    _site = "parallel"

    def __init__(self, device):
        self._device = device
        self._paths: Dict[Any, _Path] = {}
        self._stream = None
        self._captures = 0
        self._replays = 0

    @property
    def compile_count(self) -> int:
        """Paths captured (on the CPU: shapes run) so far."""
        return self._captures

    @property
    def graph_replays(self) -> int:
        return self._replays

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        return self._stream

    def _state_tensors(self):
        """Every tensor the path's function writes outside its graph's
        own pool (none for a forward)."""
        return []

    def _first_run(self, path: _Path):
        return path.fn()

    def _run(self, path: _Path):
        if not path.ready:
            self._capture(path)
        if path.graph is None:
            return self._first_run(path)
        path.graph.replay()
        self._replays += 1
        return path.out

    def _capture(self, path: _Path):
        """Capture ``path`` as a CUDA graph (on the CPU, only count it).
        The eager pass on the capture stream comes first, as PyTorch asks;
        it changes the path's state, which is put back before capture."""
        t0 = time.perf_counter()
        if self._device.type == "cuda":
            stream = self._side_stream()
            state = self._state_tensors()
            saved = [t.detach().clone() for t in state]
            stream.wait_stream(torch.cuda.current_stream(self._device))
            with torch.cuda.stream(stream):
                self._first_run(path)
                with torch.no_grad():
                    for t, s in zip(state, saved):
                        t.copy_(s)
            torch.cuda.current_stream(self._device).wait_stream(stream)
            del saved
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="relaxed"):
                    out = path.fn()
            except Exception as exc:
                raise MXNetError(
                    "%s: capturing the path over %s as a CUDA graph "
                    "failed: %s" % (type(self).__name__,
                                    [tuple(t.shape) for t in path.inputs],
                                    exc)) from exc
            path.graph, path.out = graph, out
        path.ready = True
        self._captures += 1
        _accounting.note_recompile(self._site, 1, time.perf_counter() - t0)


class _Executor(_Graphs):
    """What TrainStep and InferStep share: the mesh's device, the snapshot
    of the net's parameters, and the memory of each path's first run."""

    def __init__(self, net, mesh, batch_axis):
        if batch_axis != 0:
            raise MXNetError("batch_axis %d is not ported yet (0 only)"
                             % batch_axis)
        self._mesh = mesh if mesh is not None else device_mesh()
        super().__init__(self._mesh.device)
        self._net = net
        self._pvals = None
        self._first_call_captures = None

    @property
    def steady_state_recompiles(self) -> int:
        """Captures made after the first call returned."""
        if self._first_call_captures is None:
            return 0
        return self._captures - self._first_call_captures

    def _snapshot(self, data):
        """The net's parameters as tensors on the mesh's device, after
        finishing deferred initialization with one paused forward."""
        params = self._net.collect_params()
        try:
            for p in params.values():
                p.data()
        except DeferredInitializationError:
            with autograd.pause():
                self._net(NDArray(data.to(self._device)))
        return params, _param_snapshot(params, self._device)

    def _static(self, x):
        return torch.empty(x.shape, dtype=x.dtype, device=self._device)

    def _first_run(self, path: _Path):
        """Run the path's function, measuring its memory at the first
        run."""
        if path.temp_bytes is not None:
            return path.fn()
        out, path.temp_bytes = _measure(
            self._device, path.fn, self._state_tensors() + list(path.inputs))
        path.out_bytes = _nbytes([out])
        return out

    def _end_call(self):
        if self._first_call_captures is None:
            self._first_call_captures = self._captures
        _accounting.set_steady_state_recompiles(
            self._site, self.steady_state_recompiles)


def _float32_state(state):
    """A state with every floating tensor in float32."""
    if isinstance(state, tuple):
        return tuple(_float32_state(s) for s in state)
    if isinstance(state, torch.Tensor) and state.is_floating_point():
        return state.to(torch.float32)
    return state


def _remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs
    with the recording and train state of the first forward (it may run
    on autograd's device thread, whose state is the default), flagged as
    a recompute."""
    return contextlib.nullcontext(), autograd._recompute_scope(
        autograd.is_training())


class TrainStep(_Executor):
    """One training step (forward + mean loss + backward + the fused
    optimizer apply) captured as a CUDA graph per input shape.

    ``step = TrainStep(net, loss_fn, optimizer, mesh)``, then ``loss =
    step(data, label)`` or ``losses = step.multi_call(datas, labels)``
    (a leading steps axis). The step trains its own copies of the
    parameters, made at the first call; ``copy_to_net()`` writes them
    back. Only parameters with ``grad_req != "null"`` take gradients;
    each is updated by ``optimizer.pure_step`` at ``lr * lr_mult`` and
    ``wd * wd_mult``, the multipliers taken from the Parameter. BatchNorm
    moving statistics are updated as the JAX step's aux outputs are.

    ``capture=False`` runs the same step function eagerly on the card,
    for comparing against the captured step; it is never a fallback.

    In bfloat16 the optimizer states are float32 and the update's math
    too, the weights stay bfloat16 (see the module's docstring).
    ``remat=True`` recomputes the forward in the backward instead of
    keeping its activations.
    """

    _site = "parallel.TrainStep"

    def __init__(self, net, loss_fn, optimizer, mesh=None,
                 optimizer_params=None, batch_axis=0, remat=False,
                 capture=True):
        from . import optimizer as opt_mod

        super().__init__(net, mesh, batch_axis)
        self._remat = remat
        self._loss = loss_fn
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._optimizer = optimizer
        self._capture_graphs = capture
        self._params = None
        self._diff = ()
        self._states = None
        self._lr_mults = self._wds = ()
        self._t = 0
        self._t_dev = self._lr_dev = None
        self._last_path = None

    def _ensure_init(self, data):
        if self._pvals is not None:
            return
        self._params, self._pvals = self._snapshot(data)
        opt = self._optimizer
        self._diff = tuple(n for n, p in self._params.items()
                           if p.grad_req != "null")
        for n in self._diff:
            self._pvals[n].requires_grad_(True)
        # the states stay float32 whatever the weight's dtype (the JAX
        # step casts them, mxnet_tpu/parallel.py:552-563)
        self._states = [_float32_state(opt.create_state(n, self._pvals[n]))
                        for n in self._diff]
        self._lr_mults = [self._params[n].lr_mult for n in self._diff]
        self._wds = [opt.wd * self._params[n].wd_mult for n in self._diff]
        self._t_dev = torch.zeros((), dtype=torch.float32,
                                  device=self._device)
        self._lr_dev = torch.zeros((), dtype=torch.float32,
                                   device=self._device)

    def _state_tensors(self):
        out = list(self._pvals.values())
        for s in self._states:
            if s is not None:
                out += [t for t in s if t is not None] \
                    if isinstance(s, tuple) else [s]
        return out

    def _mean_loss(self, data, label):
        out = self._net(NDArray(data))
        if isinstance(out, (tuple, list)):
            out = out[0]
        return self._loss(out, NDArray(label))._data.mean()

    def _step_fn(self, data, label):
        """The step on the static tensors: returns the 0-d mean loss."""
        ws = [self._pvals[n] for n in self._diff]
        # the backward stays inside _bound: remat's recompute runs the net
        # there, and must see the step's parameters
        with _bound(self._params, self._pvals):
            with autograd.record():
                if self._remat:
                    loss = torch.utils.checkpoint.checkpoint(
                        self._mean_loss, data, label, use_reentrant=False,
                        preserve_rng_state=False, context_fn=_remat_contexts)
                else:
                    loss = self._mean_loss(data, label)
            grads = torch.autograd.grad(loss, ws, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(ws, grads)]
        with torch.no_grad():
            self._optimizer.pure_step(ws, grads, self._states, self._t_dev,
                                      self._lr_dev, self._lr_mults,
                                      self._wds)
        return loss.detach()

    def _path(self, data, label) -> _Path:
        key = (tuple(data.shape), data.dtype, tuple(label.shape),
               label.dtype)
        path = self._paths.get(key)
        if path is None:
            d, lab = self._static(data), self._static(label)
            path = _Path((d, lab), lambda: self._step_fn(d, lab))
            path.ready = not self._capture_graphs  # eager: never captured
            self._paths[key] = path
        return path

    def _replay_step(self, path, data, label, t):
        d, lab = path.inputs
        d.copy_(data)
        lab.copy_(label)
        self._t_dev.fill_(float(t))
        return self._run(path)

    def __call__(self, data, label):
        data, label = _host_tensor(data), _host_tensor(label)
        self._ensure_init(data)
        # one step counter, shared with eager Trainer/Updater steps
        # (parallel.py:667-668)
        self._t = max(self._t, self._optimizer.num_update) + 1
        self._optimizer.sync_num_update(self._t)
        self._lr_dev.fill_(float(self._optimizer.learning_rate))
        path = self._last_path = self._path(data, label)
        loss = self._replay_step(path, data, label, self._t).clone()
        self._end_call()
        return NDArray(loss)

    def multi_call(self, datas, labels):
        """K training steps, one per slice of the leading axis of
        ``datas``/``labels``: each slice is copied into the static inputs
        and the step replayed (the counterpart of the JAX package's
        ``lax.scan``). The learning rate is sampled once per call. Returns
        the K losses as an NDArray of shape (K,), in the loss's dtype."""
        datas, labels = _host_tensor(datas), _host_tensor(labels)
        k = int(datas.shape[0])
        self._ensure_init(datas[0])
        self._t = max(self._t, self._optimizer.num_update) + k
        self._optimizer.sync_num_update(self._t)
        self._lr_dev.fill_(float(self._optimizer.learning_rate))
        path = self._path(datas[0], labels[0])
        first = self._t - k + 1  # the first step's 1-based count
        losses = None
        for i in range(k):
            loss = self._replay_step(path, datas[i], labels[i], first + i)
            if losses is None:
                losses = torch.empty((k,), dtype=loss.dtype,
                                     device=self._device)
            losses[i] = loss
        self._end_call()
        return NDArray(losses)

    def memory_analysis(self) -> MemoryStats:
        """The memory of the last single-step path (``__call__``'s), as
        :class:`MemoryStats` defines it: on the card the step's peak
        above what was resident before it, on the CPU the activations
        saved for the backward. Raises before the first ``__call__``."""
        path = self._last_path
        if path is None or path.temp_bytes is None:
            raise MXNetError("memory_analysis: run the step once first")
        held = self._state_tensors()
        scalars = [self._t_dev, self._lr_dev]
        return MemoryStats(
            temp=path.temp_bytes,
            argument=_nbytes(held + list(path.inputs) + scalars),
            output=_nbytes(held) + path.out_bytes,
            alias=_nbytes(held))

    def copy_to_net(self):
        """Write the trained parameters (and moving statistics) back into
        the net's own arrays, in place."""
        if self._pvals is None:
            return self._net
        with torch.no_grad():
            for n, v in self._pvals.items():
                dst = self._params[n].data()._data
                dst.copy_(v.to(dst.device))
        return self._net

    @property
    def params(self):
        """name -> the step's parameter tensor (None before the first
        call)."""
        return self._pvals


class InferStep(_Executor):
    """Batched inference in predict mode (BatchNorm on its moving
    statistics), captured as a CUDA graph per input shape; ``multi_call``
    replays it once per slice of a leading steps axis. The parameters are
    snapshot at the first call; ``refresh_params()`` copies the net's
    current values into that snapshot in place, keeping the graphs."""

    _site = "parallel.InferStep"

    def __init__(self, net, mesh=None, batch_axis=0):
        super().__init__(net, mesh, batch_axis)
        self._params = None

    def _ensure_init(self, data):
        if self._pvals is None:
            self._params, self._pvals = self._snapshot(data)

    def refresh_params(self):
        """Re-snapshot the net's current parameter values."""
        if self._pvals is None:
            return
        with torch.no_grad():
            for n, v in self._pvals.items():
                v.copy_(self._params[n].data()._data)

    def _forward(self, data):
        with _bound(self._params, self._pvals), autograd.pause(), \
                torch.no_grad():
            out = self._net(NDArray(data))
        return (out[0] if isinstance(out, (tuple, list)) else out)._data

    def _path(self, data) -> _Path:
        key = (tuple(data.shape), data.dtype)
        path = self._paths.get(key)
        if path is None:
            d = self._static(data)
            path = self._paths[key] = _Path((d,), lambda: self._forward(d))
        return path

    def _replay(self, path, data):
        path.inputs[0].copy_(data)
        return self._run(path)

    def __call__(self, data):
        data = _host_tensor(data)
        self._ensure_init(data)
        out = self._replay(self._path(data), data).clone()
        self._end_call()
        return NDArray(out)

    def multi_call(self, datas):
        datas = _host_tensor(datas)
        self._ensure_init(datas[0])
        path = self._path(datas[0])
        outs = [self._replay(path, datas[i]).clone()
                for i in range(int(datas.shape[0]))]
        self._end_call()
        return NDArray(torch.stack(outs))
