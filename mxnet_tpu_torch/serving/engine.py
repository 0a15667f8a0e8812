"""Engine: what executes one padded batch. The batcher doesn't care.

Ported from ``mxnet_tpu/serving/engine.py``. An :class:`Engine` maps a host
``(bucket, *sample_shape)`` numpy batch to host numpy outputs — the whole
device round trip (copy in, run, one batched device-to-host copy out)
lives behind ``run``. Two production backends ship here:

* :class:`BlockEngine` — a live initialized Gluon block, served from one
  snapshot of its parameters on the engine's device;
* :class:`StableHLOEngine` — a loaded ``aot.export_model`` artifact, a
  ``torch.export`` program (``model.pt2``). Artifacts exported with
  ``poly_batch=True`` carry a symbolic batch dimension and serve the whole
  bucket ladder from one file. The class keeps the JAX package's name so
  that code written against it (and :func:`serve_stablehlo`) reads the
  same.

On the card each batch shape is one CUDA graph, captured at the shape's
first run: the forward runs once eagerly on the engine's stream (cuDNN
and cuBLAS pick their algorithms there), then is captured in CUDA's
relaxed mode, by the code that captures ``parallel``'s steps. A run copies the batch into
the shape's static input through one pinned staging buffer, replays the
graph and copies every output back in one batched transfer. Every
device operation of an engine runs on its own stream under its lock, so
a shape captured on one thread (``Server.warmup``) replays on another
(the batcher's) whatever stream each thread has current. ``compile_count``
counts captures (on the CPU, where there are no graphs, the shapes run);
a capture that fails raises :class:`MXNetError`.

Tests implement throwaway subclasses (slow/poisoned engines) to drive the
batcher's failure paths — anything with ``run`` + ``compile_count`` serves.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Tuple, Union

import numpy as np
import torch

from ..base import fetch_host, torch_dtype
from ..context import current_context, from_device
from ..ndarray.ndarray import NDArray
from ..parallel import _as_device, _bound, _Graphs, _param_snapshot, _Path

__all__ = ["Engine", "BlockEngine", "StableHLOEngine"]

BatchOut = Union[np.ndarray, Tuple[np.ndarray, ...]]


class Engine:
    """Interface: run one fixed-shape batch, report compile activity."""

    #: Short identifier used in breaker sites and engine-event telemetry
    #: (``mxnet_breaker_state{site="serving.<server>.<kind>"}``); concrete
    #: engines override it so a tripped breaker names what tripped.
    kind = "engine"

    def run(self, batch: np.ndarray) -> BatchOut:
        """Execute one padded batch; return host output(s) whose leading
        axis aligns with the input batch axis."""
        raise NotImplementedError

    @property
    def compile_count(self) -> int:
        """Distinct shapes compiled so far; -1 when the backend can't tell.
        A steady-state serve must leave this unchanged."""
        return -1


def _engine_device(device=None) -> torch.device:
    """The device an engine serves on: ``device`` (a ``Context``, a
    ``torch.device`` or its name), else the current context — the card
    unless the caller is inside ``with mx.cpu():``. Raises
    :class:`MXNetError` when that is the card and there is none."""
    return _as_device(current_context() if device is None else device)


class _GraphEngine(_Graphs, Engine):
    """What both engines share: the lock every run takes, the engine's
    own stream for every device operation, and one path (a CUDA graph on
    the card, captured by ``parallel``'s :class:`_Graphs`) a batch shape,
    fed through one pinned staging buffer."""

    _site = "serving.engine"

    def __init__(self, device, dtype):
        super().__init__(device)
        self._tdtype = torch_dtype(dtype)
        self._lock = threading.Lock()
        self._staging = {}
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._side_stream()

    def _forward(self, x):
        """The served function over one input tensor: an output tensor,
        or a tuple of them."""
        raise NotImplementedError

    def _on_stream(self):
        if self._cuda:
            return torch.cuda.stream(self._stream)
        return contextlib.nullcontext()

    def _after_caller(self):
        """Order the engine's stream after the caller's current stream
        (its tensors may still be in flight there)."""
        if self._cuda:
            self._stream.wait_stream(torch.cuda.current_stream(self._device))

    def _before_caller(self):
        """Order the caller's current stream after the engine's (what the
        engine read may be changed or freed there next)."""
        if self._cuda:
            torch.cuda.current_stream(self._device).wait_stream(self._stream)

    def _new_path(self, shape) -> _Path:
        static = torch.empty(shape, dtype=self._tdtype, device=self._device)
        if self._cuda:
            host = torch.float32 if self._tdtype == torch.bfloat16 \
                else self._tdtype
            self._staging[shape] = torch.empty(shape, dtype=host,
                                               pin_memory=True)
        path = self._paths[shape] = _Path((static,),
                                          lambda: self._forward(static))
        return path

    def _stage(self, path: _Path, batch: np.ndarray):
        """Copy the host batch into the path's static input, through its
        pinned staging buffer on the card."""
        static = path.inputs[0]
        if not self._cuda:
            static.copy_(torch.as_tensor(batch))
            return
        staging = self._staging[tuple(batch.shape)]
        staging.numpy()[...] = batch
        static.copy_(staging, non_blocking=True)

    def run(self, batch: np.ndarray) -> BatchOut:
        batch = np.asarray(batch)
        shape = tuple(batch.shape)
        with self._lock:
            self._after_caller()
            with self._on_stream():
                try:
                    path = self._paths.get(shape) or self._new_path(shape)
                    self._stage(path, batch)
                    return _host(self._run(path))
                except BaseException:
                    # nothing of this run may still be in flight when the
                    # next one rewrites the staging buffer
                    if self._cuda:
                        self._stream.synchronize()
                    raise


def _host(out) -> BatchOut:
    """One batched device->host copy for however many outputs there are."""
    if isinstance(out, tuple):
        return tuple(fetch_host(list(out)))
    return fetch_host([out])[0]


def _tensors(out):
    """A block's result as a tensor, or a tuple of them."""
    if isinstance(out, (list, tuple)):
        return tuple(o._data if isinstance(o, NDArray) else o for o in out)
    return out._data if isinstance(out, NDArray) else out


class BlockEngine(_GraphEngine):
    """Serve a live (initialized, materialized) Gluon block.

    The engine copies the block's parameters once to its device and runs
    the block's forward over that snapshot in predict mode (BatchNorm on
    its moving statistics), every output returned: frozen-weights
    deployment semantics, matching ``aot.export_model``. Call
    :meth:`refresh_params` after retraining: it copies the current values
    into the snapshot in place, so the captured graphs stay valid. The
    JAX package re-jits a plain ``Block`` there; here every block takes
    the one path.

    ``device``: where to serve (a ``Context``, ``torch.device`` or name);
    by default the current context, the card unless inside
    ``with mx.cpu():``.
    """

    kind = "block"
    _site = "serving.block_engine"

    def __init__(self, block, dtype="float32", device=None):
        super().__init__(_engine_device(device), dtype)
        self._block = block
        self._params = block.collect_params()
        with torch.no_grad():
            self._pvals = _param_snapshot(self._params, self._device)
        self._after_caller()

    def refresh_params(self):
        """Copy the block's current parameter values into the engine's
        snapshot, in place: the captured graphs are kept. The caller's
        stream waits for the copy, so it may change or free the block's
        parameters as soon as this returns."""
        with self._lock:
            self._after_caller()
            with self._on_stream(), torch.no_grad():
                for n, v in self._pvals.items():
                    v.copy_(self._params[n].data()._data)
            self._before_caller()

    def _forward(self, x):
        from .. import autograd

        with from_device(self._device), _bound(self._params, self._pvals), \
                autograd.pause(), torch.no_grad():
            return _tensors(self._block(NDArray(x)))


class StableHLOEngine(_GraphEngine):
    """Serve a loaded ``aot.export_model`` artifact: a ``torch.export``
    program (``model.pt2``, format ``mxnet_tpu_torch-aot-v1``), moved to
    the engine's device, one CUDA graph a bucket rung. A ``poly_batch``
    artifact serves every rung from one file; ``compile_count`` counts the
    rungs captured."""

    kind = "stablehlo"
    _site = "serving.stablehlo_engine"

    def __init__(self, out_dir: str, device=None):
        from .. import aot

        device = _engine_device(device)
        dtype = aot.read_manifest(out_dir).get("input_dtype", "float32")
        super().__init__(device, dtype)
        self._module = aot.module_on(out_dir, device)
        self._after_caller()

    def _forward(self, x):
        with torch.no_grad():
            return _tensors(self._module(x))
