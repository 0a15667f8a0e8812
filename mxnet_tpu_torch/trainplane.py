"""The training plane: one captured step behind gluon's Trainer loop (the
port of ``mxnet_tpu/trainplane.py``'s ``TrainPlane``, ``fit`` and knobs).

``plane = TrainPlane(net, loss_fn, trainer)``, then ``loss =
plane.step(data, label)`` replaces the eager loop body::

    with autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward()
    trainer.step(batch_size)

On the graph plane the whole step (forward, loss, backward and the fused
optimizer apply) is one ``torch.cuda.CUDAGraph`` a (batch shape, dtype),
over the Trainer's own parameters, its updater's states (float32 masters
included) and BatchNorm's moving statistics, all updated in place. The
update is ``fastpath.tree_kernel``, the fused apply's own kernel, and
the step consumes the same host prologue (``_update_count`` and
``_host_scalars`` per index, on the real optimizer), so the optimizer's
counters stay the one source of truth and eager and graph steps
interleave freely. The learning rates and counts (and the extras of
``_host_scalars``: Nadam's schedule) are 0-d device tensors (one
host-to-device copy a step, none while they stay the same), so one graph
serves every step. The backward is seeded with ones, as
``loss.backward()`` is. In float32 the graph plane gives the eager
fastpath's bits.

The first step of a shape runs the step once eagerly on a side stream
(cuDNN picks its algorithms there) with reads back to the host refused
(``ndarray.no_host_reads``), puts the state back, then captures, in
CUDA's relaxed mode as ``parallel.TrainStep`` does (see there). On the
CPU there is no graph: that first pass runs all the same, and the step
function then runs eagerly at every step.

Knobs (the JAX package's):

* ``MXNET_TRAINSTEP``: ``auto`` (default) or ``1`` take the graph plane
  where the model allows it, ``1`` warning when it does not; ``0`` runs
  the eager loop (the caller's choice: not counted as a demotion, as in
  the JAX package).
* ``MXNET_TRAIN_DTYPE=bf16`` casts the net to bfloat16 once, at
  activation, sets the optimizer's ``multi_precision`` (float32 masters
  and states) and casts every floating batch to bfloat16, on both planes.
* ``MXNET_SHARDED_FEED`` is read by :func:`sharded_feed`; with one device
  there is nothing to shard, and :func:`fit` feeds batches as they come.

The plane demotes to the eager loop only for the JAX package's reasons,
each counted in ``FALLBACKS{reason}`` (``telemetry.TRAINPLANE_FALLBACKS``)
and shown by :attr:`TrainPlane.plane`: ``MXNET_FASTPATH=0``, a plain
``Block``, a Trainer that updates on its kvstore, a kvstore with
gradient compression (the step would skip it; the JAX plane skips it),
an optimizer without a list kernel, a ``grad_req`` other than
``write``/``null``, a parameter the Trainer does not own, and a step that
cannot be captured (a forward that reads back to the host), decided once
at the capture. ``STEP_DISPATCHES{plane}`` counts the steps: a graph step
is one replay and no ``OPT_DISPATCHES``.

:func:`module_plane` does the same for a bound ``Module``
(``BaseModule.fit`` asks for it once and steps every batch through it):
the Symbol graph's forward in train mode, a backward seeded with ones
(``backward(out_grads=None)``), and ``fastpath.tree_kernel`` over the
executor's own weights, the updater's states and the auxiliary states
(BatchNorm's moving statistics), one CUDA graph a batch signature, built
and fed as above; the executor's outputs are copies of the graph's, so a
metric or a caller holding an earlier batch's outputs keeps them. It
declines (returns None) for ``MXNET_TRAINSTEP=0`` and for a ``Module``
subclass, uncounted, and demotes for the JAX package's reasons, each
counted in ``FALLBACKS`` under the JAX label: ``MXNET_FASTPATH=0``,
several contexts or
executors, a kvstore, an updater that is not ``Updater``, an optimizer
without a list kernel, ``state_names`` or ``inputs_need_grad``
(``"module-config"``), and ``"module-trace: <error>"`` for a ``grad_req``
other than ``write``/``null``, no trainable parameter, or a first pass
that fails: a custom op that reads back to the host (a numpy op) demotes
there. A CUDA graph replays device work only, so a custom op's Python
side effects that read nothing back (a counter, a draw from a host RNG)
run at the first pass and at the capture, and at no replay. The rtc kernels a capture records are
counted at every replay (``rtc.add_launches``).

Out of memory, as the JAX plane: a graph step that fails with a
classified OOM (the allocator's ``torch.OutOfMemoryError``, in the
capture or the replay, or chaos ``action=oom`` at the ``jit.compile``
site a graph step passes before it dispatches) goes through
``hbm.oom_survival`` — the structured diagnostic lands in a
flight-recorder dump and the governor latches red — then the plane
demotes to eager (reason ``"oom: <type>"``) and the step runs there.
Anything else propagates. With ``MXNET_DEVPROF_SAMPLE`` > 0 a graph
step is a devprof step scope: its replay is timed by a CUDA event pair
(site ``trainplane.step``) into ``mxnet_train_step_ms``.

Not ported yet (they raise): ``MXNET_ZERO``, a mesh of several devices
and ``fit``'s elastic checkpoints.
"""
from __future__ import annotations

import copy
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import autograd, fastpath, random as _random, rtc
from .base import MXNetError, get_env
from .fastpath.fused import _is_mp_state
from .gluon.block import HybridBlock
from .gluon.parameter import DeferredInitializationError
from .ndarray.ndarray import NDArray, no_host_reads
from .optimizer import Updater, ensure_mp_state
from .resilience import chaos
from .resilience import hbm as _hbm
from .telemetry import STEP_DISPATCHES, TRAINPLANE_FALLBACKS
from .telemetry import devprof as _devprof
from .telemetry import accounting as _accounting

__all__ = ["TrainPlane", "fit", "module_plane", "mode", "train_dtype",
           "sharded_feed", "FALLBACKS"]

_LOG = logging.getLogger(__name__)

#: why planes fell back to eager, by reason
FALLBACKS = TRAINPLANE_FALLBACKS


def mode() -> str:
    """``MXNET_TRAINSTEP``: ``auto`` | ``1`` | ``0`` (read at every call)."""
    raw = str(get_env("MXNET_TRAINSTEP", "auto", str, cache=False)).lower()
    return raw if raw in ("auto", "1", "0") else "auto"


def train_dtype() -> str:
    """``MXNET_TRAIN_DTYPE``: ``fp32`` (default) | ``bf16``."""
    raw = str(get_env("MXNET_TRAIN_DTYPE", "fp32", str, cache=False)).lower()
    return "bf16" if raw in ("bf16", "bfloat16") else "fp32"


def sharded_feed() -> bool:
    """``MXNET_SHARDED_FEED`` (default on)."""
    return bool(get_env("MXNET_SHARDED_FEED", 1, int, cache=False))


def _refuse_unported():
    if get_env("MXNET_ZERO", 0, int, cache=False):
        raise MXNetError("MXNET_ZERO (the sharded optimizer-state plane) "
                         "is not ported yet")


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [state]


class _Path(object):
    """One batch signature: static inputs, the step over them, and on the
    card its graph, the graph's outputs and the rtc launches it holds."""

    def __init__(self, inputs, fn, ptrs):
        self.inputs = inputs
        self.fn = fn
        self.ptrs = ptrs      # the addresses the graph baked in
        self.graph = None
        self.out = None
        self.launches = {}    # rtc kernel -> launches a replay


class _Ineligible(Exception):
    """The graph plane cannot serve this module."""


class _PlaneBase(object):
    """What the gluon and Module planes share (``mxnet_tpu/trainplane.py:
    118-170``): the optimizer's host prologue, the step's scalars as 0-d
    device tensors, and the first pass and capture of a path. A plane
    sets ``_rows`` (``[(optimizer index, ...)]``), ``_device`` and
    ``_held()`` (every tensor the step writes outside its batch)."""

    _site = "trainplane"

    def _init_scalars(self):
        self._stream = None
        self._alloc_scalars(2)
        self._captures = 0

    def _alloc_scalars(self, n_rows):
        """The step's scalars: ``n_rows`` float32 rows (learning rates,
        counts, then one a ``_host_scalars`` extra) of one value a
        parameter, and their 0-d views."""
        n = len(self._rows)
        self._scalars = torch.zeros((n_rows, n), dtype=torch.float32,
                                    device=self._device)
        self._lr_views = list(self._scalars[0])
        self._t_views = list(self._scalars[1])
        self._extra_views = [tuple(self._scalars[k][j]
                                   for k in range(2, n_rows))
                             for j in range(n)]
        self._last_scalars = None

    def _prologue(self, opt):
        """The eager fused apply's host prologue, in its order: per index
        ``_update_count`` then ``_host_scalars``; returns the rows ``[lrs,
        counts, extra 0, ...]`` of the step's scalars (the weight decays
        are the step's key, read by ``_get_wd`` as ``_host_scalars`` reads
        them; the extras are Nadam's schedule)."""
        lrs, ts, extras = [], [], []
        for i, _ in self._rows:
            opt._update_count(i)
            lr, _wd, ex = opt._host_scalars(i)
            lrs.append(lr)
            ts.append(opt._index_update_count[i])
            extras.append(tuple(ex))
        n_extra = len(extras[0]) if extras else 0
        return [lrs, ts] + [[float(e[k]) for e in extras]
                            for k in range(n_extra)]

    @staticmethod
    def _probe_optimizer(opt):
        """A throwaway copy for the first pass's prologue, which must not
        advance the real counters or schedule (``param_dict`` holds live
        Parameters: shared, only read)."""
        pd, opt.param_dict = opt.param_dict, {}
        try:
            probe = copy.deepcopy(opt)
        finally:
            opt.param_dict = pd
        probe.param_dict = pd
        return probe

    def _set_scalars(self, rows):
        if len(rows) != self._scalars.shape[0]:
            # the first prologue of an optimizer with extras, before any
            # capture has taken the views' addresses
            self._alloc_scalars(len(rows))
        if rows != self._last_scalars:
            self._scalars.copy_(torch.tensor(rows, dtype=torch.float32),
                                non_blocking=True)
            self._last_scalars = rows

    def _capture(self, path, probe_rows):
        """The first pass (eager, host reads refused) and, on the card,
        the capture; the state the pass moved (the held tensors and the
        device's generator) is put back. Returns None, or the exception
        that stopped the pass or the capture."""
        t0 = time.perf_counter()
        held = self._held()
        saved = [t.detach().clone() for t in held]
        gen = _random.generator(self._device)
        rng = gen.get_state()
        self._set_scalars(probe_rows)
        cuda = self._device.type == "cuda"
        try:
            if cuda:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self._device)
                self._stream.wait_stream(
                    torch.cuda.current_stream(self._device))
                with torch.cuda.stream(self._stream), \
                        no_host_reads(self._site):
                    path.fn()
                    self._restore(held, saved)
                torch.cuda.current_stream(self._device).wait_stream(
                    self._stream)
                gen.set_state(rng)
                graph = torch.cuda.CUDAGraph()
                before = rtc.launch_counts()
                with no_host_reads(self._site), torch.cuda.graph(
                        graph, stream=self._stream,
                        capture_error_mode="relaxed"):
                    out = path.fn()
                after = rtc.launch_counts()
                path.launches = {k: n - before.get(k, 0)
                                 for k, n in after.items()
                                 if n != before.get(k, 0)}
                # the capture launched nothing: the replays will
                rtc.add_launches(path.launches, -1)
                path.graph, path.out = graph, out
            else:
                with no_host_reads(self._site):
                    path.fn()
                self._restore(held, saved)
                gen.set_state(rng)
        except Exception as exc:  # noqa: BLE001 - the documented demotion
            if cuda:
                torch.cuda.synchronize(self._device)
            self._restore(held, saved)
            gen.set_state(rng)
            return exc
        self._captures += 1
        _accounting.note_recompile(self._site, 1, time.perf_counter() - t0)
        return None

    @staticmethod
    def _restore(held, saved):
        with torch.no_grad():
            for t, s in zip(held, saved):
                t.copy_(s)

    def _ptrs(self):
        return tuple(t.data_ptr() for t in self._held())

    @staticmethod
    def _replay(path):
        path.graph.replay()
        rtc.add_launches(path.launches)


class TrainPlane(_PlaneBase):
    """One training step through whichever plane the model supports (see
    the module's docstring). The Trainer stays the owner of the optimizer
    and its states (``trainer._updater.states``).

    Parameters
    ----------
    net : Block (a HybridBlock for the graph plane)
    loss_fn : gluon Loss (or ``(out, label) -> loss`` NDArray)
    trainer : gluon.Trainer over the net's parameters
    mesh : ``parallel.device_mesh`` of one device, or None
    batch_axis : 0 (other axes are not ported yet)
    """

    _site = "trainplane.TrainPlane"

    def __init__(self, net, loss_fn, trainer, mesh=None, batch_axis=0):
        if batch_axis != 0:
            raise MXNetError("batch_axis %d is not ported yet (0 only)"
                             % batch_axis)
        if mesh is not None and len(mesh.devices) != 1:
            raise MXNetError("a mesh of several devices is not ported yet")
        self._net = net
        self._loss = loss_fn
        self._trainer = trainer
        self._mesh = mesh
        self._plane: Optional[str] = None  # 'graph' | 'eager'
        self._why_eager: Optional[str] = None
        self._cast = None                  # torch.bfloat16 under bf16 mode
        self._rows = None                  # [(trainer index, Parameter)]
        self._params = None                # the net's Parameters
        self._paths: Dict[Any, _Path] = {}
        self._device = None
        self._captures = 0
        self.step_count = 0

    # -- plane selection -----------------------------------------------
    @property
    def plane(self) -> str:
        return self._plane or "undecided"

    @property
    def compile_count(self) -> int:
        """Steps captured (on the CPU: batch signatures run) so far."""
        return self._captures

    @property
    def mesh(self):
        return self._mesh

    def _demote(self, reason: str):
        FALLBACKS.inc(reason=reason)
        self._plane = "eager"
        self._why_eager = reason
        if mode() == "1":
            _LOG.warning(
                "MXNET_TRAINSTEP=1 but the graph plane is unavailable "
                "(%s); training continues on the eager path", reason)

    def _ineligible_reason(self) -> Optional[str]:
        tr = self._trainer
        if not fastpath.enabled():
            return "MXNET_FASTPATH=0 (legacy escape hatch)"
        if not isinstance(self._net, HybridBlock):
            return "net is not a HybridBlock"
        if not tr._kv_initialized:
            tr._init_kvstore()
        if tr._update_on_kvstore:
            return "update_on_kvstore"
        if tr._kvstore is not None and tr._kvstore._compression is not None:
            # the step would skip the store and so its compression
            return "gradient compression"
        if not getattr(tr._optimizer, "fastpath_capable", False):
            return "optimizer has no list kernel"
        owned = {p.name for p in tr._params}
        for name, p in self._net.collect_params().items():
            if p.grad_req not in ("null", "write"):
                return "grad_req %r on %s" % (p.grad_req, name)
            if p.grad_req != "null" and name not in owned:
                return "net parameter %s not owned by the trainer" % name
        return None

    def _materialize(self, data_nd):
        """Finish deferred initialization so every parameter has a value."""
        try:
            for p in self._net.collect_params().values():
                p.data()
        except DeferredInitializationError:
            with autograd.pause():
                self._net(data_nd)

    def _activate(self, data_nd):
        # the dtype knob applies on both planes
        if train_dtype() == "bf16":
            self._cast = torch.bfloat16
            self._materialize(data_nd)
            params = list(self._net.collect_params().values())
            if params and params[0].data()._data.dtype != torch.bfloat16:
                self._net.cast("bfloat16")
            self._trainer._optimizer.multi_precision = True
        if mode() == "0":
            self._plane = "eager"
            self._why_eager = "MXNET_TRAINSTEP=0"
            return
        reason = self._ineligible_reason()
        if reason is not None:
            self._demote(reason)
            return
        self._materialize(data_nd)
        self._rows = [(i, p) for i, p in enumerate(self._trainer._params)
                      if p.grad_req != "null"]
        if not self._rows:
            self._demote("no trainable parameters")
            return
        self._params = list(self._net.collect_params().values())
        self._device = self._rows[0][1].data()._data.device
        self._init_scalars()  # (2, rows) float32 lrs and counts, 0-d views
        self._plane = "graph"

    # -- graph plane ----------------------------------------------------
    def _ensure_states(self):
        """States made exactly as the eager Updater makes them (the same
        layout, the same master pairs), so either plane adopts them."""
        opt = self._trainer._optimizer
        states = self._trainer._updater.states
        for i, p in self._rows:
            w = p.data()
            if i not in states:
                states[i] = opt.create_state_multi_precision(i, w)
            else:
                states[i] = ensure_mp_state(opt, i, w, states[i])

    def _held(self, states=None):
        """Every tensor the step reads or writes outside its batch: the
        net's parameters (moving statistics included) and the states."""
        if states is None:
            states = self._trainer._updater.states
        out = [p.data()._data for p in self._params]
        for i, _ in self._rows:
            out += _leaves(states.get(i))
        return out

    def _step_fn(self, data, label, mp_flags, wds):
        """The whole step on the static batch: forward, per-sample loss,
        backward seeded with ones, and the fused update in place."""
        opt = self._trainer._optimizer
        states = self._trainer._updater.states
        ws = [p.data()._data for _, p in self._rows]
        if self._cast is not None and data.is_floating_point():
            data = data.to(self._cast)
        with autograd.record():
            out = self._net(NDArray(data))
            if isinstance(out, (tuple, list)):
                out = out[0]
            loss = self._loss(out, NDArray(label))._data
        grads = torch.autograd.grad(loss, ws, torch.ones_like(loss),
                                    allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(ws, grads)]
        fastpath.tree_kernel(
            opt, ws, grads, [states[i] for i, _ in self._rows], mp_flags,
            self._t_views, self._lr_views, wds, self._extra_views)
        return loss.detach()

    def _new_path(self, data, label, wds):
        """States, static inputs and the step for a new batch signature,
        first-passed and captured; None (the plane demoted) when the step
        cannot be captured."""
        opt = self._trainer._optimizer
        self._ensure_states()
        states = self._trainer._updater.states
        mp_flags = tuple(_is_mp_state(opt, i, p.data(), states[i])
                         for i, p in self._rows)
        d = torch.empty(data.shape, dtype=data.dtype, device=self._device)
        lab = torch.empty(label.shape, dtype=label.dtype, device=self._device)
        d.copy_(data)
        lab.copy_(label)
        path = _Path((d, lab), lambda: self._step_fn(d, lab, mp_flags, wds),
                     self._ptrs())
        probe_rows = self._prologue(self._probe_optimizer(opt))
        exc = self._capture(path, probe_rows)
        if exc is not None:
            if _hbm.classify(exc) is not None:
                raise exc  # the step's OOM survival (_graph_step_guarded)
            self._demote("capture: %s" % type(exc).__name__)
            return None
        return path

    def _graph_step_guarded(self, data_nd, label_nd, batch_size):
        """Never-a-crash at the graph plane's own dispatch: a step
        failure that classifies as OOM first lands the structured HBM
        diagnostic — per-plane registered bounds, watermark history, the
        allocator's counters — in a flight-recorder dump
        (``hbm.oom_survival``), then demotes to the eager plane; the
        caller runs the step there. Anything non-OOM still propagates —
        a programming error must fail fast, not hide behind a fallback.
        Returns None after a demotion."""
        try:
            return self._graph_step(data_nd, label_nd, batch_size)
        except Exception as exc:  # noqa: BLE001 - OOM-only survival
            if not _hbm.oom_survival("trainplane.step", exc, dump=True):
                raise
            self._demote("oom: %s" % type(exc).__name__)
            return None

    def _graph_step(self, data_nd, label_nd, batch_size):
        if chaos.ENABLED:
            # the JAX step's jit_call site: a fault here is raised before
            # anything dispatches
            chaos.maybe_fail("jit.compile")
        tr = self._trainer
        opt = tr._optimizer
        opt.rescale_grad = tr._scale / batch_size  # Trainer.step parity
        data, label = data_nd._data, label_nd._data
        wds = tuple(opt._get_wd(i) for i, _ in self._rows)
        key = (tuple(data.shape), data.dtype, tuple(label.shape),
               label.dtype, opt.rescale_grad, opt.clip_gradient, wds)
        path = self._paths.get(key)
        if path is not None and path.ptrs != self._ptrs():
            # a parameter or state was rebound since the capture (a cast,
            # a state restored into another layout): the graph's
            # addresses are stale
            self._paths.clear()
            path = None
        if path is None:
            path = self._new_path(data, label, wds)
            if path is None:
                return None
            self._paths[key] = path
        d, lab = path.inputs
        d.copy_(data)
        lab.copy_(label)
        rows = self._prologue(opt)
        self._set_scalars(rows)
        hook = _accounting._DEVPROF_HOOK
        probe = hook("trainplane.step", self._device) \
            if hook is not None else None
        if path.graph is not None:
            self._replay(path)
            loss = path.out.clone()
        else:
            loss = path.fn()
        if probe is not None:
            probe.stop()
        STEP_DISPATCHES.inc(plane="graph")
        return NDArray(loss)

    # -- eager plane ----------------------------------------------------
    def _eager_step(self, data_nd, label_nd, batch_size):
        if self._cast is not None and data_nd._data.is_floating_point():
            data_nd = NDArray(data_nd._data.to(self._cast))
        with autograd.record():
            out = self._net(data_nd)
            loss = self._loss(out, label_nd)
        loss.backward()
        self._trainer.step(batch_size)
        STEP_DISPATCHES.inc(plane="eager")
        return loss

    # -- entry ----------------------------------------------------------
    def step(self, data, label, batch_size=None):
        """Run one training step; returns the per-sample loss NDArray."""
        _refuse_unported()
        device = self._trainer._contexts[0].torch_device()
        data_nd, label_nd = (x if isinstance(x, NDArray) else NDArray(
            torch.as_tensor(np.asarray(x)).to(device)) for x in (data, label))
        if batch_size is None:
            batch_size = int(data_nd.shape[0])
        if self._plane is None:
            self._activate(data_nd)
        self.step_count += 1
        if self._plane == "graph":
            # devprof step scope: one coherent sampling decision for the
            # whole step so its device/host_gap split is honest (one
            # global read when devprof is off)
            if _devprof.tick_begin():
                t0 = time.perf_counter()
                try:
                    loss = self._graph_step_guarded(data_nd, label_nd,
                                                    batch_size)
                finally:
                    _devprof.note_train_step(
                        (time.perf_counter() - t0) * 1e3)
            else:
                loss = self._graph_step_guarded(data_nd, label_nd,
                                                batch_size)
            if loss is not None:
                return loss
        return self._eager_step(data_nd, label_nd, batch_size)


def fit(net, loss_fn, trainer, train_data, epochs=1, batch_axis=0,
        mesh=None, batch_end_callback=None, checkpoint=None,
        checkpoint_every=1, resume=True):
    """Train ``net`` over ``train_data`` through the plane; returns the
    :class:`TrainPlane` (``plane.plane`` says which ran).

    ``train_data`` yields ``io.DataBatch``es (any ``DataIter``, reset
    before every epoch but the first) or ``(data, label)`` pairs.
    ``batch_end_callback(epoch, nbatch, loss)`` runs after each step.
    ``checkpoint`` (the JAX package's elastic checkpoints) is not ported
    yet."""
    from . import io as io_mod

    if checkpoint is not None:
        raise MXNetError("fit(checkpoint=...) (elastic checkpoints) is not "
                         "ported yet")
    plane = TrainPlane(net, loss_fn, trainer, mesh=mesh,
                       batch_axis=batch_axis)
    for epoch in range(epochs):
        if epoch and hasattr(train_data, "reset"):
            train_data.reset()
        for nbatch, batch in enumerate(train_data, 1):
            if isinstance(batch, io_mod.DataBatch):
                data, label = batch.data[0], batch.label[0]
            else:
                data, label = batch
            loss = plane.step(data, label)
            if batch_end_callback is not None:
                batch_end_callback(epoch, nbatch, loss)
    return plane


# ---------------------------------------------------------------------------
# Module plane (Module.fit)
# ---------------------------------------------------------------------------


class _ModulePlane(_PlaneBase):
    """The whole training step of a bound one-context ``Module`` (the port
    of ``mxnet_tpu/trainplane.py:838-1013``): the executor's train-mode
    forward (BatchNorm's moving statistics written in place), the
    all-ones-seeded backward and ``fastpath.tree_kernel`` over the
    executor's own weights and the updater's states, one CUDA graph a
    batch signature. The first pass of the bound signature runs here, as
    the JAX plane traces its step at construction; a failure raises and
    :func:`module_plane` demotes."""

    _site = "trainplane.module_plane"

    def __init__(self, module):
        self._m = module
        self._exec = exec_ = module._exec_group.execs[0]
        names = [n for n in module._symbol.list_arguments()
                 if n in module._param_names]
        self._rows = []
        for idx, name in enumerate(names):
            req = exec_.grad_req.get(name, "null")
            if name in exec_.grad_dict and req == "write":
                self._rows.append((idx, name))
            elif req not in ("null", "write"):
                # 'add' accumulates across calls, which the step cannot
                # honour; the eager path would keep training the parameter
                raise _Ineligible("grad_req %r on %s" % (req, name))
        if not self._rows:
            raise _Ineligible("no trainable parameters")
        group = module._exec_group
        self._inputs = list(group.data_names) + list(group.label_names)
        self._device = exec_.arg_dict[self._rows[0][1]]._data.device
        self._paths: Dict[Any, _Path] = {}
        self._init_scalars()
        # the first pass (and on the card the capture) of the bound shapes
        path, exc = self._path([exec_.arg_dict[n]._data
                                for n in self._inputs])
        if exc is not None:
            raise exc

    @property
    def compile_count(self) -> int:
        """Steps captured (on the CPU: batch signatures run) so far."""
        return self._captures

    def _ensure_states(self):
        """States made as ``fastpath.apply_updater`` makes them, so the
        eager ``Module.update`` adopts them and the other way round."""
        opt = self._m._optimizer
        states = self._m._updater.states
        for i, name in self._rows:
            w = self._exec.arg_dict[name]
            if i not in states:
                states[i] = opt.create_state_multi_precision(i, w)
            else:
                states[i] = ensure_mp_state(opt, i, w, states[i])

    def _held(self):
        """Every tensor the step writes outside its batch: the weights,
        the auxiliary states and the optimizer states."""
        exec_ = self._exec
        states = self._m._updater.states
        out = [exec_.arg_dict[n]._data for _, n in self._rows]
        out += [a._data for a in exec_.aux_dict.values()]
        for i, _ in self._rows:
            out += _leaves(states.get(i))
        return out

    def _step_fn(self, inputs, mp_flags, wds):
        """The whole step on the static batch; returns the outputs."""
        exec_ = self._exec
        opt = self._m._optimizer
        states = self._m._updater.states
        values = {n: a._data for n, a in exec_.arg_dict.items()}
        values.update(zip(self._inputs, inputs))
        values.update((n, a._data) for n, a in exec_.aux_dict.items())
        diff = [n for _, n in self._rows]
        ws = [values[n] for n in diff]
        outs, leaves = exec_._train_forward(values, diff)
        # backward(out_grads=None) parity: all-ones head gradients
        grads = exec_._head_grads(outs, leaves,
                                  [torch.ones_like(o) for o in outs])
        fastpath.tree_kernel(
            opt, ws, grads, [states[i] for i, _ in self._rows], mp_flags,
            self._t_views, self._lr_views, wds, self._extra_views)
        return [o.detach() for o in outs]

    def _path(self, batch):
        """The path of this batch signature (made, first-passed and
        captured if new); ``(path, None)``, or ``(None, exception)`` when
        the step cannot run without the host or cannot be captured."""
        opt = self._m._optimizer
        wds = tuple(opt._get_wd(i) for i, _ in self._rows)
        self._ensure_states()
        states = self._m._updater.states
        mp_flags = tuple(
            _is_mp_state(opt, i, self._exec.arg_dict[n], states[i])
            for i, n in self._rows)
        key = (tuple((tuple(t.shape), t.dtype) for t in batch),
               opt.rescale_grad, opt.clip_gradient, wds, mp_flags)
        path = self._paths.get(key)
        if path is not None and path.ptrs != self._ptrs():
            # a weight or state was rebound since the capture (a value
            # of another shape or dtype given to set_params, a cast)
            self._paths.clear()
            path = None
        if path is not None:
            return path, None
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=self._device)
                  for t in batch]
        for dst, src in zip(inputs, batch):
            dst.copy_(src)
        path = _Path(inputs, lambda: self._step_fn(inputs, mp_flags, wds),
                     self._ptrs())
        exc = self._capture(path, self._prologue(self._probe_optimizer(opt)))
        if exc is not None:
            return None, exc
        self._paths[key] = path
        return path, None

    def step(self, batch):
        """One training step on a ``DataBatch``; fills the executor's
        outputs (copies: the graph's own are written again by its next
        replay) so ``update_metric`` reads them as usual."""
        m, exec_ = self._m, self._exec
        tensors = list(batch.data)
        if self._m._exec_group.label_names and batch.label:
            tensors += list(batch.label)
        tensors = [t._data for t in tensors]
        path, exc = self._path(tensors)
        if exc is not None:
            raise MXNetError("module_plane: a new batch signature cannot be "
                             "captured: %s: %s" % (type(exc).__name__, exc))
        for dst, src in zip(path.inputs, tensors):
            dst.copy_(src)
        self._set_scalars(self._prologue(m._optimizer))
        if path.graph is not None:
            self._replay(path)
            outs = [o.clone() for o in path.out]
        else:
            outs = path.fn()
        exec_.outputs = [NDArray(o) for o in outs]
        exec_._heads = None
        m._params_dirty = True
        STEP_DISPATCHES.inc(plane="graph")
        return exec_.outputs


def module_plane(module):
    """The whole-step graph plane of a bound ``Module`` whose optimizer is
    initialized, or None where the eager executor path must run (see the
    module's docstring for the reasons and their labels).
    ``BaseModule.fit`` calls this once a fit and falls back silently:
    routing never breaks training."""
    if mode() == "0":
        return None
    from .module.module import Module

    if type(module) is not Module:
        return None
    try:
        group = module._exec_group
        if not fastpath.enabled() \
                or len(module._context) != 1 \
                or getattr(module, "_kvstore", None) is not None \
                or getattr(module, "_update_on_kvstore", False) \
                or not isinstance(module._updater, Updater) \
                or not getattr(module._optimizer, "fastpath_capable", False) \
                or group is None or len(group.execs) != 1 \
                or getattr(group, "state_names", None) \
                or module.inputs_need_grad:
            FALLBACKS.inc(reason="module-config")
            return None
        return _ModulePlane(module)
    except Exception as exc:  # noqa: BLE001 - the fallback contract
        FALLBACKS.inc(reason="module-trace: %s" % type(exc).__name__)
        if mode() == "1":
            _LOG.warning(
                "MXNET_TRAINSTEP=1 but Module.fit cannot use the graph "
                "plane (%s: %s); the eager executor path runs instead",
                type(exc).__name__, exc, exc_info=exc)
        return None
