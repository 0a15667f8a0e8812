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
without a list kernel, ``state_names``, ``inputs_need_grad`` or a
``group2ctx`` group on another device (``"module-config"``; the JAX
plane places such a group inside its program, a CUDA graph holds no
host work), and ``"module-trace: <error>"`` for a ``grad_req``
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

Across the ranks of a job the gluon plane is the JAX plane's SPMD step
(``mxnet_tpu/trainplane.py:44-47``, ``:228-230``): the plane's mesh
(:func:`_default_mesh` unless given) holds every rank, each rank passes
the same global batch and steps on its block along ``batch_axis``, and
the step function runs inside the job's span (``parallel``'s docstring):
BatchNorm takes the global batch's statistics, each rank's gradients,
scaled by its own rows, are averaged over the ranks in one flat buffer a
dtype, and ``step`` returns the whole batch's per-sample losses,
all-gathered in rank order inside the step (a batch the ranks cannot
split runs whole on every rank, its losses the rank's own). Under NCCL
that is one CUDA graph a batch signature, collectives included; under
gloo the same step runs uncaptured (``uncaptured_reason == "gloo"``,
counted in ``parallel.UNCAPTURED_STEPS``, ``compile_count`` 0).
``collectives_a_step`` counts a step's collectives. The ranks' weights
stay bit-equal: the update runs on replicated weights and states. In a
job the plane never demotes: the eager step would train the whole
global batch on every rank. A configuration the plane cannot step
(``MXNET_TRAINSTEP=0`` among the reasons above) raises ``MXNetError``
naming it, and a failed first pass, capture or OOM raises as it came.

``MXNET_ZERO`` (``fastpath.zero``), read at every step as the JAX
plane's ``_zero_acquire`` (``mxnet_tpu/trainplane.py:456-560``): on a
plane across ranks at level 1 or 2 the step acquires the updater's
``ZeroPlane`` over the job's group and runs the sharded step inside the
step function (``ZeroPlane.traced_update``): the packed gradients
reduce-scattered over the ranks (one collective a bucket: NCCL's
average inside the graph; under gloo the staged sum, then the division),
the fused kernel on this rank's shard only, then one all-gather a bucket
of the updated weights. The states stay sharded between steps, each rank
holding its ``1/N`` of every bucket; ``collectives_a_step`` counts the
new collectives. On one rank sharding is a no-op, so each step declines
with the JAX package's "1-device mesh (sharding is a no-op)" reason,
counted in ``mxnet_zero_fallbacks_total``, and runs replicated, as the
JAX plane does on a 1-device mesh; so do an optimizer the gate declines
and an acquire that fails (``"adopt: <error>"``), the states
materialized first. A step that fails after its kernel ran raises.
:func:`fit` takes ``checkpoint=`` (an ``elastic.CheckpointManager``): it
resumes from the last committed epoch, calls ``elastic.step_boundary``
before every batch and saves every ``checkpoint_every`` epochs; across
ranks every rank writes its own files of the replicated states
(``elastic``'s shard file a rank), and the plane's mesh is decided at
the first batch.
``TrainPlane.feed_sharding`` gives the sharding batches should arrive in
(``parallel.batch_sharding`` over the plane's mesh at ``batch_axis``).

The module plane trains each rank's module on its own device with no
collective, as the JAX module plane (a one-device step,
``mxnet_tpu/trainplane.py:1016-1051``) does in a job; a module with a
kvstore takes the eager path through the store, as on one process.
"""
from __future__ import annotations

import copy
import gc
import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import _dist, autograd, fastpath, parallel, random as _random, rtc
from .base import MXNetError, get_env
from .fastpath import zero
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


def _default_mesh(batch_size: int):
    """The mesh over the job's ranks (``mxnet_tpu/trainplane.py:
    101-111``), shrunk to the largest count that divides the batch; one
    process drives one device, so a shrunk mesh that would leave ranks
    out raises instead."""
    world = _dist.world_size()
    n = world
    while n > 1 and batch_size % n:
        n -= 1
    if n < world:
        raise MXNetError(
            "TrainPlane: a batch of %d rows splits over %d of the job's %d "
            "ranks; a mesh that leaves ranks out is not ported (one process "
            "drives one device, and no process group spans a subset of the "
            "ranks): make the batch a multiple of %d"
            % (batch_size, n, world, world))
    return parallel.device_mesh()


class _Ineligible(Exception):
    """The graph plane cannot serve this module."""


class _PlaneBase(object):
    """What the gluon and Module planes share (``mxnet_tpu/trainplane.py:
    118-170``): the optimizer's host prologue, the step's scalars as 0-d
    device tensors, and the first pass and capture of a path. A plane
    sets ``_rows`` (``[(optimizer index, ...)]``), ``_device`` and
    ``_held()`` (every tensor the step writes outside its batch)."""

    _site = "trainplane"

    _span = None
    uncaptured_reason = None
    _replays = 0

    @property
    def graph_replays(self) -> int:
        """Steps run as a replay of a captured graph."""
        return self._replays

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
        cuda = self._device.type == "cuda" and self.uncaptured_reason is None
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
                # no garbage collection inside the capture (as the decode
                # engine's)
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with no_host_reads(self._site), torch.cuda.graph(
                            graph, stream=self._stream,
                            capture_error_mode="relaxed"):
                        out = path.fn()
                finally:
                    if collecting:
                        gc.enable()
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
        if self.uncaptured_reason is None:
            self._captures += 1
            _accounting.note_recompile(self._site, 1,
                                       time.perf_counter() - t0)
        return None

    @staticmethod
    def _restore(held, saved):
        with torch.no_grad():
            for t, s in zip(held, saved):
                t.copy_(s)

    def _ptrs(self):
        return tuple(t.data_ptr() for t in self._held())

    def _replay(self, path):
        path.graph.replay()
        self._replays += 1
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
    mesh : ``parallel.device_mesh()`` (one device, or in a job every
        rank), or None for :func:`_default_mesh` at the first step
    batch_axis : the axis of data and label that the ranks split
    """

    _site = "trainplane.TrainPlane"

    def __init__(self, net, loss_fn, trainer, mesh=None, batch_axis=0):
        if mesh is not None:
            if _dist.group() is None and len(mesh.devices) != 1:
                raise MXNetError("a mesh of several devices in one process "
                                 "is not ported: a process drives one "
                                 "device")
            parallel.job_span(mesh, "TrainPlane")  # every rank, or raise
        self._net = net
        self._loss = loss_fn
        self._trainer = trainer
        self._mesh = mesh
        self._batch_axis = int(batch_axis)
        self._grad_bufs = None
        self._collectives = 0
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

    @property
    def collectives_a_step(self) -> int:
        """Collectives the last path's step function issued in one run
        (0 outside a job)."""
        return self._collectives

    def feed_sharding(self, ndim: int):
        """The sharding batches should arrive in (pre-sharded feed); None
        without a mesh."""
        if self._mesh is None:
            return None
        return parallel.batch_sharding(self._mesh, ndim, self._batch_axis)

    def _refuse_eager(self, reason: str):
        """In a job the eager step would train the whole global batch on
        every rank (per-rank BatchNorm statistics, every rank's gradient
        of the whole batch summed by a dist_sync store): the plane raises
        instead of demoting."""
        if self._span is not None:
            raise MXNetError(
                "TrainPlane across the ranks of a job has no eager "
                "fallback: %s" % reason)

    def _demote(self, reason: str):
        self._refuse_eager(reason)
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
        if self._mesh is None and _dist.group() is not None:
            self._mesh = _default_mesh(
                parallel.global_rows(data_nd._data, self._batch_axis))
        if self._mesh is not None:
            self._span = parallel.job_span(self._mesh, "TrainPlane")
        if mode() == "0":
            self._refuse_eager("MXNET_TRAINSTEP=0")
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
        if self._span is not None and self._span.backend == "gloo":
            self.uncaptured_reason = "gloo"
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

    def _held(self):
        """Every tensor the step reads or writes outside its batch: the
        net's parameters (moving statistics included) and the states (a
        sharded plane's: this rank's shards)."""
        updater = self._trainer._updater
        out = [p.data()._data for p in self._params]
        for i, _ in self._rows:
            st = updater.states.get(i)
            if not zero.is_sharded(st):
                out += _leaves(st)
        zp = zero.plane_of(updater)
        if zp is not None and zp.buckets is not None:
            out += [t for slots in zp.buckets for t in slots]
        return out

    def _step_fn(self, data, label, mp_flags, wds, split, zp=None,
                 bufs=None):
        """The whole step on the static batch: forward, per-sample loss,
        backward seeded with ones, and the fused update in place. In a job
        the gradients are averaged over the ranks and, where the ranks
        split the batch, the losses gathered in rank order; with a
        sharded plane ``zp`` the update is its ``traced_update`` over
        ``bufs``."""
        opt = self._trainer._optimizer
        states = self._trainer._updater.states
        span = self._span
        ws = [p.data()._data for _, p in self._rows]
        if self._cast is not None and data.is_floating_point():
            data = data.to(self._cast)
        before = span.collectives if span is not None else 0
        with _dist.spanning(span):
            with autograd.record():
                out = self._net(NDArray(data))
                if isinstance(out, (tuple, list)):
                    out = out[0]
                loss = self._loss(out, NDArray(label))._data
            grads = torch.autograd.grad(loss, ws, torch.ones_like(loss),
                                        allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(ws, grads)]
        loss = loss.detach()
        if span is not None:
            if zp is None:
                grads = self._grad_bufs.average(span, grads)
            if split:
                rows = data.shape[self._batch_axis]
                loss = parallel.gather_ranks(span, loss, parallel.gather_axis(
                    loss.shape, rows, self._batch_axis))
        if zp is not None:
            zp.traced_update(opt, span, ws, grads, bufs, self._t_views,
                             self._lr_views, wds)
        else:
            fastpath.tree_kernel(
                opt, ws, grads, [states[i] for i, _ in self._rows],
                mp_flags, self._t_views, self._lr_views, wds,
                self._extra_views)
        if span is not None:
            self._collectives = span.collectives - before
        return loss

    def _new_path(self, data, label, wds, split, zp):
        """States, static inputs and the step for a new batch signature,
        first-passed and captured; None (the plane demoted) when the step
        cannot be captured. With a sharded plane ``zp`` the step updates
        through it, over gradient buffers of its own."""
        opt = self._trainer._optimizer
        mp_flags = bufs = None
        if zp is not None:
            bufs = zp.step_buffers()
        else:
            self._ensure_states()
            states = self._trainer._updater.states
            mp_flags = tuple(_is_mp_state(opt, i, p.data(), states[i])
                             for i, p in self._rows)
        if self._span is not None and zp is None:
            ws = [p.data()._data for _, p in self._rows]
            if self._grad_bufs is None or self._grad_bufs.sig != tuple(
                    (tuple(w.shape), w.dtype) for w in ws):
                self._grad_bufs = parallel.GradBuffers(ws, self._device)
        d = torch.empty(data.shape, dtype=data.dtype, device=self._device)
        lab = torch.empty(label.shape, dtype=label.dtype, device=self._device)
        d.copy_(data)
        lab.copy_(label)
        path = _Path((d, lab),
                     lambda: self._step_fn(d, lab, mp_flags, wds, split,
                                           zp, bufs),
                     self._ptrs())
        probe_rows = self._prologue(self._probe_optimizer(opt))
        exc = self._capture(path, probe_rows)
        if exc is not None:
            if _hbm.classify(exc) is not None or self._span is not None:
                # the step's OOM survival (_graph_step_guarded); in a job
                # a failed first pass or capture raises
                raise exc
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
        Returns None after a demotion. In a job the OOM raises after its
        diagnostic: the rank's peers wait in the step's collectives."""
        try:
            return self._graph_step(data_nd, label_nd, batch_size)
        except Exception as exc:  # noqa: BLE001 - OOM-only survival
            if not _hbm.oom_survival("trainplane.step", exc, dump=True) \
                    or self._span is not None:
                raise
            self._demote("oom: %s" % type(exc).__name__)
            return None

    def _zero_acquire(self, opt):
        """The updater's ``ZeroPlane`` for this step, or None for the
        replicated layout (``mxnet_tpu/trainplane.py:456-482``), decided
        at every step so a flipped ``MXNET_ZERO`` takes effect (and
        materializes) at once. Every decline is counted in
        ``mxnet_zero_fallbacks_total``: one rank ("1-device mesh"), what
        the gate refuses, an acquire that fails."""
        updater = self._trainer._updater
        level = zero.level()
        if not level:
            zero.materialize_updater(updater)
            return None
        world = zero._ndev() if self._span is not None else 1
        reason = zero.eligible_reason(opt, world)
        if reason is not None:
            zero.note_fallback(reason)
            zero.materialize_updater(updater)
            return None
        ws = [p.data()._data for _, p in self._rows]
        try:
            return zero.acquire_plane(updater, opt, self._span.group, level,
                                      [i for i, _ in self._rows], ws)
        except zero.ZeroCollectiveError:
            raise
        except Exception as exc:  # noqa: BLE001 - as the JAX plane: a
            # layout that cannot be built runs replicated, counted
            zero.note_fallback("adopt: %s" % type(exc).__name__)
            zero.materialize_updater(updater)
            return None

    def _graph_step(self, data_nd, label_nd, batch_size):
        if chaos.ENABLED:
            # the JAX step's jit_call site: a fault here is raised before
            # anything dispatches
            chaos.maybe_fail("jit.compile")
        tr = self._trainer
        opt = tr._optimizer
        zp = self._zero_acquire(opt)
        data, label = data_nd._data, label_nd._data
        split = True
        if self._span is not None:
            data, split = parallel.rank_block(data, self._mesh,
                                              self._batch_axis)
            label, _ = parallel.rank_block(label, self._mesh,
                                           self._batch_axis)
        # Trainer.step parity; across ranks each rank scales by its own
        # rows and the step averages the ranks' gradients
        ranks = self._span.world if self._span is not None and split else 1
        opt.rescale_grad = tr._scale * ranks / batch_size
        wds = tuple(opt._get_wd(i) for i, _ in self._rows)
        key = (tuple(data.shape), data.dtype, tuple(label.shape),
               label.dtype, opt.rescale_grad, opt.clip_gradient, wds, split,
               zp.sig if zp is not None else None)
        path = self._paths.get(key)
        if path is not None and path.ptrs != self._ptrs():
            # a parameter or state was rebound since the capture (a cast,
            # a state restored into another layout): the graph's
            # addresses are stale
            self._paths.clear()
            path = None
        if path is None:
            path = self._new_path(data, label, wds, split, zp)
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
            if self.uncaptured_reason is not None:
                parallel.UNCAPTURED_STEPS.inc(site=self._site,
                                              reason=self.uncaptured_reason)
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
        device = self._trainer._contexts[0].torch_device()
        data_nd, label_nd = (x if isinstance(x, NDArray) else NDArray(
            torch.as_tensor(np.asarray(x)).to(device)) for x in (data, label))
        if batch_size is None:
            batch_size = parallel.global_rows(data_nd._data, self._batch_axis)
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

    ``checkpoint`` (an ``elastic.CheckpointManager``) makes the loop
    preemption-aware (``mxnet_tpu/trainplane.py:740-810``): with
    ``resume`` it restores the net, the trainer, the iterator's cursor and
    the RNG streams from the newest committed epoch (a mid-epoch
    preemption save resumes mid-epoch, replaying nothing); it calls
    ``elastic.step_boundary`` before every batch (the stall heartbeat, the
    kill-at-step chaos site, the preemption checkpoint-now); and it saves
    asynchronously every ``checkpoint_every`` epochs and after the last.
    The restore writes into the parameters and states in place, so the
    plane's captured steps stay valid. Wrap the call in
    ``elastic.run_elastic`` for supervised restarts."""
    from . import io as io_mod

    plane = TrainPlane(net, loss_fn, trainer, mesh=mesh,
                       batch_axis=batch_axis)
    feed = train_data
    start, mid = 0, False
    if checkpoint is not None and resume:
        restored = checkpoint.restore_training(net=net, trainer=trainer,
                                               train_iter=feed)
        if restored >= 0:
            extra = checkpoint.last_restored_extra or {}
            mid = bool(extra.get("mid_epoch"))
            start = restored if mid else restored + 1
    first_pass = True
    for epoch in range(start, epochs):
        # reset before every epoch but the first pass over a fresh
        # iterator, or one whose restored cursor is mid-epoch
        if hasattr(feed, "reset") and (not first_pass
                                       or (epoch and not mid)):
            feed.reset()
        first_pass = False
        nbatch = 0
        feed_iter = iter(feed)
        while True:
            if checkpoint is not None:
                from . import elastic

                # before the fetch: a preemption save here records a
                # cursor where every consumed batch was trained
                elastic.step_boundary(
                    manager=checkpoint,
                    save_fn=lambda: checkpoint.save_training(
                        epoch, net=net, trainer=trainer, train_iter=feed,
                        extra={"mid_epoch": True}))
            try:
                batch = next(feed_iter)
            except StopIteration:
                break
            if isinstance(batch, io_mod.DataBatch):
                data, label = batch.data[0], batch.label[0]
            else:
                data, label = batch
            loss = plane.step(data, label)
            nbatch += 1
            if batch_end_callback is not None:
                batch_end_callback(epoch, nbatch, loss)
        if checkpoint is not None and (
                (epoch + 1) % max(1, checkpoint_every) == 0
                or epoch == epochs - 1):
            checkpoint.save_training(epoch, net=net, trainer=trainer,
                                     train_iter=feed,
                                     extra={"mid_epoch": False},
                                     async_save=True)
    if checkpoint is not None:
        checkpoint.wait()
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
                or group.execs[0].crosses_devices \
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
