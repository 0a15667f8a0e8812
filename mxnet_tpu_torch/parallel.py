"""Meshes, collectives, shardings and the step executors: the port of
``mxnet_tpu/parallel.py``'s ``device_mesh`` (``:52-76``), the eager
collectives (``:79-243``), the sharding helpers (``:311-477``),
``TrainStep`` and ``InferStep`` (``:479-848``).

A process drives one device. A :class:`Mesh` spans the job's ranks
(``kvstore.init_distributed``), one member a rank, each a ``(rank,
device)`` pair; outside a job it is this process's one device, as
before. :func:`all_reduce` and :func:`all_reduce_multi` reduce a
process's copies across the job over ``torch.distributed`` (the JAX
package's three branches; see :func:`_prepare`); a :class:`Sharding`
names how an array lies over a mesh, and :func:`put_sharded` gives this
rank its block on its device, skipping the put where the tensor is laid
out so already.

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

Across the ranks of a job (``kvstore.init_distributed``) the step is
the JAX package's SPMD step over ``device_mesh()``
(``mxnet_tpu/parallel.py:479-690``), one process a rank: every rank
passes the same global batch, and :func:`put_sharded` gives each its
block along ``batch_axis`` (the whole batch, replicated, where the ranks
cannot split it evenly). The step function runs inside the job's
``_dist.Span``: BatchNorm in train mode normalises with the global
batch's statistics (``ops/nn.py``), the gradients are averaged over the
ranks in one flat buffer a dtype (one all-reduce each, the buffer made
once, outside the step), and ``TrainStep``'s mean loss too, so every
rank returns the job's mean loss and keeps the same weights bit for bit.
``InferStep`` gathers the ranks' outputs in rank order into the global
batch's output. A mesh must hold every rank of the job: a process drives
one device, and no process group spans a subset of the ranks.

Where the collectives run is the backend's to decide (``_dist``): under
NCCL (a card a rank) they are issued on the capture stream and recorded
inside the path's CUDA graph with the forward, the backward and the
update, even at world size 1; under gloo (ranks sharing a card, or the
CPU) a CUDA graph cannot hold them, so the same step function runs
uncaptured, each collective staged through pinned host memory. That is
decided before the first step, never after a failed capture:
``uncaptured_reason`` is then ``"gloo"``, each such step counts in
``mxnet_uncaptured_steps_total{site,reason}``, and ``compile_count``
stays 0. ``collectives_a_step`` counts the collectives of the last
path's step function.

:func:`pipeline_apply` is the JAX package's GPipe schedule
(``:244-306``) over the job's ranks: a stage a rank, each rank keeping
its row of the stage parameters, the activations handed to the next
rank by ``torch.distributed`` P2P each tick (staged through pinned host
memory under gloo), and the last stage's outputs broadcast to every
rank. It is a forward: no gradient flows back across the ranks.

Departures: the parameters are copied
once at the first call and updated in place, where the JAX package
donates and rebinds them. A capture runs with the garbage collector
paused, as the decode engine's does.
"""
from __future__ import annotations

import contextlib
import gc
import time
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch
import torch.utils.checkpoint

from . import _dist, autograd
from .base import MXNetError, resolve_device
from .context import Context, from_device
from .gluon.parameter import DeferredInitializationError
from .ndarray.ndarray import NDArray
from .fastpath import bucketing
from .telemetry import accounting as _accounting
from .telemetry import registry as _registry

__all__ = ["Mesh", "Sharding", "device_mesh", "all_reduce",
           "all_reduce_multi", "pipeline_apply", "broadcast_to_devices",
           "shard_for_device",
           "batch_sharding", "resolve_sharding", "put_sharded",
           "shard_to_mesh", "fresh_replicate", "TrainStep", "InferStep",
           "MemoryStats", "UNCAPTURED_STEPS"]

#: steps of a captured executor or plane that ran uncaptured, by site and
#: reason (``"gloo"``: the job's collectives cannot be recorded in a CUDA
#: graph)
UNCAPTURED_STEPS = _registry.counter(
    "mxnet_uncaptured_steps_total",
    "steps of a captured path run without a CUDA graph, by reason",
    labels=("site", "reason"))


class Mesh(object):
    """The devices a step or a collective spans: ``members``, a list of
    ``(rank, torch.device)`` pairs (one a rank of the job; one pair
    outside a job), laid out over ``axis_names`` with sizes ``shape``
    (an ordered name -> size map, as JAX's ``Mesh.shape``). ``devices``
    lists the members' devices, ``size`` counts them, and ``device`` is
    this rank's (a mesh's first member's where this rank is none)."""

    def __init__(self, members, axis_names=("dp",), shape=None):
        self.members = [(int(r), _as_device(d)) for r, d in members]
        self.devices = [d for _, d in self.members]
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in shape) if shape is not None \
            else (len(self.members),)
        if len(sizes) != len(self.axis_names):
            raise MXNetError("axis_names must match mesh shape rank")
        if int(np.prod(sizes)) != len(self.members):
            raise MXNetError("a mesh of shape %s needs %d members, not %d"
                             % (sizes, int(np.prod(sizes)),
                                len(self.members)))
        self.shape = OrderedDict(zip(self.axis_names, sizes))
        self.size = len(self.members)
        ranks = [r for r, _ in self.members]
        me = _dist.rank()
        self.local_index = ranks.index(me) if me in ranks else None
        self.device = self.devices[self.local_index or 0]

    def same_as(self, other) -> bool:
        return isinstance(other, Mesh) and self.members == other.members \
            and self.shape == other.shape

    def __repr__(self):
        return "Mesh(%s, axis_names=%s)" % (
            [("rank %d" % r, str(d)) for r, d in self.members],
            self.axis_names)


def _as_device(dev) -> torch.device:
    if isinstance(dev, Context):
        dev = dev.torch_device()
    return resolve_device(dev)


def device_mesh(n_devices=None, axis_names=("dp",), shape=None,
                devices=None) -> Mesh:
    """A mesh over the job's ranks, one member a rank, each on its own
    device (the card unless ``devices`` names another); outside a job,
    the one device of this process. ``devices`` holds one device a
    member, or one for every member (``[mx.cpu()]``); ``n_devices``
    keeps the first members. A process drives one device: several
    devices in one process raise."""
    world = _dist.world_size()
    if devices is None:
        grp = _dist.group()
        devices = list(grp.devices) if grp is not None else [None]
    devices = list(devices)
    if world > 1 and len(devices) == 1:
        devices = devices * world
    n = len(devices) if n_devices is None else int(n_devices)
    if shape is not None and n_devices is None:
        n = int(np.prod(shape))
    if n > world or n > len(devices):
        raise MXNetError(
            "a mesh of %d devices on %d process(es) is not ported: a "
            "process drives one device (start one process a device with "
            "mxnet_tpu_torch.tools.launch)" % (n, world))
    if world > 1 and n_devices is None and shape is None \
            and len(devices) != world:
        raise MXNetError("a mesh over the job names one device a rank "
                         "(%d), got %d" % (world, len(devices)))
    return Mesh(list(enumerate(devices[:n])), axis_names, shape)


# ---------------------------------------------------------------------------
# eager collectives (the kvstore's reduce)
# ---------------------------------------------------------------------------

_REDUCE_OPS = ("sum", "mean", "max", "min")


def _tensor_of(a) -> torch.Tensor:
    if isinstance(a, NDArray):
        return a._data
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a))


def _acc_reduce(datas, op):
    """The copies combined in list order on the first copy's device."""
    dev = datas[0].device
    acc = datas[0]
    for d in datas[1:]:
        d = d.to(dev)
        if op in ("sum", "mean"):
            acc = acc + d
        elif op == "max":
            acc = torch.maximum(acc, d)
        else:
            acc = torch.minimum(acc, d)
    return acc


def _prepare(datas, op):
    """This process's part of a reduce across the job: ``(tensor the
    collective reduces in place, collective op, finish)``.

    One copy (the per-device branch): a copy of it, and ``mean`` divides
    the job's sum by the world size. Several copies (the pre-reduce
    branch, ``mxnet_tpu/parallel.py:147-194``): their local combination,
    and for ``mean`` the local copy count rides as one extra element
    through the same sum, so processes may hold different counts; the
    quotient keeps a float input's dtype and promotes an integer one to
    float32 (the true-divide rule of the other branches)."""
    world = _dist.world_size()
    if len(datas) == 1:
        t = datas[0].clone()
        if op == "mean":
            return t, "sum", lambda r: r / world
        return t, op, lambda r: r
    acc = _acc_reduce(datas, op)
    if op != "mean":
        return acc, op, lambda r: r
    shape, dtype = acc.shape, acc.dtype
    pack = torch.promote_types(dtype, torch.float32)
    flat = torch.cat([acc.reshape(-1).to(pack),
                      torch.full((1,), float(len(datas)), dtype=pack,
                                 device=acc.device)])
    div = dtype if dtype.is_floating_point \
        else torch.promote_types(dtype, torch.float32)
    return flat, "sum", lambda r: (r[:-1] / r[-1]).reshape(shape).to(div)


def all_reduce(arrays, op: str = "sum"):
    """Reduce this process's copies (tensors, NDArrays or arrays) with
    ``op`` (``sum``, ``mean``, ``max`` or ``min``) across the job; returns
    the result on the first copy's device, the same on every rank.

    Outside a job the copies combine on the device in list order (a single
    copy is returned as it is). In a job every rank passes its copies: one
    copy a rank takes one collective over the group, several are
    combined locally first (see :func:`_prepare`); every rank must take
    the same branch for ``mean``, as in the JAX package."""
    if op not in _REDUCE_OPS:
        raise MXNetError("unsupported all_reduce op %r" % (op,))
    datas = [_tensor_of(a) for a in arrays]
    if _dist.world_size() == 1:
        if len(datas) == 1:
            return datas[0]
        acc = _acc_reduce(datas, op)
        return acc / len(datas) if op == "mean" else acc
    t, cop, finish = _prepare(datas, op)
    _dist.group().all_reduce([t], cop)
    return finish(t)


def all_reduce_multi(groups, op: str = "sum"):
    """:func:`all_reduce` of many tensors (``groups[k]``: tensor ``k``'s
    copies): each group's copies combine on the device, then one
    collective a group runs across the job, all of them started before
    any is waited on. Returns one result a group."""
    if op not in _REDUCE_OPS:
        raise MXNetError("unsupported all_reduce op %r" % (op,))
    if not groups:
        return []
    if _dist.world_size() == 1:
        return [all_reduce(g, op) for g in groups]
    parts = [_prepare([_tensor_of(a) for a in g], op) for g in groups]
    by_op = OrderedDict()
    for t, cop, _ in parts:
        by_op.setdefault(cop, []).append(t)
    for cop, ts in by_op.items():
        _dist.group().all_reduce(ts, cop)
    return [finish(t) for t, _, finish in parts]


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested lists, tuples and dicts."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_apply(stage_fn, stage_params, microbatches, mesh=None,
                   axis: str = "pp"):
    """GPipe pipeline parallelism over the job's ranks (the JAX package's
    ``pipeline_apply``, ``mxnet_tpu/parallel.py:244-306``): stage ``s`` is
    rank ``s``, and the ``axis`` of ``mesh`` (every rank; by default
    ``device_mesh(axis_names=(axis,))``) counts the stages.

    ``stage_fn(params_s, x) -> y`` is one stage's computation on tensors;
    activations keep one shape across stages. ``stage_params`` is a tree
    (nested lists, tuples, dicts) of tensors, NDArrays or arrays whose
    leaves have a leading stage axis ``(S, ...)``: each rank keeps its
    row. ``microbatches`` is the ``(M, B, ...)`` stream, the same on every
    rank. The schedule runs ``M + S - 1`` ticks: at tick ``t`` stage 0
    takes microbatch ``t`` and stage ``s`` the activation stage ``s - 1``
    sent it at ``t - 1`` (one ``batch_isend_irecv`` a tick between
    neighbours; a stage idles before its first microbatch and after its
    last). Returns the last stage's ``(M, B, ...)`` outputs in
    microbatch order on every rank (a broadcast from the last rank), as
    a tensor, or an NDArray for an NDArray ``microbatches``. Outside a job
    the one stage runs every microbatch. A forward, under
    ``torch.no_grad``."""
    grp = _dist.group()
    if mesh is None:
        mesh = device_mesh(axis_names=(axis,))
    if axis not in mesh.shape:
        raise MXNetError("pipeline_apply: the mesh has no axis %r (axes %s)"
                         % (axis, mesh.axis_names))
    n_stage = int(mesh.shape[axis])
    world = _dist.world_size()
    if n_stage != world:
        raise MXNetError(
            "pipeline_apply: the %r axis must hold every rank of the job "
            "(%d), a stage a rank; got %d" % (axis, world, n_stage))
    if grp is not None:
        job_span(mesh, "pipeline_apply")
    leaves = []
    _tree_map(lambda a: leaves.append(_tensor_of(a)), stage_params)
    bad = [tuple(t.shape) for t in leaves
           if t.dim() == 0 or t.shape[0] != n_stage]
    if bad:
        raise MXNetError(
            "pipeline_apply: every stage_params leaf needs leading dim %d "
            "(one stage per '%s' device); got %s" % (n_stage, axis, bad))
    rank = _dist.rank()
    dev = mesh.device
    params = _tree_map(lambda a: _tensor_of(a)[rank].to(dev), stage_params)
    xs = _tensor_of(microbatches).to(dev)
    n_micro = int(xs.shape[0])
    outs = []
    with torch.no_grad():
        act = torch.zeros_like(xs[0])
        for t in range(n_micro + n_stage - 1):
            out = None
            if rank <= t < n_micro + rank:
                out = stage_fn(params, xs[t] if rank == 0 else act)
                if out.data_ptr() == act.data_ptr():
                    out = out.clone()  # the next receive writes act
                if rank == n_stage - 1:
                    outs.append(out)
            send = [out] if out is not None and rank < n_stage - 1 else []
            recv = [act] if 0 < rank and rank - 1 <= t < n_micro + rank - 1 \
                else []
            if send or recv:
                grp.exchange(send, rank + 1, recv, rank - 1)
        if rank == n_stage - 1:
            result = torch.stack(outs)
        else:
            result = torch.empty((n_micro,) + tuple(xs.shape[1:]),
                                 dtype=xs.dtype, device=dev)
        if grp is not None:
            grp.broadcast(result, n_stage - 1)
    return NDArray(result) if isinstance(microbatches, NDArray) else result


def shard_for_device(array, device):
    """The copy of ``array`` on ``device`` (itself where it lies there)."""
    return _tensor_of(array).to(_as_device(device))


def broadcast_to_devices(array, devices):
    """A fresh copy of ``array`` on each device of ``devices`` (reference
    comm.h Broadcast)."""
    data = _tensor_of(array)
    out = []
    for d in devices:
        dst = torch.empty(data.shape, dtype=data.dtype, device=_as_device(d))
        out.append(dst.copy_(data))
    return out


# ---------------------------------------------------------------------------
# shardings: how a batch or a state lies over a mesh
# ---------------------------------------------------------------------------


class Sharding(object):
    """How an array lies over ``mesh``: ``spec[d]`` names the mesh axis
    (or a tuple of axes) that dimension ``d`` is split over, ``None``
    leaves it whole; dimensions past ``spec`` are whole. Each member
    holds its block of every split dimension on its device (the port's
    ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _parts(self, names):
        names = names if isinstance(names, tuple) else (names,)
        return [n for n in names if self.mesh.shape[n] > 1]

    def normalized(self, ndim: int):
        """The spec padded to ``ndim``, axes of size 1 left out."""
        spec = list(self.spec[:ndim]) + [None] * (ndim - len(self.spec))
        return tuple(tuple(self._parts(s)) or None if s is not None
                     else None for s in spec)

    def is_equivalent_to(self, other, ndim: int) -> bool:
        return isinstance(other, Sharding) and \
            self.mesh.same_as(other.mesh) and \
            self.normalized(ndim) == other.normalized(ndim)

    def block(self, shape):
        """This rank's slices of an array of ``shape``."""
        if self.mesh.local_index is None:
            raise MXNetError("rank %d is not a member of %r"
                             % (_dist.rank(), self.mesh))
        coords = dict(zip(self.mesh.axis_names, np.unravel_index(
            self.mesh.local_index, tuple(self.mesh.shape.values()))))
        out = []
        for dim, names in enumerate(self.normalized(len(shape))):
            if names is None:
                out.append(slice(None))
                continue
            idx, parts = 0, 1
            for n in names:
                idx = idx * self.mesh.shape[n] + int(coords[n])
                parts *= self.mesh.shape[n]
            step = shape[dim] // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def __repr__(self):
        return "Sharding(%r, spec=%s)" % (self.mesh, self.spec)


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0,
                   dp_axis=None) -> Sharding:
    """The sharding a training batch arrives in: split over the mesh's
    data-parallel axis at ``batch_axis``, whole elsewhere."""
    spec = [None] * ndim
    spec[batch_axis] = dp_axis or mesh.axis_names[0]
    return Sharding(mesh, spec)


def resolve_sharding(sharding, ndim: int):
    """A sharding, or an ``ndim -> sharding`` callable, for one array of
    ``ndim`` dimensions; ``None`` when there is none."""
    if sharding is None:
        return None
    return sharding(ndim) if callable(sharding) else sharding


def _evenly_shardable(target: Sharding, shape) -> bool:
    for dim, names in enumerate(target.normalized(len(shape))):
        if names is None:
            continue
        parts = int(np.prod([target.mesh.shape[n] for n in names]))
        if shape[dim] % parts:
            return False
    return True


def _part(data, target: Sharding):
    """``(data's part under target, the target it is laid out by)``:
    ``data`` itself where an earlier put laid it out so, else this rank's
    block of the whole array (the whole, replicated, where the target
    cannot split it evenly). A block laid out otherwise holds only this
    rank's rows, and raises."""
    sh = getattr(data, "_mx_sharding", None)
    if sh is not None and sh.is_equivalent_to(target, data.ndim):
        return data, target
    if sh is not None and any(sh.normalized(data.ndim)):
        raise MXNetError("%r cannot be laid out again as %r: a block holds "
                         "only this rank's rows" % (sh, target))
    if not _evenly_shardable(target, data.shape):
        target = Sharding(target.mesh)
    return data[target.block(data.shape)], target


def put_sharded(data, target: Sharding):
    """This rank's block of ``data`` under ``target``, on this rank's
    device: the one home of the skip-put discipline. A tensor laid out so
    already (tagged by an earlier put), and a tensor already on the
    device of a one-member mesh, are returned as they are, so callers can
    ``is``-check whether a put happened. A batch the target cannot split
    evenly is replicated over the same mesh instead (the ragged last
    batch of an epoch)."""
    data = _tensor_of(data)
    mesh = target.mesh
    if getattr(data, "_mx_sharding", None) is None and mesh.size == 1 \
            and data.device == mesh.device:
        return data
    part, target = _part(data, target)
    if part is data:
        return data
    out = part.to(mesh.device).contiguous()
    out._mx_sharding = target
    return out


def shard_to_mesh(data, mesh: Mesh, batch_axis: int = 0, dp_axis=None):
    """A batch laid out over the mesh's data-parallel axis through
    :func:`put_sharded`."""
    data = _tensor_of(data)
    return put_sharded(data, batch_sharding(mesh, data.ndim, batch_axis,
                                            dp_axis))


def fresh_replicate(x, mesh: Mesh, target=None):
    """``x`` laid out over ``mesh`` as ``target`` (a sharding or an
    ``ndim -> sharding`` callable; whole by default) in a FRESH tensor,
    one copy, never aliasing ``x``: an already laid-out source is copied
    as it is, a whole one gives this rank its block."""
    x = _tensor_of(x)
    part, target = _part(x, resolve_sharding(target, x.ndim) or
                         Sharding(mesh))
    out = torch.empty(part.shape, dtype=part.dtype, device=mesh.device)
    out.copy_(part)
    out._mx_sharding = target
    return out


def job_span(mesh: Mesh, what: str):
    """The ``_dist.Span`` of a step over ``mesh``: None outside a job; in a
    job the mesh must hold every rank of it (a process drives one device,
    and no process group spans a subset of the ranks)."""
    grp = _dist.group()
    if grp is None:
        return None
    if sorted(r for r, _ in mesh.members) != list(range(grp.world)):
        raise MXNetError(
            "%s over %r leaves ranks of the job of %d out: a process "
            "drives one device, and no process group spans a subset of "
            "the ranks" % (what, mesh, grp.world))
    return _dist.Span(grp)


def rank_block(x, mesh: Mesh, batch_axis: int):
    """``(this rank's block of the global batch x along batch_axis,
    whether the ranks split it)``: the whole batch, replicated, where they
    cannot split it evenly. Over one rank the batch counts as split."""
    block = put_sharded(x, batch_sharding(mesh, x.ndim, batch_axis))
    sh = getattr(block, "_mx_sharding", None)
    split = mesh.size == 1 or sh is None or \
        any(sh.normalized(block.ndim))
    return block, split


def global_rows(x, batch_axis: int) -> int:
    """The global batch's rows of ``x`` along ``batch_axis``: its own,
    or a laid-out block's times the ranks that split it."""
    rows = int(x.shape[batch_axis])
    sh = getattr(x, "_mx_sharding", None)
    if sh is not None:
        names = sh.normalized(x.ndim)[batch_axis]
        for n in names or ():
            rows *= sh.mesh.shape[n]
    return rows


def gather_axis(shape, rows: int, batch_axis: int) -> int:
    """The axis of a rank's output that holds its ``rows`` batch rows:
    ``batch_axis`` where it does, else the first that does."""
    if batch_axis < len(shape) and shape[batch_axis] == rows:
        return batch_axis
    for ax, n in enumerate(shape):
        if n == rows:
            return ax
    raise MXNetError("an output of shape %s has no axis of the rank's %d "
                     "batch rows to gather the ranks' outputs along"
                     % (tuple(shape), rows))


def gather_ranks(span, t: torch.Tensor, axis: int) -> torch.Tensor:
    """Every rank's ``t`` joined along ``axis`` in rank order (one
    all-gather)."""
    buf = torch.empty((span.world,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    span.all_gather(buf, t.contiguous())
    out = buf.movedim(0, axis)
    shape = list(t.shape)
    shape[axis] *= span.world
    return out.reshape(shape)


class GradBuffers(object):
    """One flat buffer a gradient dtype, made once for a layout of
    gradients (``fastpath.bucketing.flat_plan``), so a captured graph
    holds its address: :meth:`average` packs the gradients in with one
    ``torch.cat`` a buffer, averages each buffer over the span's ranks in
    place, and returns views of it shaped as the gradients."""

    def __init__(self, like, device):
        like = list(like)
        self.sig = tuple((tuple(t.shape), t.dtype) for t in like)
        self.plan = bucketing.flat_plan(like, [t.dtype for t in like])
        self.flats = [torch.empty(self.plan.bucket_layout(b)[1],
                                  dtype=like[pos[0]].dtype, device=device)
                      for b, pos in enumerate(self.plan.buckets)]

    def average(self, span, grads):
        for pos, flat in zip(self.plan.buckets, self.flats):
            torch.cat([grads[i].reshape(-1) for i in pos], out=flat)
        span.all_reduce(self.flats, "avg")
        return self.plan.unpack(self.flats)


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
            # no garbage collection inside the capture (as the decode
            # engine's): a collection could free another graph's memory
            # on this thread mid-capture
            collecting = gc.isenabled()
            gc.disable()
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
            finally:
                if collecting:
                    gc.enable()
            path.graph, path.out = graph, out
        path.ready = True
        self._captures += 1
        _accounting.note_recompile(self._site, 1, time.perf_counter() - t0)


class _Executor(_Graphs):
    """What TrainStep and InferStep share: the mesh's device, the snapshot
    of the net's parameters, and the memory of each path's first run."""

    def __init__(self, net, mesh, batch_axis):
        self._mesh = mesh if mesh is not None else device_mesh()
        super().__init__(self._mesh.device)
        self._net = net
        self._batch_axis = int(batch_axis)
        self._span = job_span(self._mesh, type(self).__name__)
        #: why the paths run without a CUDA graph (None: captured on the
        #: card)
        self.uncaptured_reason = "gloo" if self._span is not None \
            and self._span.backend == "gloo" else None
        self._collectives = 0
        self._pvals = None
        self._first_call_captures = None

    @property
    def collectives_a_step(self) -> int:
        """Collectives the last path's step function issued in one run
        (0 outside a job)."""
        return self._collectives

    def _block(self, x, lead=0):
        """``(x, whether split)``: outside a job the batch itself; in a
        job this rank's block along ``batch_axis`` (``lead`` leading axes
        before it) and whether the ranks split it."""
        if self._span is None:
            return x, True
        return rank_block(x, self._mesh, self._batch_axis + lead)

    def _new_path(self, inputs, fn) -> _Path:
        """A path over ``inputs``: counted collectives in a job, and
        never captured where ``uncaptured_reason`` says so."""
        span = self._span
        if span is not None:
            inner = fn

            def fn():
                before = span.collectives
                out = inner()
                self._collectives = span.collectives - before
                return out
        path = _Path(inputs, fn)
        path.ready = self.uncaptured_reason is not None
        return path

    def _note_uncaptured(self, path):
        if path.graph is None and self.uncaptured_reason is not None:
            UNCAPTURED_STEPS.inc(site=self._site,
                                 reason=self.uncaptured_reason)

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

    In a job the step spans the mesh's ranks (the module's docstring):
    ``loss`` is the job's mean loss on every rank, the gradients are
    averaged over the ranks inside the step, and BatchNorm takes the
    global batch's statistics; ``batch_axis`` names the axis of ``data``
    and ``label`` the ranks split.

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
        self._grad_bufs = None

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
        if self._span is not None:
            self._grad_bufs = GradBuffers(
                [self._pvals[n] for n in self._diff], self._device)

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
        """The step on the static tensors: returns the 0-d mean loss (in
        a job the ranks' mean, the gradients averaged over the ranks)."""
        ws = [self._pvals[n] for n in self._diff]
        span = self._span
        # the backward stays inside _bound: remat's recompute runs the net
        # there, and must see the step's parameters
        with _bound(self._params, self._pvals), _dist.spanning(span):
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
        loss = loss.detach()
        with torch.no_grad():
            if span is not None:
                grads = self._grad_bufs.average(span, grads)
                loss = loss.reshape(1).clone()
                span.all_reduce([loss], "avg")
                loss = loss.reshape(())
            self._optimizer.pure_step(ws, grads, self._states, self._t_dev,
                                      self._lr_dev, self._lr_mults,
                                      self._wds)
        return loss

    def _path(self, data, label) -> _Path:
        key = (tuple(data.shape), data.dtype, tuple(label.shape),
               label.dtype)
        path = self._paths.get(key)
        if path is None:
            d, lab = self._static(data), self._static(label)
            path = self._new_path((d, lab), lambda: self._step_fn(d, lab))
            if not self._capture_graphs:
                path.ready = True  # eager: never captured
            self._paths[key] = path
        return path

    def _replay_step(self, path, data, label, t):
        d, lab = path.inputs
        d.copy_(data)
        lab.copy_(label)
        self._t_dev.fill_(float(t))
        out = self._run(path)
        self._note_uncaptured(path)
        return out

    def __call__(self, data, label):
        data, _ = self._block(_host_tensor(data))
        label, _ = self._block(_host_tensor(label))
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
        datas, _ = self._block(_host_tensor(datas), 1)
        labels, _ = self._block(_host_tensor(labels), 1)
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
    current values into that snapshot in place, keeping the graphs.

    In a job each rank runs the forward on its block of the global batch
    (along ``batch_axis``) and the ranks' outputs are gathered in rank
    order, inside the path, into the global batch's output (along the
    output's axis of the rank's rows, ``batch_axis`` where it is one); a
    batch the ranks cannot split runs whole on every rank."""

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

    def _forward(self, data, split):
        with _bound(self._params, self._pvals), autograd.pause(), \
                torch.no_grad():
            out = self._net(NDArray(data))
            out = (out[0] if isinstance(out, (tuple, list)) else out)._data
            if self._span is not None and split:
                rows = data.shape[self._batch_axis]
                out = gather_ranks(self._span, out, gather_axis(
                    out.shape, rows, self._batch_axis))
        return out

    def _path(self, data, split) -> _Path:
        key = (tuple(data.shape), data.dtype, split)
        path = self._paths.get(key)
        if path is None:
            d = self._static(data)
            path = self._paths[key] = self._new_path(
                (d,), lambda: self._forward(d, split))
        return path

    def _replay(self, path, data):
        path.inputs[0].copy_(data)
        out = self._run(path)
        self._note_uncaptured(path)
        return out

    def __call__(self, data):
        data, split = self._block(_host_tensor(data))
        self._ensure_init(data)
        out = self._replay(self._path(data, split), data).clone()
        self._end_call()
        return NDArray(out)

    def multi_call(self, datas):
        datas, split = self._block(_host_tensor(datas), 1)
        self._ensure_init(datas[0])
        path = self._path(datas[0], split)
        outs = [self._replay(path, datas[i]).clone()
                for i in range(int(datas.shape[0]))]
        self._end_call()
        return NDArray(torch.stack(outs))
