"""ZeRO-1/2: the optimizer states sharded over the job's ranks (the port
of ``mxnet_tpu/fastpath/zero.py``).

A replicated data-parallel job keeps every parameter's optimizer states
on every rank, so a rank's device memory, not its compute, caps the
model. Here each rank of the job keeps ``1/N`` of them (the ZeRO
partitioning of arxiv 1910.02054):

* **ZeRO-1** (``MXNET_ZERO=1``): the optimizer states (momenta, variance
  accumulators, ...) live partitioned over the ranks; each rank holds its
  ``1/N`` of every state bucket between steps.
* **ZeRO-2** (``MXNET_ZERO=2``): also the float32 masters of the
  ``multi_precision`` (float16/bfloat16) path. At level 1 a rank keeps
  every master whole, with the parameters, as classic ZeRO-1 does.

Layout: every ``(weight, grad, state)`` leaf joins a flat bucket a
(weight dtype, state layout, master pair) key (``bucketing.flat_plan``),
zero-padded to a multiple of the world size, so each bucket splits into
``N`` equal shards; rank ``r`` owns elements ``[r*S, (r+1)*S)``. Its
shard of a bucket covers whole parameters and at most two partial ones:
a *segment* is the part of one parameter inside the shard.

A step (:func:`apply`, behind ``fastpath.apply_updater``) takes the
gradients the store has already reduced (every rank holds the sum, as
in the JAX eager path) and runs the same host prologue as
``fused_apply``, in the same order (``_update_count`` then
``_host_scalars`` per index). :meth:`ZeroPlane.expand_scalars` lays the
per-parameter (t, lr, wd) over the static layout of this rank's shard,
one entry a segment; then ``fused.tree_kernel``, the replicated fused
apply's own kernel (``Optimizer._leaf_step`` over ``torch._foreach_*``),
updates the segments in place: views of the parameters, of their
gradients and of this rank's state shards. The kernel is pointwise, so a
segment's elements get exactly the arithmetic they get in the replicated
step, and the sharded step equals it bit for bit. Last, each bucket's
updated weights (at level 1 with master pairs: the masters, which the
weights are cast from) are all-gathered into one flat buffer, one
collective a bucket (``_dist.Group.all_gather``; under gloo a card
tensor is staged through pinned host memory and counted in
``mxnet_dist_staged_bytes_total{op="all_gather"}``), and copied into
every parameter in place (``torch._foreach_copy_``): a captured plane
holds the parameters' addresses.

Collectives. The step's all-gather, and :func:`materialize_updater`,
are collectives over the job: every rank calls them together. A
materialization first meets the other ranks at a store barrier (the
job's ``TCPStore``, :func:`_dist.store_barrier`) and only then issues
the all-gather, so a rank that calls it alone raises
:class:`ZeroCollectiveError` after the job's collective timeout
(``_dist._TIMEOUT_S``, 300 s) and never hangs. These callers
materialize, and so are collectives whenever a plane is attached:
``Updater.get_states`` (so ``Trainer.save_states``,
``Module.save_optimizer_states``, ``KVStore.save_optimizer_states``),
``Updater.__call__`` on a sharded index (an eager per-parameter update),
``fastpath.apply_updater`` once ``MXNET_ZERO`` is turned off (through
:func:`ensure_materialized`), and a step whose layout changed
(:func:`acquire_plane`). ``Updater.set_states``/``adopt_states`` drop the
plane without a collective: they replace every state.

Never a crash: what the gate rejects (:func:`eligible_reason`: a job of
one rank, where sharding is a no-op; an order-sensitive host prologue,
Nadam's ``m_schedule`` or SGLD's draws; a non-pointwise kernel, LBSGD's
layer norms; kernel extras), ``update_on_kvstore``, a multi-position
update, and a layout that cannot be built fall back to the replicated
path, counted in ``mxnet_zero_fallbacks_total{reason}``. A step that
fails after its kernel ran raises: its weights moved, and a replicated
rerun would apply the update twice.

Kept deviations from the JAX package:

* **The dp axis is the job's ranks.** The JAX package shards over the
  local devices of one process; the port runs one device a process, so
  its mesh members are ``(rank, device)`` pairs and the state is sharded
  over ``_dist.world_size()`` ranks.
* ``MXNET_ZERO_DEVICES``: ``0`` or any value of at least the world size
  shards over every rank, ``1`` means no sharding (the "1-device mesh"
  fallback, as in the JAX package), and a value between raises naming
  the knob: sharding over a subset of the ranks with the rest replicated
  would need a process group a subset; it is not ported.
* No buffer donation: the port updates in place, so the JAX package's
  ``donation_prep``/``invalidate_consumed`` and its "donated step
  failed" branches have no counterpart.
* The in-step plane (:meth:`ZeroPlane.traced_update`, what a
  ``TrainPlane`` across ranks runs at ``MXNET_ZERO`` >= 1) reduce-scatters
  the packed gradients: NCCL's ``reduce_scatter_tensor`` with its
  average, recorded in the plane's CUDA graph; under gloo the same
  collective staged through pinned host memory, then the division by the
  world size (``_dist.Span.reduce_scatter``). A ``TrainPlane`` on one rank
  declines with the "1-device mesh" reason, as the JAX plane on a
  1-device mesh.
* :meth:`ZeroPlane.shard_export` returns this rank's shard only; every
  rank writes its own shard file (``elastic``).
"""
from __future__ import annotations

import copy
import itertools
import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import _dist, telemetry
from ..base import MXNetError, fetch_host, get_env
from ..optimizer import (_rebuild_state, _state_leaves, _structure,
                         ensure_mp_state)
from ..telemetry import OPT_DISPATCHES
from . import bucketing

_LOG = logging.getLogger(__name__)

__all__ = ["level", "ZeroPlane", "ShardedState", "ZeroCollectiveError",
           "eligible_reason", "note_fallback", "plane_of",
           "materialize_updater", "ensure_materialized", "acquire_plane",
           "apply", "state_bytes_on", "is_sharded", "states_from_export",
           "FALLBACKS", "MATERIALIZATIONS"]

#: why a sharded update was declined, by reason: the record that
#: MXNET_ZERO quietly stayed on the replicated path
FALLBACKS = telemetry.counter(
    "mxnet_zero_fallbacks_total",
    "ZeRO sharded-state updates declined, by reason",
    labels=("reason",))

#: every all-gather of the sharded states back to the plain layout. The
#: sharded checkpoint (``elastic.CheckpointManager.save_training``) does
#: not move it: the tests and chip_smoke.py assert a zero delta across a
#: sharded save
MATERIALIZATIONS = telemetry.counter(
    "mxnet_zero_materializations_total",
    "sharded state buckets all-gathered back to the plain per-parameter "
    "layout (checkpoint via the materialized path, eager interleave, "
    "layout change)")

#: the store barriers of materializations, numbered alike on every rank
_GATHER_SEQ = itertools.count()


class ZeroCollectiveError(MXNetError):
    """A materialization that the other ranks of the job did not join."""


def level() -> int:
    """``MXNET_ZERO``: ``0`` replicated (default), ``1`` shard the
    optimizer states, ``2`` also the float32 masters. Read at each call."""
    lv = get_env("MXNET_ZERO", 0, int, cache=False)
    return lv if lv in (0, 1, 2) else 0


def _max_devices() -> int:
    """``MXNET_ZERO_DEVICES`` (default 0: every rank)."""
    return get_env("MXNET_ZERO_DEVICES", 0, int, cache=False) or 0


def _ndev() -> int:
    """The ranks the states are sharded over: the job's, or 1 (no
    sharding) under ``MXNET_ZERO_DEVICES=1``; a value between raises."""
    world = _dist.world_size()
    cap = _max_devices()
    if cap and cap < world:
        if cap == 1:
            return 1
        raise MXNetError(
            "MXNET_ZERO_DEVICES=%d: the port shards the optimizer states "
            "over every rank of the job or over none (0 or %d: all ranks, "
            "1: none); a subset of the ranks is not ported" % (cap, world))
    return world


def note_fallback(reason: str) -> None:
    FALLBACKS.inc(reason=reason)
    from ..telemetry import flightrec

    flightrec.record("zero.fallback", reason=reason)


#: per-class memo of whether _host_scalars gives kernel extras, probed
#: once on a deep copy (stateless prologues only: the stateful ones are
#: ruled out before the probe)
_EXTRAS_CACHE: Dict[type, bool] = {}


def _kernel_has_extras(optimizer) -> bool:
    cls = type(optimizer)
    if cls not in _EXTRAS_CACHE:
        pd, optimizer.param_dict = optimizer.param_dict, {}
        try:
            probe = copy.deepcopy(optimizer)
        except Exception:  # noqa: BLE001 - unprobeable => conservative
            _EXTRAS_CACHE[cls] = True
            return True
        finally:
            optimizer.param_dict = pd
        probe.param_dict = {}
        try:
            probe._update_count(0)
            _lr, _wd, ex = probe._host_scalars(0)
            _EXTRAS_CACHE[cls] = bool(ex)
        except Exception:  # noqa: BLE001 - unprobeable => conservative
            _EXTRAS_CACHE[cls] = True
    return _EXTRAS_CACHE[cls]


def eligible_reason(optimizer, ndev: int) -> Optional[str]:
    """Why this optimizer over ``ndev`` ranks cannot take the sharded
    plane (None when it can): the JAX package's gate
    (``mxnet_tpu/fastpath/zero.py:138-154``), with the world size as
    ``ndev``."""
    if ndev <= 1:
        return "1-device mesh (sharding is a no-op)"
    if not getattr(optimizer, "fastpath_capable", False):
        return "optimizer has no pure _leaf_step kernel"
    if getattr(optimizer, "_host_scalars_stateful", False):
        return "order-sensitive host prologue (%s)" % \
            type(optimizer).__name__
    if not getattr(optimizer, "_leaf_step_pointwise", False):
        return "non-pointwise _leaf_step (%s)" % type(optimizer).__name__
    if _kernel_has_extras(optimizer):
        return "kernel extras (%s)" % type(optimizer).__name__
    return None


class ShardedState(object):
    """Placeholder in ``Updater.states`` while the real state of that
    index lives flat-packed and sharded inside a :class:`ZeroPlane`.
    Whatever needs the plain layout (``Updater.get_states``/``__call__``)
    sees the ``_is_zero_shard`` mark and calls :func:`materialize_updater`
    first."""

    _is_zero_shard = True
    __slots__ = ("plane", "pos")

    def __init__(self, plane: "ZeroPlane", pos: int):
        self.plane = plane
        self.pos = pos

    def __repr__(self):
        return "ShardedState(pos=%d, level=%d)" % (self.pos,
                                                   self.plane.level)


def is_sharded(state) -> bool:
    return getattr(state, "_is_zero_shard", False)


class ZeroPlane(object):
    """One sharded layout over the job's ranks: the flat bucket plan,
    this rank's state shards (``buckets[b]``: one flat tensor a state
    leaf, ``S`` long, or the whole padded bucket for a replicated slot)
    and the step over them."""

    def __init__(self, optimizer, group, zero_level: int, indices,
                 weights: Sequence[torch.Tensor], states: Sequence[Any],
                 mp_flags: Sequence[bool]):
        self.group = group
        self.dp = int(group.world)
        self.rank = int(group.rank)
        self.level = int(zero_level)
        self.indices = tuple(indices)
        self.mp_flags = tuple(bool(m) for m in mp_flags)
        self.device = weights[0].device
        keys = [(str(w.dtype), _structure(s), bool(mp))
                for w, s, mp in zip(weights, states, mp_flags)]
        self.plan = bucketing.flat_plan(weights, keys, pad_to=self.dp)
        self.bucket_mp = tuple(self.mp_flags[b[0]]
                               for b in self.plan.buckets)
        self.bucket_dtypes = tuple(weights[b[0]].dtype
                                   for b in self.plan.buckets)
        self.templates = [_structure(states[b[0]])
                          for b in self.plan.buckets]
        self.sig = (self.indices, self.plan.sig, self.level, self.dp,
                    self.mp_flags)
        self.buckets: Optional[List[List[torch.Tensor]]] = None
        self._segments = [self._segments_of(b)
                          for b in range(len(self.plan.buckets))]
        try:
            from ..resilience import hbm as _hbm

            _hbm.register_bound("fastpath.zero.buckets",
                                self._resident_bytes(states))
        except Exception:  # noqa: BLE001 - the bound is advisory; the
            # plane works without a governor registration
            _LOG.debug("hbm bound registration failed", exc_info=True)

    # -- layout -------------------------------------------------------------
    def shard_len(self, b: int) -> int:
        return self.plan.bucket_layout(b)[1] // self.dp

    def replicated_slot(self, b: int, j: int) -> bool:
        """Classic ZeRO-1 keeps the float32 master (slot 0 of a master
        pair) whole on every rank, with the parameters."""
        return self.bucket_mp[b] and self.level < 2 and j == 0

    def _segments_of(self, b: int):
        """``(position, lo, hi, shard offset, bucket offset)`` of each
        parameter's part ``[lo, hi)`` (flat, of the parameter) inside this
        rank's shard of bucket ``b``, in bucket order."""
        sizes, _ = self.plan.bucket_layout(b)
        s = self.shard_len(b)
        start, end = self.rank * s, (self.rank + 1) * s
        out, boff = [], 0
        for pos, n in zip(self.plan.buckets[b], sizes):
            lo, hi = max(boff, start), min(boff + n, end)
            if lo < hi:
                out.append((pos, lo - boff, hi - boff, lo - start, boff))
            boff += n
        return out

    def _resident_bytes(self, states) -> int:
        total = 0
        for b, positions in enumerate(self.plan.buckets):
            _, padded = self.plan.bucket_layout(b)
            for j, leaf in enumerate(_state_leaves(states[positions[0]])):
                n = padded if self.replicated_slot(b, j) else \
                    self.shard_len(b)
                total += n * leaf.element_size()
        return total

    # -- adoption / materialization -----------------------------------------
    def adopt(self, states: Sequence[Any]) -> None:
        """Pack this rank's shard of every state slot from the plain
        per-parameter ``states`` (parallel to the plan's positions): a
        local copy of ``1/N`` of them (the whole bucket for a replicated
        slot), no collective."""
        buckets = []
        for b, positions in enumerate(self.plan.buckets):
            leaf_lists = [_state_leaves(states[i]) for i in positions]
            nslot = len(leaf_lists[0])
            if any(len(ll) != nslot for ll in leaf_lists):
                raise MXNetError("states of one bucket differ in layout")
            sizes, padded = self.plan.bucket_layout(b)
            by_pos = dict(zip(positions, leaf_lists))
            slots = []
            for j in range(nslot):
                ref = leaf_lists[0][j]
                if self.replicated_slot(b, j):
                    parts = [ll[j].reshape(-1) for ll in leaf_lists]
                    pad = padded - sum(sizes)
                else:
                    parts = [by_pos[pos][j].reshape(-1)[lo:hi]
                             for pos, lo, hi, _off, _boff
                             in self._segments[b]]
                    pad = self.shard_len(b) - sum(hi - lo for _p, lo, hi,
                                                  _o, _b in
                                                  self._segments[b])
                for p in parts:
                    if p.dtype != ref.dtype:
                        raise MXNetError("states of one bucket differ in "
                                         "dtype")
                if pad:
                    parts.append(ref.new_zeros(pad))
                slots.append(torch.cat([p.detach() for p in parts])
                             .to(self.device))
            buckets.append(slots)
        self.buckets = buckets

    def materialize(self) -> List[Any]:
        """All-gather the shards back into plain per-parameter state
        trees (plan order), after a store barrier that every rank must
        reach (:class:`ZeroCollectiveError` after the job's collective
        timeout otherwise). The trees' leaves are views of one gathered
        buffer a slot."""
        assert self.buckets is not None
        try:
            _dist.store_barrier(
                self.group.store, "zero/materialize/%d" % next(_GATHER_SEQ),
                self.dp, _dist._TIMEOUT_S,
                "fastpath.zero.materialize_updater (a "
                "collective: Updater.get_states, Trainer.save_states, an "
                "eager per-parameter update, MXNET_ZERO turned off)",
                rank=self.rank)
        except MXNetError as exc:
            raise ZeroCollectiveError(str(exc)) from exc
        MATERIALIZATIONS.inc()
        out: List[Any] = [None] * len(self.plan.sig)
        for b, positions in enumerate(self.plan.buckets):
            sizes, padded = self.plan.bucket_layout(b)
            full = []
            for j, slot in enumerate(self.buckets[b]):
                if self.replicated_slot(b, j):
                    full.append(slot)
                    continue
                whole = slot.new_empty(padded)
                self.group.all_gather(whole.view(self.dp, -1), slot)
                full.append(whole)
            off = 0
            for pos, n in zip(positions, sizes):
                shape = self.plan.sig[pos][0]
                leaves = [f[off:off + n].view(shape) for f in full]
                out[pos] = _rebuild_state(self.templates[b], iter(leaves))
                off += n
        self.buckets = None
        return out

    def state_handles(self) -> List[ShardedState]:
        return [ShardedState(self, pos)
                for pos in range(len(self.plan.sig))]

    # -- sharded checkpoint I/O ---------------------------------------------
    def shard_export(self):
        """Host copies of this rank's shards, without materializing: one
        batched device-to-host copy of ``1/N`` of the states (the
        replicated slots whole). Returns ``(meta, shard, repl)``: ``meta``
        the layout a restore needs to rebuild the states onto any world
        size (plan signature, buckets, padding, indices, level, the
        states' layouts, the slots' dtypes), ``shard`` and ``repl``
        ``"b{bucket}.s{slot}" -> numpy`` of this rank's sharded slots and
        of the replicated ones. The bytes are counted under transfer path
        ``ckpt.shard``; :data:`MATERIALIZATIONS` does not move."""
        assert self.buckets is not None
        keys, tensors, repl_keys, dtypes = [], [], [], {}
        for b, slots in enumerate(self.buckets):
            for j, slot in enumerate(slots):
                key = "b%d.s%d" % (b, j)
                keys.append(key)
                tensors.append(slot)
                dtypes[key] = str(slot.dtype).replace("torch.", "")
                if self.replicated_slot(b, j):
                    repl_keys.append(key)
        host = fetch_host(tensors) if tensors else []
        telemetry.record_transfer("ckpt.shard", host)
        shard = {k: a for k, a in zip(keys, host) if k not in repl_keys}
        repl = {k: a for k, a in zip(keys, host) if k in repl_keys}
        meta = {
            "dp": self.dp,
            "rank": self.rank,
            "level": self.level,
            "indices": list(self.indices),
            "mp_flags": list(self.mp_flags),
            "sig": tuple((tuple(s), str(d).replace("torch.", ""))
                         for s, d in self.plan.sig),
            "buckets": [tuple(b) for b in self.plan.buckets],
            "pad_to": self.plan.pad_to,
            "templates": list(self.templates),
            "slot_dtypes": dtypes,
            "repl_slots": repl_keys,
            "mesh_shape": {"dp": self.dp},
        }
        return meta, shard, repl

    # -- the step -----------------------------------------------------------
    def expand_scalars(self, ts, lrs, wds):
        """The per-parameter (t, lr, wd) laid over the static layout of
        this rank's shards: one entry a segment, in segment order. The
        JAX package expands them to one element each (its bucket kernel
        runs on flat vectors); the port's kernel takes one scalar a tensor
        (``torch._foreach_*``), and a segment is a tensor."""
        out_t, out_lr, out_wd = [], [], []
        for segs in self._segments:
            for pos, *_ in segs:
                out_t.append(ts[pos])
                out_lr.append(lrs[pos])
                out_wd.append(wds[pos])
        return out_t, out_lr, out_wd

    def views(self, grads, weights):
        """The kernel's operands over this rank's segments: the weights'
        and gradients' views, the state trees of shard views, and whether
        each is a master pair. Raises (before anything moved) where a
        parameter is not one contiguous block."""
        def grad_of(_b, pos, lo, hi, _off):
            return _flat(grads[pos])[lo:hi]

        with torch.no_grad():
            return self._views(grad_of, weights)

    def _views(self, grad_of, weights):
        """The kernel's operands over this rank's segments, each segment's
        gradient ``grad_of(bucket, position, lo, hi, shard offset)``."""
        ws, gs, sts, mps = [], [], [], []
        for b, segs in enumerate(self._segments):
            slots = self.buckets[b]
            for pos, lo, hi, off, boff in segs:
                ws.append(_flat(weights[pos])[lo:hi])
                gs.append(grad_of(b, pos, lo, hi, off))
                leaves = [slot[boff + lo:boff + hi]
                          if self.replicated_slot(b, j)
                          else slot[off:off + hi - lo]
                          for j, slot in enumerate(slots)]
                sts.append(_rebuild_state(self.templates[b], iter(leaves)))
                mps.append(self.bucket_mp[b])
        return ws, gs, sts, mps

    def step(self, optimizer, operands, weights, ts, lrs, wds):
        """One sharded update: the fused apply's kernel over this rank's
        segments (``operands`` from :meth:`views`), then the weights'
        all-gather into every parameter, in place."""
        from .fused import tree_kernel

        ws, gs, sts, mps = operands
        tv, lrv, wdv = self.expand_scalars(ts, lrs, wds)
        OPT_DISPATCHES.inc(path="zero")
        tree_kernel(optimizer, ws, gs, sts, mps, tv, lrv, wdv)
        self.gather_weights(weights)

    def step_buffers(self):
        """The in-step update's gradient buffers (:meth:`traced_update`):
        a padded flat bucket and this rank's shard of it a bucket, made
        once, so a captured step holds their addresses; the padding stays
        zero."""
        flats, shards = [], []
        for b in range(len(self.plan.buckets)):
            dtype = self.bucket_dtypes[b]
            flats.append(torch.zeros(self.plan.bucket_layout(b)[1],
                                     dtype=dtype, device=self.device))
            shards.append(torch.empty(self.shard_len(b), dtype=dtype,
                                      device=self.device))
        return flats, shards

    def traced_update(self, optimizer, span, weights, grads, bufs, ts, lrs,
                      wds):
        """The sharded update inside a step function (the JAX package's
        ``traced_update``, ``mxnet_tpu/fastpath/zero.py:507-530``): each
        bucket's packed gradients averaged over the ranks by one
        reduce-scatter into this rank's shard, the fused kernel on this
        rank's segments only (views of the weights, of the gradient
        shard and of the state shards), then one all-gather a bucket of
        the updated weights into every parameter in place
        (:meth:`gather_weights`). Every collective goes through the
        step's ``span`` (a captured step records them under NCCL).
        ``bufs`` is :meth:`step_buffers`'; ``ts``/``lrs``/``wds`` one
        value (or 0-d tensor) a parameter."""
        from .fused import tree_kernel

        flats, shards = bufs
        with torch.no_grad():
            for b, positions in enumerate(self.plan.buckets):
                used = sum(self.plan.bucket_layout(b)[0])
                torch.cat([grads[p].reshape(-1) for p in positions],
                          out=flats[b][:used])
                span.reduce_scatter(shards[b], flats[b], "avg")
            ws, gs, sts, mps = self._views(
                lambda b, _pos, lo, hi, off: shards[b][off:off + hi - lo],
                weights)
        tv, lrv, wdv = self.expand_scalars(ts, lrs, wds)
        tree_kernel(optimizer, ws, gs, sts, mps, tv, lrv, wdv)
        self.gather_weights(weights, span)

    def gather_weights(self, weights, comm=None) -> None:
        """Each bucket's updated shard from every rank into every
        parameter, in place: one all-gather a bucket into a flat buffer
        (through ``comm``, a step's span, or the plane's group), then one
        ``torch._foreach_copy_`` into the parameters. A level-1 master
        bucket gathers the float32 masters instead (in place in their
        replicated slot), and the weights are cast from them, as the
        kernel casts them."""
        comm = comm or self.group
        with torch.no_grad():
            for b, positions in enumerate(self.plan.buckets):
                sizes, padded = self.plan.bucket_layout(b)
                s = self.shard_len(b)
                own = slice(self.rank * s, (self.rank + 1) * s)
                if self.replicated_slot(b, 0):
                    full = self.buckets[b][0]
                    comm.all_gather(full.view(self.dp, -1), full[own])
                else:
                    full = weights[positions[0]].new_empty(padded)
                    mine = full[own]
                    parts = [weights[pos].view(-1)[lo:hi]
                             for pos, lo, hi, _o, _b in self._segments[b]]
                    used = sum(p.numel() for p in parts)
                    if parts:
                        torch.cat(parts, out=mine[:used])
                    if used < s:
                        mine[used:].zero_()
                    comm.all_gather(full.view(self.dp, -1), mine)
                dst, src, off = [], [], 0
                for pos, n in zip(positions, sizes):
                    dst.append(weights[pos].view(-1))
                    src.append(full[off:off + n])
                    off += n
                torch._foreach_copy_(dst, src)

    def gather_bytes(self) -> int:
        """Bytes a step's all-gathers deliver to this rank (every bucket's
        padded length, in the gathered dtype)."""
        total = 0
        for b in range(len(self.plan.buckets)):
            _, padded = self.plan.bucket_layout(b)
            dtype = torch.float32 if self.replicated_slot(b, 0) \
                else self.bucket_dtypes[b]
            total += padded * torch.empty((), dtype=dtype).element_size()
        return total


# ---------------------------------------------------------------------------
# updater plumbing (the eager fused path behind apply_updater)
# ---------------------------------------------------------------------------


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t`` as one flat view; raises where it is not one contiguous
    block (before anything moved)."""
    if not t.is_contiguous():
        raise MXNetError("a parameter or gradient is not contiguous")
    return t.view(-1)


def plane_of(updater) -> Optional[ZeroPlane]:
    return getattr(updater, "_zero_plane", None)


def materialize_updater(updater) -> None:
    """Bring every sharded state in ``updater.states`` back to the plain
    per-parameter layout and detach the plane; nothing without a plane. A
    collective when a plane is attached (see the module's docstring):
    every rank calls it together, and a rank alone raises
    :class:`ZeroCollectiveError` after the job's collective timeout with
    the plane still attached."""
    plane = plane_of(updater)
    if plane is None:
        return
    if plane.buckets is None:
        updater._zero_plane = None
        return
    states = plane.materialize()
    updater._zero_plane = None
    for pos, idx in enumerate(plane.indices):
        if is_sharded(updater.states.get(idx)):
            updater.states[idx] = states[pos]


def ensure_materialized(updater, indices: Sequence[Any]) -> List[Any]:
    """``updater.states[i]`` for ``indices`` with any :class:`ShardedState`
    resolved to its plain state first: the guard of the replicated fused
    apply while a plane is attached (``MXNET_ZERO`` turned off mid-run).
    A collective where it materializes."""
    if any(is_sharded(updater.states.get(i)) for i in indices):
        materialize_updater(updater)
    return [updater.states.get(i) for i in indices]


def acquire_plane(updater, optimizer, group, lv: int, indices,
                  weights) -> ZeroPlane:
    """Attach (or keep) the updater's :class:`ZeroPlane` for exactly this
    layout: the same indices, shapes, dtypes, level and ranks, and every
    state still its handle. Anything else (a skipped stale gradient, a
    restore, a flipped knob) materializes and adopts again. On a new
    plane the states are moved to the master layout as ``apply_updater``
    would, packed and sharded (locally: every rank holds them whole), and
    the handles installed in ``updater.states``. ``weights`` are
    tensors."""
    indices = list(indices)
    plane = plane_of(updater)
    if plane is not None:
        states = [updater.states.get(i) for i in indices]
        reuse = (plane.buckets is not None
                 and lv == plane.level
                 and tuple(indices) == plane.indices
                 and plane.dp == group.world
                 and tuple((tuple(w.shape), w.dtype) for w in weights)
                 == plane.plan.sig
                 and all(is_sharded(s) and s.plane is plane and s.pos == k
                         for k, s in enumerate(states)))
        if not reuse:
            materialize_updater(updater)
            plane = None
    if plane is None:
        from .fused import _is_mp_state

        states = []
        for i, w in zip(indices, weights):
            if i not in updater.states:
                updater.states[i] = optimizer.create_state_multi_precision(
                    i, w)
            else:
                updater.states[i] = ensure_mp_state(optimizer, i, w,
                                                    updater.states[i])
            states.append(updater.states[i])
        mp_flags = [_is_mp_state(optimizer, i, w, s)
                    for i, w, s in zip(indices, weights, states)]
        plane = ZeroPlane(optimizer, group, lv, indices, weights, states,
                          mp_flags)
        plane.adopt(states)
        updater._zero_plane = plane
        for pos, i in enumerate(indices):
            updater.states[i] = ShardedState(plane, pos)
    return plane


def apply(updater, triples, positions: int = 1) -> bool:
    """Run one fused update through the sharded plane; ``False`` (after
    counting the reason) where the replicated ``fused_apply`` should run
    instead. The host prologue is ``fused_apply``'s, in its order, so the
    sharded step consumes the same scalars; it runs only after the
    plane and the kernel's views are in place, so a decline never moves
    a counter."""
    optimizer = updater.optimizer
    if getattr(updater, "_zero_opt_out", None):
        note_fallback(str(updater._zero_opt_out))
        materialize_updater(updater)
        return False
    if positions > 1:
        note_fallback("multi-position eager update")
        materialize_updater(updater)
        return False
    reason = eligible_reason(optimizer, _ndev())
    if reason is not None:
        note_fallback(reason)
        materialize_updater(updater)
        return False
    indices = [t[0] for t in triples]
    grads = [getattr(t[1], "_data", t[1]) for t in triples]
    weights = [getattr(t[2], "_data", t[2]) for t in triples]
    try:
        plane = acquire_plane(updater, optimizer, _dist.group(), level(),
                              indices, weights)
        operands = plane.views(grads, weights)
    except ZeroCollectiveError:
        raise
    except Exception as exc:  # noqa: BLE001 - never-a-crash: a layout that
        # cannot be built falls back before the prologue moves a counter
        note_fallback("adopt: %s" % type(exc).__name__)
        materialize_updater(updater)
        return False
    ts, lrs, wds = [], [], []
    for i in indices:
        optimizer._update_count(i)
        lr, wd, _ex = optimizer._host_scalars(i)
        ts.append(optimizer._index_update_count[i])
        lrs.append(lr)
        wds.append(wd)
    plane.step(optimizer, operands, weights, ts, lrs, wds)
    return True


def states_from_export(meta, slot_arrays) -> List[Any]:
    """Plain per-parameter state trees from a :meth:`ZeroPlane.
    shard_export`: the restore half of the sharded checkpoint.
    ``slot_arrays`` maps ``"b{b}.s{j}"`` to the whole flat slot (the
    ranks' pieces concatenated in rank order; the padding tail is never
    read). The walk is the static layout ``bucketing.Plan`` packs with,
    so the round trip is exact whatever world size wrote the checkpoint
    or restores it. Returns CPU tensors of the saved dtypes, in plan
    order (parallel to ``meta["indices"]``)."""
    sig = tuple((tuple(s), str(d)) for s, d in meta["sig"])
    plan = bucketing.Plan(sig, [tuple(b) for b in meta["buckets"]], [],
                          pad_to=int(meta["pad_to"]))
    dtypes = meta.get("slot_dtypes") or {}
    out: List[Any] = [None] * len(sig)
    for b, positions in enumerate(plan.buckets):
        sizes, _padded = plan.bucket_layout(b)
        template = meta["templates"][b]
        slots = []
        for j in range(len(_state_leaves(template))):
            key = "b%d.s%d" % (b, j)
            flat = torch.from_numpy(np.array(
                slot_arrays[key]).reshape(-1))
            if flat.shape[0] < sum(sizes):
                raise ValueError(
                    "sharded checkpoint slot %s is short: %d < %d"
                    % (key, flat.shape[0], sum(sizes)))
            if key in dtypes:
                flat = flat.to(getattr(torch, dtypes[key]))
            slots.append(flat)
        off = 0
        for pos, size in zip(positions, sizes):
            shape = sig[pos][0]
            leaves = [s[off:off + size].reshape(shape).clone()
                      for s in slots]
            out[pos] = _rebuild_state(template, iter(leaves))
            off += size
    return out


def state_bytes_on(device, updater) -> int:
    """Optimizer-state bytes resident on ``device`` for this updater:
    plain states and this rank's plane shards alike (padding included)."""
    device = torch.device(device)
    seen = set()
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor) and t.device.type == device.type \
                and device.index in (None, t.device.index):
            total += t.numel() * t.element_size()

    for st in updater.states.values():
        if is_sharded(st):
            plane = st.plane
            if id(plane) in seen or plane.buckets is None:
                continue
            seen.add(id(plane))
            for slots in plane.buckets:
                for t in slots:
                    add(t)
        else:
            for t in _state_leaves(st):
                add(t)
    return total
