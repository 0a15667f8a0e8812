"""The job's process group: rendezvous, topology and the staged
collectives under :mod:`mxnet_tpu_torch.kvstore`, :mod:`.parallel`,
:mod:`.sequence_parallel` and the heartbeat of :mod:`.elastic`.

:func:`init` joins the job over a ``torch.distributed.TCPStore`` at the
coordinator address (rank 0 serves it; the other ranks connect), under a
prefix of the launcher's job token, so two jobs that ever met on one port
never read each other's keys. Each rank publishes its host name, its card
count and its ``LOCAL_RANK``, and every rank then derives the same plan
from the same table:

* **NCCL** where every rank has a card of its own (no host runs more
  ranks than it has cards). The group is ``cpu:gloo,cuda:nccl``, so a
  tensor the caller keeps on the host still reduces, through gloo.
* **gloo** where ranks share a card or a host has none. A card tensor is
  then staged through pinned host memory: copied down, exchanged by gloo
  on the host, copied back up. The bytes moved between card and host are
  counted (``mxnet_dist_staged_bytes_total{op}`` and
  :attr:`Group.staged_bytes`); under NCCL they stay 0.

A rank's device is ``cuda:(LOCAL_RANK % cards)`` where its host has a
card, else the CPU (the table gives ``LOCAL_RANK`` where the launcher did
not plant it: the rank's position among the ranks of its host). A failed
NCCL init raises: the group is never made again on gloo.

One job a process: :func:`group` is None outside a job.

A step that spans the job's ranks (``parallel.TrainStep``,
``InferStep``, ``trainplane.TrainPlane``) runs its function inside a
:class:`Span` (:func:`spanning`), which issues the step's collectives
and counts them; BatchNorm reads :func:`current_span` to take the global
batch's statistics. Under NCCL a span's collectives are issued on the
current stream without a ``Work`` to wait on, so a CUDA graph captures
them; under gloo they are staged as above, and the step is never
captured.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import json
import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .base import MXNetError
from .telemetry import registry as _registry

__all__ = ["Group", "Span", "init", "group", "world_size", "rank",
           "connect_store", "store_barrier", "spanning", "current_span",
           "STAGED_BYTES"]

#: bytes a collective moved between a card and pinned host memory (gloo
#: with card tensors), by collective
STAGED_BYTES = _registry.counter(
    "mxnet_dist_staged_bytes_total",
    "bytes staged through pinned host memory by the job's collectives",
    labels=("op",))

_TIMEOUT_S = 300.0
_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}
_GROUP: Optional["Group"] = None
_SPAN: Optional["Span"] = None


def plan_topology(infos: Sequence[dict]):
    """``(backend, [device string a rank])`` from every rank's published
    ``{"host", "cards", "local_rank"}``: NCCL where no host runs more ranks
    than it has cards (and every host has one), else gloo."""
    per_host = {}
    local = []
    for info in infos:
        seen = per_host.setdefault(info["host"], [])
        lr = info.get("local_rank")
        local.append(len(seen) if lr is None else int(lr))
        seen.append(info)
    nccl = all(info["cards"] > 0 and len(per_host[info["host"]]) <=
               info["cards"] for info in infos)
    devices = ["cuda:%d" % (lr % info["cards"]) if info["cards"] else "cpu"
               for info, lr in zip(infos, local)]
    return ("nccl" if nccl else "gloo"), devices


class Group(object):
    """This process's place in the job: ``rank``, ``world``, ``backend``
    (``"nccl"`` or ``"gloo"``), ``device`` (its ``torch.device``),
    ``devices`` (every rank's, as strings), the ``store`` it rendezvoused
    on and the coordinator's ``(host, port, token)``."""

    def __init__(self, store, address, rank, world, backend, devices):
        self.store = store
        self.address = address
        self.rank = rank
        self.world = world
        self.backend = backend
        self.devices = list(devices)
        self.device = torch.device(self.devices[rank])
        self.staged_bytes = 0
        self._pinned = {}

    # -- staging --------------------------------------------------------
    def _stages(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _host(self, t: torch.Tensor, slot) -> torch.Tensor:
        """A pinned host buffer of ``t``'s shape and dtype, kept per
        ``slot`` (and grown) across calls."""
        key = (t.dtype, slot)
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < t.numel():
            buf = torch.empty(max(t.numel(), 1), dtype=t.dtype,
                              pin_memory=True)
            self._pinned[key] = buf
        return buf[:t.numel()].view(t.shape)

    def _count(self, op: str, nbytes: int) -> None:
        self.staged_bytes += nbytes
        STAGED_BYTES.inc(nbytes, op=op)

    def _down(self, op, tensors, slot0=0, copy=True):
        """Host views for ``tensors``: pinned copies of the card tensors
        (``copy=False``: buffers only, for receives), the host tensors
        themselves; one synchronisation before gloo reads them."""
        out, staged = [], False
        for i, t in enumerate(tensors):
            if self._stages(t):
                h = self._host(t, (op, slot0 + i))
                if copy:
                    h.copy_(t, non_blocking=True)
                    self._count(op, t.numel() * t.element_size())
                out.append(h)
                staged = True
            else:
                out.append(t)
        if staged:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _up(self, op, tensors, hosts):
        """Copy received host buffers back into their card tensors. The
        next staged call synchronises before gloo writes a buffer again."""
        for t, h in zip(tensors, hosts):
            if h is not t:
                t.copy_(h, non_blocking=True)
                self._count(op, t.numel() * t.element_size())

    # -- collectives ----------------------------------------------------
    def all_reduce(self, tensors: List[torch.Tensor], op: str = "sum"):
        """Reduce each tensor across the job in place (``sum``, ``max`` or
        ``min``): every collective is started, then all are waited on."""
        rop = getattr(dist.ReduceOp, _OPS[op])
        hosts = self._down("all_reduce", tensors)
        works = [dist.all_reduce(h, op=rop, async_op=True) for h in hosts]
        for w in works:
            w.wait()
        self._up("all_reduce", tensors, hosts)
        return tensors

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor):
        """``out[j]`` = rank ``j``'s ``inp[rank]`` (dim 0 split evenly)."""
        h_in, = self._down("all_to_all", [inp])
        h_out, = self._down("all_to_all", [out], slot0=1, copy=False)
        dist.all_to_all_single(h_out, h_in)
        self._up("all_to_all", [out], [h_out])
        return out

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor):
        """``out[j]`` = rank ``j``'s ``inp`` (``out``: world x inp,
        contiguous). One collective into ``out``'s own memory (no copy a
        rank): a flat bucket gathers as ``out.view(world, -1)``, and
        ``inp`` may be this rank's row of ``out`` itself."""
        h_in, = self._down("all_gather", [inp])
        h_out, = self._down("all_gather", [out], slot0=1, copy=False)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(h_out.view(-1), h_in.reshape(-1))
        self._up("all_gather", [out], [h_out])
        return out

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor):
        """``out`` = this rank's ``1/world`` block of the sum of every
        rank's ``inp`` (contiguous, ``world`` x ``out``), one
        ``reduce_scatter_tensor``."""
        h_in, = self._down("reduce_scatter", [inp])
        h_out, = self._down("reduce_scatter", [out], slot0=1, copy=False)
        dist.reduce_scatter_tensor(h_out.reshape(-1), h_in.reshape(-1))
        self._up("reduce_scatter", [out], [h_out])
        return out

    def broadcast(self, t: torch.Tensor, src: int):
        """Rank ``src``'s ``t`` into every rank's ``t``, in place."""
        h, = self._down("broadcast", [t], copy=self.rank == src)
        dist.broadcast(h, src)
        if self.rank != src:
            self._up("broadcast", [t], [h])
        return t

    def exchange(self, send: List[torch.Tensor], dst: int,
                 recv: List[torch.Tensor], src: int):
        """Send ``send`` to rank ``dst`` while receiving ``recv`` from rank
        ``src`` (one ``batch_isend_irecv``); ``recv`` is filled in place."""
        h_send = self._down("exchange", send)
        h_recv = self._down("exchange", recv, slot0=len(send), copy=False)
        ops = [dist.P2POp(dist.isend, t, dst) for t in h_send] + \
              [dist.P2POp(dist.irecv, t, src) for t in h_recv]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        self._up("exchange", recv, h_recv)
        return recv

    def barrier(self):
        """Every rank's queued device work done, then a rendezvous (a
        one-element reduce on the rank's device, which every backend
        takes)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.all_reduce([torch.zeros(1, device=self.device)])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Span(object):
    """The job's group as a step that spans its ranks sees it: ``world``,
    ``backend``, whether the step may be captured (``captured``: NCCL on
    a card), and ``collectives``, the count issued through it so far."""

    def __init__(self, grp: Group):
        self.group = grp
        self.world = grp.world
        self.backend = grp.backend
        self.captured = grp.backend == "nccl" and grp.device.type == "cuda"
        self.collectives = 0

    def all_reduce(self, tensors: List[torch.Tensor], op: str = "sum"):
        """Reduce each tensor across the job in place (``sum`` or ``avg``,
        the sum divided by the world size). Under NCCL one blocking
        collective a tensor on the current stream, with no ``Work`` to
        query: a capture records it (``avg`` is NCCL's own, which over
        one rank runs NCCL's one-rank kernel where ``sum`` in place runs
        nothing). Under gloo ``avg`` is the sum, then the division."""
        self.collectives += len(tensors)
        if self.backend != "nccl":
            self.group.all_reduce(tensors, "sum")
            if op == "avg":
                for t in tensors:
                    t.div_(self.world)
            return tensors
        rop = dist.ReduceOp.AVG if op == "avg" else \
            getattr(dist.ReduceOp, _OPS[op])
        for t in tensors:
            dist.all_reduce(t, op=rop)
        return tensors

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor):
        """``out[j]`` = rank ``j``'s ``inp`` (:meth:`Group.all_gather`)."""
        self.collectives += 1
        return self.group.all_gather(out, inp)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor,
                       op: str = "sum"):
        """``out`` = this rank's block of the ranks' ``inp`` reduced
        (``sum``, or ``avg``: the sum over the world size). Under NCCL one
        ``reduce_scatter_tensor`` on the current stream, which a capture
        records (``avg`` NCCL's own); under gloo
        :meth:`Group.reduce_scatter` staged, then the division."""
        self.collectives += 1
        if self.backend != "nccl":
            self.group.reduce_scatter(out, inp)
            if op == "avg":
                out.div_(self.world)
            return out
        dist.reduce_scatter_tensor(
            out.reshape(-1), inp.reshape(-1),
            op=dist.ReduceOp.AVG if op == "avg" else dist.ReduceOp.SUM)
        return out


@contextlib.contextmanager
def spanning(span: Optional[Span]):
    """Make ``span`` the current one for the body (None: no change)."""
    global _SPAN
    if span is None:
        yield
        return
    saved, _SPAN = _SPAN, span
    try:
        yield
    finally:
        _SPAN = saved


def current_span() -> Optional[Span]:
    """The span of the step running now, or None. Process-wide, not a
    thread's: a backward's recompute on autograd's device thread sees the
    step's span too."""
    return _SPAN


def group() -> Optional[Group]:
    return _GROUP


def connect_store(timeout: float = 30.0):
    """A connection of this thread's own to the job's store (the prefix
    of the job's token), for threads beside the main one (the heartbeat,
    the checkpoint writer): a store client is not used from two threads
    at once."""
    host, port, token = _GROUP.address
    return dist.PrefixStore("mxtpu/%s/" % (token or "job"), dist.TCPStore(
        host, port, is_master=False, wait_for_workers=False,
        timeout=datetime.timedelta(seconds=timeout)))


def store_barrier(store, key: str, world: int, timeout: float, what: str,
                  rank: int = 0, wait_all: bool = True):
    """Every rank of ``world`` adds one to ``key``; the rank that makes the
    count whole sets ``key/all``. With ``wait_all`` every rank then waits
    for that mark, else only ``rank`` 0 does (its peers go on). Through
    the store and not the training group's collectives, so it may run on
    any thread while the main one runs the step's collectives. Raises
    ``MXNetError`` naming ``what`` when the other ranks do not arrive
    within ``timeout`` seconds."""
    if store.add(key, 1) == world:
        store.set(key + "/all", "1")
    if not (wait_all or rank == 0):
        return
    try:
        store.wait([key + "/all"], datetime.timedelta(seconds=timeout))
    except RuntimeError as exc:  # the store's timeout
        raise MXNetError(
            "%s: rank %d waited %.0f s for the other ranks of %d to reach "
            "it; every rank must call it together" % (what, rank, timeout,
                                                      world)) from exc


def world_size() -> int:
    return _GROUP.world if _GROUP is not None else 1


def rank() -> int:
    return _GROUP.rank if _GROUP is not None else 0


def _connect(host: str, port: int, rank: int, world: int):
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    try:
        return dist.TCPStore(host, port, world, is_master=(rank == 0),
                             timeout=timeout, wait_for_workers=False)
    except RuntimeError as exc:
        if rank == 0 and ("EADDRINUSE" in str(exc)
                          or "address already in use" in str(exc).lower()):
            # the launcher reads this word and starts the job again on
            # another port
            raise MXNetError("rendezvous port %d is in use (EADDRINUSE)"
                             % port) from exc
        raise


def init(coordinator: str, world: int, rank: int,
         token: Optional[str] = None) -> Group:
    """Join the job: the store, the topology plan, the process group and
    one rendezvous collective (where a failing NCCL shows)."""
    global _GROUP
    if _GROUP is not None:
        return _GROUP
    if not 0 <= rank < world:
        raise MXNetError("rank %d outside a job of %d" % (rank, world))
    host, _, port = str(coordinator).rpartition(":")
    if not host or not port.isdigit():
        raise MXNetError("coordinator %r is not host:port" % (coordinator,))
    base = _connect(host, int(port), rank, world)
    store = dist.PrefixStore("mxtpu/%s/" % (token or "job"), base)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lr = os.environ.get("LOCAL_RANK")
    store.set("topo/%d" % rank, json.dumps({
        "host": socket.gethostname(), "cards": cards,
        "local_rank": int(lr) if lr is not None else None}))
    keys = ["topo/%d" % r for r in range(world)]
    store.wait(keys, datetime.timedelta(seconds=_TIMEOUT_S))
    infos = [json.loads(store.get(k)) for k in keys]
    backend, devices = plan_topology(infos)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo",
        store=dist.PrefixStore("pg/", store), world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    grp = Group(store, (host, int(port), token), rank, world, backend,
                devices)
    # the first collective: a NCCL that cannot start raises here, inside
    # init_distributed, and nothing retries it on gloo
    grp.barrier()
    _GROUP = grp
    atexit.register(_shutdown)
    return grp


def _shutdown():
    """Destroy the process group before the interpreter exits (its
    communicators and threads go with it, in order)."""
    if dist.is_initialized():
        dist.destroy_process_group()
