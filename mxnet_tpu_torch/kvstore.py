"""KVStore on one process: the port of ``mxnet_tpu/kvstore.py``'s
``KVStore``, ``KVStoreLocal`` and ``KVStoreDevice`` (reference
``python/mxnet/kvstore.py``: init :116, push :160, pull :240,
row_sparse_pull :314, set_gradient_compression :394, set_optimizer :450,
rank :513, num_workers :526, save/load_optimizer_states :538-554,
_barrier :606, ``create`` :635).

The store owns its tensors: :meth:`KVStore.init` clones the value, and
nothing outside the store holds a store tensor. A push reduces the
copies it is given in list order (``acc = d0 + d1 + ...``, on the first
copy's device, so float32 sums are the JAX package's bits), then applies
the 2-bit compression if set, then either the store's updater (the
optimizer set by :meth:`KVStore.set_optimizer`, run on the store's own
weight in place) or a copy of the reduced value into the store's tensor.
A pull copies the stored value into each out tensor in place, cast to
its dtype, and never rebinds it, so a bound executor or a captured plane
holding that tensor sees the new value. (The JAX store hands its array
to the out buffers instead; its arrays are immutable, the port's are
not, and an in-place update on a shared tensor would write the
executor's weight behind the store's back.)

:meth:`KVStore.pushpull_multi` and :meth:`KVStore.pushpull_update_multi`
are the batched exchanges: one retried aggregate phase over every key,
then the commits, the latter with one fused optimizer apply
(``fastpath.apply_updater``). On one process and one copy a key the
aggregate reduces key by key, as the JAX store does there; the JAX
package's gradient bucketing (``fastpath.bucketing``) applies only with
several copies or processes and waits for the multi-device store.

Counted in ``mxnet_kvstore_ops_total{op}``; the aggregate phases run
under the ``resilience`` retry policy with the chaos sites
``kvstore.push``, ``kvstore.pull`` and ``kvstore.pushpull``. The
``kvstore.*`` spans of the JAX package (``telemetry.span``, ported) are
not wired in yet.

Not ported yet (``create`` raises): ``tpu`` and the ``dist*`` stores,
which aggregate across devices and processes.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import optimizer as opt
from . import resilience
from .base import MXNetError
from .ndarray.ndarray import NDArray
from .optimizer import _tensor
from .resilience import chaos
from .telemetry import registry as _registry

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "create"]

# the exchange's operations by kind (mxnet_tpu/kvstore.py:47-50)
OPS = _registry.counter(
    "mxnet_kvstore_ops_total",
    "kvstore operations by kind",
    labels=("op",))


def _key(k):
    return str(k)


def _updater_key(k):
    """Store keys are strings; the updater's states key integer-named
    parameters by ``int`` (MXNet's updater), so a states file of either
    package has the same keys."""
    return int(k) if k.isdigit() else k


class _TwoBitCompression(object):
    """2-bit quantization with an error-feedback residual per key
    (reference gradient_compression.h:52-134): ``g = grad + residual``
    becomes ``t``, ``-t`` or 0 where ``g >= t``, ``g <= -t`` or neither,
    and ``g - q`` is carried to the next push; in the gradient's dtype."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residuals: Dict[str, Any] = {}

    def compress(self, key, grad):
        residual = self._residuals.get(key)
        g = grad if residual is None else grad + residual
        t = self.threshold
        q = torch.where(g >= t, torch.full_like(g, t),
                        torch.where(g <= -t, torch.full_like(g, -t),
                                    torch.zeros_like(g)))
        self._residuals[key] = g - q
        return q


def _copy_into(dst, src):
    """``src`` into the out array ``dst`` in place, cast to its dtype (a
    value of another shape is rebound, on ``dst``'s device)."""
    held = dst._data
    with torch.no_grad():
        if tuple(held.shape) == tuple(src.shape):
            held.copy_(src)
        else:
            dst._data = src.detach().to(held.device, copy=True)


class KVStore(object):
    """The single-process store (reference kvstore_local.h)."""

    def __init__(self):
        self._store: Dict[str, NDArray] = {}
        self._updater = None
        self._compression = None
        self.type = "local"

    # ------------------------------------------------------------------
    def init(self, key, value):
        """Initialize key(s) with a copy of the value (reference
        kvstore.py:116); a key seen before keeps its value."""
        for k, v in _key_value_pairs(key, value):
            if k in self._store:
                continue
            vv = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = NDArray(_tensor(vv).detach().clone())

    def push(self, key, value, priority=0):
        """Reduce the values into the store (reference kvstore.py:160):
        with an updater the optimizer steps the store's weight with the
        reduced gradient; without one the reduced value replaces the
        stored one (reference kvstore_local.h PushImpl, ``local =
        merged``)."""
        OPS.inc(op="push")
        for k, v in _key_value_pairs(key, value):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            vals = v if isinstance(v, (list, tuple)) else [v]

            # the reduce is pure over the copies, so the retry policy
            # re-runs it; the commit below (residuals, updater, store
            # write) mutates and stays outside the retry
            def attempt(_vals=vals):
                chaos.maybe_fail("kvstore.push")
                return self._reduce([_tensor(x) for x in _vals])

            agg = resilience.call("kvstore.push", attempt)
            if self._compression is not None:
                agg = self._compression.compress(k, agg)
            if self._updater is not None:
                self._updater(_updater_key(k), NDArray(agg), self._store[k])
            else:
                with torch.no_grad():
                    self._store[k]._data.copy_(agg)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the stored values into ``out`` in place (reference
        kvstore.py:240)."""
        if out is None:
            raise MXNetError("pull needs out=")
        OPS.inc(op="pull")
        for k, o in _key_value_pairs(key, out):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            outs = o if isinstance(o, (list, tuple)) else [o]

            def attempt(_k=k):
                chaos.maybe_fail("kvstore.pull")
                return self._store[_k]._data

            data = resilience.call("kvstore.pull", attempt)
            for dst in outs:
                _copy_into(dst, data)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull the rows ``row_ids`` (reference kvstore.py:314). A
        ``RowSparseNDArray`` out takes those rows (sorted, once each) as
        its stored rows; a dense out gets the full-shape value with the
        other rows zero, copied into its own tensor in place (a captured
        plane holds that address), as the JAX package's dense gather."""
        from .ndarray.sparse import RowSparseNDArray

        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull needs out= and row_ids=")
        for k, o in _key_value_pairs(key, out):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            outs = o if isinstance(o, (list, tuple)) else [o]
            rids = row_ids if isinstance(row_ids, (list, tuple)) \
                else [row_ids]
            if len(rids) == 1 and len(outs) > 1:
                rids = rids * len(outs)
            full = self._store[k]._data
            for dst, rid in zip(outs, rids):
                rows = _tensor(rid).to(device=full.device,
                                       dtype=torch.int64)
                if isinstance(dst, RowSparseNDArray):
                    rows = torch.unique(rows.reshape(-1))
                    dev = dst._values.device
                    dst._values = full[rows].to(dev)
                    dst._indices = rows.to(dev)
                    dst._full_shape = tuple(full.shape)
                    dst._dense = None  # built again from the new rows
                    continue
                gathered = torch.zeros_like(full)
                gathered[rows] = full[rows]
                _copy_into(dst, gathered)

    @staticmethod
    def _reduce(datas: List[torch.Tensor]):
        """The sum of one key's copies, in list order, on the first
        copy's device (reference comm.h Reduce)."""
        dev = datas[0].device
        acc = datas[0]
        for d in datas[1:]:
            acc = acc + d.to(dev)
        return acc

    def _aggregate_multi(self, groups: List[List[torch.Tensor]]):
        """The pure aggregate phase of the batched exchanges: every key's
        copies reduced, key by key."""
        return [self._reduce(g) for g in groups]

    def pushpull_multi(self, keys, value_lists, out_lists):
        """push + pull over many keys (the Trainer/Module fast path): one
        retried aggregate phase, then the store and the out arrays take
        each key's sum. Not with an updater or compression (per-key
        transforms): callers check :meth:`_can_fuse_pushpull`."""
        if self._updater is not None or self._compression is not None:
            raise MXNetError("pushpull_multi needs a store without an "
                             "updater and without compression")
        OPS.inc(op="pushpull_multi")
        norm = self._norm_multi(keys, value_lists)

        def attempt():
            chaos.maybe_fail("kvstore.pushpull")
            return self._aggregate_multi([[_tensor(x) for x in v]
                                          for _, v in norm])

        totals = resilience.call("kvstore.pushpull", attempt)
        with torch.no_grad():
            for (kk, _), total in zip(norm, totals):
                self._store[kk]._data.copy_(total)
        for (kk, _), o in zip(norm, out_lists):
            outs = o if isinstance(o, (list, tuple)) else [o]
            for dst in outs:
                _copy_into(dst, self._store[kk]._data)

    def pushpull_update_multi(self, keys, grad_lists, weight_lists):
        """push(grad), the store's update and pull(weight) over many keys:
        one retried aggregate phase, one fused optimizer apply over every
        key's store weight (``fastpath.apply_updater``; the per-key loop
        with ``MXNET_FASTPATH=0`` or an updater that is not an
        ``Updater``), then the weights copied out."""
        if self._updater is None or self._compression is not None:
            raise MXNetError("pushpull_update_multi needs a store with an "
                             "updater and without compression")
        from . import fastpath

        OPS.inc(op="pushpull_update_multi")
        norm = self._norm_multi(keys, grad_lists)

        def attempt():
            chaos.maybe_fail("kvstore.pushpull")
            return self._aggregate_multi([[_tensor(x) for x in v]
                                          for _, v in norm])

        totals = resilience.call("kvstore.pushpull", attempt)
        triples = [(_updater_key(kk), NDArray(total), self._store[kk])
                   for (kk, _), total in zip(norm, totals)]
        opt_obj = getattr(self._updater, "optimizer", None)
        if opt_obj is not None and fastpath.enabled() and \
                fastpath.supports(opt_obj):
            fastpath.apply_updater(self._updater, triples)
        else:
            for idx, g, w in triples:
                self._updater(idx, g, w)
        for (kk, _), o in zip(norm, weight_lists):
            outs = o if isinstance(o, (list, tuple)) else [o]
            for dst in outs:
                _copy_into(dst, self._store[kk]._data)

    def _norm_multi(self, keys, value_lists):
        norm = []
        for k, v in zip(keys, value_lists):
            kk = _key(k)
            if kk not in self._store:
                raise MXNetError("key %s has not been initialized" % kk)
            norm.append((kk, v if isinstance(v, (list, tuple)) else [v]))
        return norm

    # ------------------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` inside the store at every push (reference
        kvstore.py:450)."""
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def _can_fuse_pushpull(self):
        """Whether callers may take :meth:`pushpull_multi`: no updater, no
        compression, and ``MXNET_FASTPATH`` on (the escape hatch brings
        back the per-key exchange)."""
        from . import fastpath

        return (fastpath.enabled() and self._updater is None
                and self._compression is None)

    def set_gradient_compression(self, compression_params):
        """``{"type": "2bit", "threshold": t}`` (reference
        kvstore.py:394); any other type raises."""
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError("unsupported compression type %r" % ctype)
        self._compression = _TwoBitCompression(
            compression_params.get("threshold", 0.5))

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def _device(self):
        for arr in self._store.values():
            return arr._data.device
        return None

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the store's updater states (``Updater.get_states``)."""
        if self._updater is None:
            raise MXNetError("save_optimizer_states: the store has no "
                             "optimizer")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Load a states file (of either package) into the store's
        updater, on the store's device."""
        if self._updater is None:
            raise MXNetError("load_optimizer_states: the store has no "
                             "optimizer")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), device=self._device())

    def _barrier(self):
        pass


class KVStoreLocal(KVStore):
    """``local``: reduce where the first copy lives (reference
    kvstore_local.h:69)."""


class KVStoreDevice(KVStore):
    """``device``: reduce on the device (reference comm.h:451
    CommDevice); the same store on one process."""

    def __init__(self):
        super().__init__()
        self.type = "device"


def _key_value_pairs(key, value):
    """(str key, value) pairs; a value may be a list of copies."""
    if isinstance(key, (list, tuple)):
        if len(key) and isinstance(value, (list, tuple)) \
                and len(key) == len(value):
            return [(_key(k), v) for k, v in zip(key, value)]
        raise MXNetError("mismatched key/value lists")
    if isinstance(value, (list, tuple)) and len(value) and \
            isinstance(value[0], (list, tuple)):
        raise MXNetError("nested value lists need a key list")
    return [(_key(key), value)]


def create(name="local"):
    """The store named ``name`` (reference kvstore.py:635)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu"):
        return KVStoreLocal()
    if name in ("device", "local_allreduce_device", "nccl"):
        return KVStoreDevice()
    if name in ("tpu", "dist", "dist_sync", "dist_async", "dist_device_sync",
                "dist_sync_device"):
        raise MXNetError("kvstore %r is not ported yet: the port's store "
                         "runs on one process" % name)
    raise MXNetError("unknown KVStore type %r" % (name,))
