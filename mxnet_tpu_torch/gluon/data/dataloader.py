"""DataLoader: the port of ``mxnet_tpu/gluon/data/dataloader.py``.

Where samples live and where a batch is built: a sample comes from the
dataset where the dataset keeps it (the vision datasets keep theirs on
the host, and their transforms run there, as MXNet's CPU augmenters
do). ``default_batchify_fn`` stacks the samples where they are (numpy
samples become one host array), so a host-kept dataset gives a host
batch. The loader then moves each array of the batch to its target
device in one copy: pinned first when ``pin_memory`` (and the target is
the card), then copied without blocking. There is no copy a sample.

The target is the JAX loader's ``sharding=`` argument: a ``Context``, a
``torch.device`` or device string, or the port's ``parallel.Mesh`` (its
one device); by default the current context when the loader is made
(the card, unless a ``with mx.cpu():`` scope asks for the host; without
a card that raises). An array already on the target passes through.

``num_workers > 0`` builds batches on a pool of that many threads, as
the JAX package's does (``mxnet_tpu/gluon/data/dataloader.py:6-8``),
``prefetch`` batches ahead (``2 * num_workers`` by default), and yields
them in order; each batch built ahead adds one to
``mxnet_io_prefetch_batches_total{pipeline="gluon.DataLoader"}``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import telemetry
from ...context import Context, cpu, current_context
from ...ndarray import ndarray as nd_mod
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

_T_PREFETCH = telemetry.counter(
    "mxnet_io_prefetch_batches_total",
    "batches prefetched ahead of the consumer",
    labels=("pipeline",))

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays where they are, tuples field
    by field, anything else through numpy into one host NDArray."""
    if isinstance(data[0], NDArray):
        return nd_mod.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return nd_mod.array(data, ctx=cpu(), dtype=data.dtype)


def _target_device(sharding) -> torch.device:
    from ... import parallel
    from ...base import resolve_device

    if sharding is None:
        return current_context().torch_device()
    if isinstance(sharding, Context):
        return sharding.torch_device()
    if isinstance(sharding, parallel.Mesh):
        return sharding.device
    return resolve_device(sharding)


class DataLoader(object):
    """Mini-batches of a Dataset on one device (see the module's
    docstring): ``batch_size`` with ``shuffle``, a ``sampler`` or a
    ``batch_sampler``; ``last_batch`` keep, discard or rollover."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 sharding=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._device = _target_device(sharding)

    def _stage(self, batch):
        """Each NDArray of the (nested) batch on the target device, in one
        copy per array."""
        if isinstance(batch, (list, tuple)):
            vals = [self._stage(i) for i in batch]
            return type(batch)(*vals) if hasattr(batch, "_fields") \
                else type(batch)(vals)
        if not isinstance(batch, NDArray) or \
                batch._data.device == self._device:
            return batch
        t = batch._data.detach()
        if self._device.type == "cuda" and t.device.type == "cpu":
            if self._pin_memory:
                t = t.pin_memory()
            return NDArray(t.to(self._device, non_blocking=True))
        return NDArray(t.to(self._device))

    def _batch(self, idx_batch):
        return self._stage(self._batchify_fn(
            [self._dataset[i] for i in idx_batch]))

    def __iter__(self):
        if self._num_workers == 0:
            for idx_batch in self._batch_sampler:
                yield self._batch(idx_batch)
            return
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            it = iter(list(self._batch_sampler))

            def fetch(idx_batch):
                out = self._batch(idx_batch)
                _T_PREFETCH.inc(pipeline="gluon.DataLoader")
                return out

            futures = []
            for _ in range(max(1, self._prefetch)):
                nxt = next(it, None)
                if nxt is None:
                    break
                futures.append(pool.submit(fetch, nxt))
            while futures:
                fut = futures.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(pool.submit(fetch, nxt))
                yield fut.result()

    def __len__(self):
        return len(self._batch_sampler)
