"""Contrib samplers: the port of
``mxnet_tpu/gluon/contrib/data/sampler.py``."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Indices ``i, i + interval, i + 2 * interval, ...`` for each start
    ``i`` in ``[0, interval)`` (only ``i = 0`` without ``rollover``): the
    order in which truncated-BPTT language models read a corpus, so that
    consecutive batches are contiguous in it."""

    def __init__(self, length, interval, rollover=True):
        assert 0 < interval <= length, (
            "interval (%d) must be in (0, %d]" % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval) if self._rollover else [0]:
            yield from range(i, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
