"""Fixed size ladders, ported from ``mxnet_tpu/serving/buckets.py``.

The decode engine pads each prompt up to the next rung of its prefill
ladder (:func:`select_bucket`), so prefill shapes come from a small fixed
set. On the card that keeps the set of shapes the kernels and cuBLAS see
small and stable (the same shapes the JAX package compiles once each).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..base import MXNetError, get_env

__all__ = ["bucket_ladder", "select_bucket", "pad_to_bucket"]

_DEFAULT_BUCKETS = "1,4,16,32"


def bucket_ladder(buckets=None) -> Tuple[int, ...]:
    """Resolve and validate a size ladder.

    ``buckets`` may be an explicit sequence of ints or ``None`` to read the
    ``MXNET_SERVING_BUCKETS`` knob (comma-separated, default ``1,4,16,32``).
    The ladder is returned sorted ascending; it must be non-empty, positive
    and strictly increasing after sorting.
    """
    if buckets is None:
        raw = get_env("MXNET_SERVING_BUCKETS", _DEFAULT_BUCKETS, str,
                      cache=False)
        try:
            buckets = [int(tok) for tok in str(raw).split(",") if tok.strip()]
        except ValueError:
            raise MXNetError("MXNET_SERVING_BUCKETS must be comma-separated "
                             "ints, got %r" % (raw,))
    ladder = tuple(sorted(int(b) for b in buckets))
    if not ladder or ladder[0] < 1:
        raise MXNetError("serving buckets must be positive ints, got %r"
                         % (buckets,))
    if len(set(ladder)) != len(ladder):
        raise MXNetError("serving buckets contain duplicates: %r" % (buckets,))
    return ladder


def select_bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest rung >= ``n``; the top rung when ``n`` overflows the ladder."""
    if n < 1:
        raise MXNetError("bucket selection needs n >= 1, got %d" % n)
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def pad_to_bucket(rows: List[np.ndarray], bucket: int,
                  dtype=np.float32) -> np.ndarray:
    """Stack per-request arrays and zero-pad the batch axis up to ``bucket``.

    All rows must share one shape. Returns a ``(bucket, *sample_shape)``
    array; rows ``[len(rows):]`` are zeros and their outputs are dropped
    after the batched execution.
    """
    n = len(rows)
    if n == 0 or n > bucket:
        raise MXNetError("pad_to_bucket: %d rows into bucket %d" % (n, bucket))
    out = np.zeros((bucket,) + tuple(rows[0].shape), dtype=dtype)
    for i, row in enumerate(rows):
        out[i] = row
    return out
