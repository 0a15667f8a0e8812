"""Fixed size ladders, ported from ``mxnet_tpu/serving/buckets.py``.

The decode engine pads each prompt up to the next rung of its prefill
ladder (:func:`select_bucket`), so prefill shapes come from a small fixed
set. On the card that keeps the set of shapes the kernels and cuBLAS see
small and stable (the same shapes the JAX package compiles once each).
"""
from __future__ import annotations

from typing import Sequence, Tuple

from ..base import MXNetError, get_env

__all__ = ["bucket_ladder", "select_bucket"]

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
