"""Serving-policy error types, ported from ``mxnet_tpu/serving/batcher.py``.

Only the error classes: the decode engine raises and answers futures
with them. The request-granularity ``Server`` waits for a later slice.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "QueueFullError", "RequestTimeoutError",
           "ServerClosedError", "EngineUnavailableError"]


class ServingError(MXNetError):
    """Base class of serving-policy failures."""


class QueueFullError(ServingError):
    """Load shed: the bounded submit queue is at capacity."""


class RequestTimeoutError(ServingError):
    """The request's deadline expired while it waited in the queue."""


class ServerClosedError(ServingError):
    """Submitted to (or still queued in) a closed server."""


class EngineUnavailableError(ServingError):
    """Every engine's circuit breaker is open: the request is shed at the
    engine layer (explicit fast failure instead of queueing work no engine
    will run)."""
