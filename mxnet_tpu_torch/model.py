"""Model helpers: the port of ``mxnet_tpu/model.py``'s
``_create_kvstore``, the one piece the Module path calls.

With one device and a kvstore name without ``dist`` there is no kvstore,
and the module updates its parameters itself (``mxnet_tpu/model.py:
25-45``). Every other case needs the kvstore, which is not ported yet,
and raises. Checkpointing is not ported yet either.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = []


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: ``(None, False)`` for one device
    without a distributed store."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return None, False
    raise MXNetError("kvstore %r over %d devices is not ported yet"
                     % (kvstore, num_device))
