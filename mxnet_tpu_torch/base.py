"""Base types, env config and device plumbing for mxnet_tpu_torch.

The PyTorch/CUDA counterpart of ``mxnet_tpu/base.py``: the same
:class:`MXNetError`, the same ``MXNET_*`` knob reader, and a
:func:`fetch_host` that is one batched device->host copy. Device choice
is explicit: :func:`resolve_device` sends everything to the card unless
the caller asks for the CPU, and refuses to fall back quietly.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["MXNetError", "get_env", "fetch_host", "resolve_device"]


class MXNetError(RuntimeError):
    """Error raised by the framework (name kept for API parity with the
    reference's ``python/mxnet/base.py:MXNetError``)."""


_ENV_CACHE: Dict[str, Any] = {}


def get_env(name: str, default: Any = None, typ: Callable = str, *,
            cache: bool = True) -> Any:
    """Read an ``MXNET_*`` environment knob (same names as the JAX
    package). Pass ``cache=False`` for knobs set after import."""
    if cache and name in _ENV_CACHE:
        return _ENV_CACHE[name]
    raw = os.environ.get(name)
    if raw is None:
        val = default
    else:
        try:
            val = typ(raw)
        except (TypeError, ValueError):
            val = default
    if cache:
        _ENV_CACHE[name] = val
    return val


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card by default.

    ``None`` means CUDA and raises :class:`MXNetError` when no card is
    present — the port never quietly runs on the CPU. ``"cpu"`` (what the
    tests pass) is honoured as asked; a CUDA device without a card
    raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available: pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("device %r asked for but no CUDA device is "
                         "available" % (str(device),))
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError("unsupported device %r (cuda or cpu)"
                         % (str(device),))
    return dev


def fetch_host(tensors) -> list:
    """ONE batched device->host copy for a sequence of tensors: same-dtype
    tensors are flattened into one device buffer and copied in a single
    transfer, then split back on the host. Returns numpy arrays in the
    input order. Runs under the resilience retry policy at the chaos site
    ``transfer.fetch_host``, like the JAX package's."""
    from . import resilience

    tensors = list(tensors)

    def attempt():
        resilience.chaos.maybe_fail("transfer.fetch_host")
        return _copy_to_host(tensors)

    return resilience.call("transfer.fetch_host", attempt)


def _copy_to_host(tensors) -> list:
    out: list = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        host = flat.cpu().numpy()
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = np.array(host[off:off + n]).reshape(
                tuple(tensors[i].shape))
            off += n
    return out
