"""Gluon utilities, the port of ``mxnet_tpu/gluon/utils.py`` (reference
``python/mxnet/gluon/utils.py``): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``download``, which raises: the
port fetches nothing over the network.

``clip_global_norm`` scales the gradient tensors in place (``mul_``), so
the Trainer and anything holding their address see the scaled values
(the JAX package rebinds each array instead). It reads the norm back to
the host, as the reference does: one synchronisation a call.
"""
from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch

from ..base import MXNetError
from ..ndarray import ndarray as nd_mod
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray along ``batch_axis`` into ``num_slice`` slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    if not even_split:
        step = int(math.ceil(size / num_slice))
        return [data.slice_axis(batch_axis, i * step,
                                min((i + 1) * step, size))
                for i in range(num_slice) if i * step < size]
    n_each = size // num_slice
    return [data.slice_axis(batch_axis, i * n_each, (i + 1) * n_each)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` and put each slice on one context of
    ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = nd_mod.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that the 2-norm of all of them
    together is at most ``max_norm``; returns that norm before scaling (a
    float; an NDArray when ``check_isfinite`` is off)."""
    assert len(arrays) > 0
    with torch.no_grad():
        total = torch.sqrt(sum(torch.sum(torch.square(
            a._data.to(torch.float32))) for a in arrays))
    total_host = float(total)
    if check_isfinite and not math.isfinite(total_host):
        warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                  "results will be undefined."),
                      stacklevel=2)
    scale = max_norm / (total_host + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for arr in arrays:
                arr._data.mul_(scale)
    return total_host if check_isfinite else NDArray(total)


def check_sha1(filename, sha1_hash):
    """Whether the file's sha1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local file for ``url`` when it is there (and matches
    ``sha1_hash``); otherwise raises, since the port downloads nothing."""
    if path is None:
        fname = url.split("/")[-1]
    else:
        path = os.path.expanduser(path)
        fname = os.path.join(path, url.split("/")[-1]) \
            if os.path.isdir(path) else path
    if os.path.exists(fname) and not overwrite and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(
        "download(%r): the port fetches nothing over the network; place "
        "the file at %r" % (url, fname))


def _export_hook_handle():
    """HookHandle lives with Block (block.py) but the reference exposes it
    from gluon.utils; alias for API parity, as the JAX package's."""
    from .block import _HookHandle

    return _HookHandle


HookHandle = _export_hook_handle()
__all__.append("HookHandle")
