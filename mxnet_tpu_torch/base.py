"""Base types, env config and device plumbing for mxnet_tpu_torch.

The PyTorch/CUDA counterpart of ``mxnet_tpu/base.py``: the same
:class:`MXNetError`, the same ``MXNET_*`` knob reader, and a
:func:`fetch_host` that is one batched device->host copy (pinned, one
synchronisation). Device choice is explicit: :func:`resolve_device`
sends everything to the card unless the caller asks for the CPU, and
refuses to fall back quietly. The dtype
helpers (:func:`np_dtype`, :func:`dtype_name`, :func:`torch_dtype`) and
the attribute parsers (:func:`parser_for`) are the port's own copies of
the JAX package's, for the op registry.
"""
from __future__ import annotations

import ast
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["MXNetError", "get_env", "fetch_host", "resolve_device",
           "np_dtype", "dtype_name", "torch_dtype", "parser_for",
           "flatten_list", "regroup_list", "string_types", "numeric_types",
           "integer_types", "DTYPE_NAMES"]

# the reference's python/mxnet/base.py type tuples, as the JAX package has
string_types = (str,)
numeric_types = (float, int, np.generic)
integer_types = (int, np.integer)


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
    """ONE batched device->host copy for a sequence of tensors: each device
    tensor is copied without blocking into its slice of one pinned host
    buffer a dtype, and one synchronisation waits for all of them; host
    tensors are copied on the host. Returns numpy arrays in the input
    order; a bfloat16 tensor comes back as float32 (numpy has no
    bfloat16). Runs under the resilience retry policy at the chaos site
    ``transfer.fetch_host``, like the JAX package's, and every transfer
    is accounted in ``mxnet_host_transfer_bytes_total{path="fetch_host"}``
    (host tensors included, as there)."""
    from . import resilience, telemetry

    tensors = list(tensors)

    def attempt():
        resilience.chaos.maybe_fail("transfer.fetch_host")
        return _copy_to_host(tensors)

    out = resilience.call("transfer.fetch_host", attempt)
    telemetry.record_transfer("fetch_host", out)
    return out


def _copy_to_host(tensors) -> list:
    out: list = [None] * len(tensors)
    staged: Dict[torch.dtype, list] = {}
    devices = set()
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cuda":
            staged.setdefault(t.dtype, []).append((i, t))
            devices.add(t.device)
        else:
            out[i] = t.numpy().copy()
    for dtype, items in staged.items():
        buf = torch.empty(sum(t.numel() for _, t in items), dtype=dtype,
                          pin_memory=True)
        off = 0
        for i, t in items:
            dst = buf[off:off + t.numel()].view(t.shape)
            dst.copy_(t, non_blocking=True)
            out[i] = dst.numpy()
            off += t.numel()
    for dev in devices:  # the copies went on each device's current stream
        torch.cuda.current_stream(dev).synchronize()
    return out


# ---------------------------------------------------------------------------
# dtype plumbing: the user-visible names of the JAX package. numpy has no
# bfloat16, so that one name maps to torch.bfloat16.
# ---------------------------------------------------------------------------

DTYPE_NP = {
    "float32": np.float32,
    "float64": np.float64,
    "float16": np.float16,
    "bfloat16": torch.bfloat16,
    "uint8": np.uint8,
    "int8": np.int8,
    "int32": np.int32,
    "int64": np.int64,
    "bool": np.bool_,
}
DTYPE_NAMES = {np.dtype(v).name if n != "bfloat16" else "bfloat16": n
               for n, v in DTYPE_NP.items()}

_TORCH_OF_NP = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}
_NP_OF_TORCH = {v: k for k, v in _TORCH_OF_NP.items()}


def np_dtype(dtype) -> Any:
    """Normalize a user dtype spec (name / numpy dtype / torch dtype) to a
    numpy dtype (``torch.bfloat16`` for bfloat16, which numpy lacks)."""
    if dtype is None:
        return np.float32
    if isinstance(dtype, str):
        if dtype not in DTYPE_NP:
            raise MXNetError("unknown dtype %r" % (dtype,))
        return DTYPE_NP[dtype]
    if isinstance(dtype, torch.dtype):
        return torch.bfloat16 if dtype == torch.bfloat16 \
            else _NP_OF_TORCH[dtype].type
    return dtype


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a user dtype spec (name, numpy or torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    d = np_dtype(dtype)
    if d is torch.bfloat16:
        return d
    try:
        return _TORCH_OF_NP[np.dtype(d)]
    except KeyError:
        raise MXNetError("unsupported dtype %r" % (dtype,))


def dtype_name(dtype) -> str:
    """Canonical string name for a dtype."""
    if isinstance(dtype, torch.dtype):
        return "bfloat16" if dtype == torch.bfloat16 \
            else np.dtype(_NP_OF_TORCH[dtype]).name
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


# ---------------------------------------------------------------------------
# Attribute (string) parsing: typed op attributes from strings or values,
# as the JAX package parses them.
# ---------------------------------------------------------------------------

def parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, np.integer)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0", "none"):
        return False
    raise MXNetError("cannot parse bool from %r" % (v,))


def parse_int(v) -> int:
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return int(v)
    return int(float(str(v)))


def parse_float(v) -> float:
    return float(v)


def parse_shape(v) -> tuple:
    """Parse a shape/tuple attr: accepts (2,2), [2,2], "(2, 2)", "2", 2."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    s = str(v).strip()
    if s in ("None", ""):
        return None
    val = ast.literal_eval(s)
    if isinstance(val, (int, float)):
        return (int(val),)
    return tuple(int(x) for x in val)


def parse_str(v) -> str:
    return str(v)


def parse_dtype(v):
    if v is None or (isinstance(v, str) and v in ("None", "")):
        return None
    return np_dtype(v if isinstance(v, str) else dtype_name(v))


_PARSERS = {
    bool: parse_bool,
    int: parse_int,
    float: parse_float,
    tuple: parse_shape,
    str: parse_str,
    "dtype": parse_dtype,
}


def parser_for(typ) -> Callable:
    return _PARSERS.get(typ, typ if callable(typ) else parse_str)


def flatten_list(args):
    """Nested lists/tuples as ``(flat list, format tree)``: format 0 marks
    one leaf, a list recurses (``mxnet_tpu/base.py:243``; the control-flow
    front ends share it)."""
    if not isinstance(args, (list, tuple)):
        return [args], 0
    flat, fmts = [], []
    for a in args:
        f, fmt = flatten_list(a)
        flat.extend(f)
        fmts.append(fmt)
    return flat, fmts


def regroup_list(flat, fmt):
    """The inverse of :func:`flatten_list`: ``(tree, what is left of
    flat)``."""
    if isinstance(fmt, int):
        return flat[0], flat[1:]
    out = []
    for f in fmt:
        res, flat = regroup_list(flat, f)
        out.append(res)
    return out, flat
