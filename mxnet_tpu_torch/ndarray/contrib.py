"""``mx.nd.contrib``: imperative control flow (``foreach``, ``while_loop``,
``cond``) and every registered ``_contrib_*`` op under its short name
(``nd.contrib.box_nms``, ``nd.contrib.MultiBoxPrior``, ...), the port of
``mxnet_tpu/ndarray/contrib.py`` (reference ``python/mxnet/ndarray/
contrib.py:134,230,398``).

The loops are unrolled in Python as the reference's imperative mode does:
every iteration's ops go on the autograd tape, so gradients reach the
loop state and the closed-over arrays alike. ``while_loop`` and ``cond``
read their predicates back to the host, as the JAX package's do; the
symbolic ops (``sym.contrib``) keep them on the device.
"""
from __future__ import annotations

import sys

from ..base import MXNetError, flatten_list as _flatten, \
    regroup_list as _regroup
from . import ndarray as nd_mod
from .ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _to_scalar(x, type_, what):
    if isinstance(x, NDArray):
        x = x.asnumpy().reshape(-1)[0]
    try:
        return type_(x)
    except (TypeError, ValueError):
        raise MXNetError("Cannot convert %s to python %s"
                         % (what, type_.__name__))


def foreach(body, data, init_states):
    """Unrolled loop over axis 0 (reference ndarray/contrib.py:134):
    ``out, states = body(data_slice, states)``; the outputs stacked on a
    new axis 0, the final states."""
    flat_data, data_fmt = _flatten(data)
    if not flat_data or not all(isinstance(d, NDArray) for d in flat_data):
        raise MXNetError("data should be an NDArray or nested list of them")
    num_iters = flat_data[0].shape[0]
    if num_iters == 0:
        raise MXNetError("foreach: data must have a non-empty leading axis")
    if any(d.shape[0] != num_iters for d in flat_data):
        raise MXNetError(
            "foreach: all data arrays must share the same leading dimension; "
            "got %s" % ([d.shape[0] for d in flat_data],))
    states = init_states
    outputs = []
    out_fmt = 0
    for i in range(num_iters):
        eles, _ = _regroup([d[i] for d in flat_data], data_fmt)
        outs, states = body(eles, states)
        outs, out_fmt = _flatten(outs)
        outputs.append(outs)
    stacked = [nd_mod.stack(*col) for col in zip(*outputs)]
    outputs, _ = _regroup(stacked, out_fmt)
    return outputs, states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Bounded while (reference ndarray/contrib.py:230): ``step_out,
    loop_vars = func(*loop_vars)`` while ``cond(*loop_vars)`` and fewer
    than ``max_iterations`` steps; the outputs stacked into buffers of
    leading size ``max_iterations``, zero past the last step."""
    if max_iterations is None:
        raise MXNetError("max_iterations should be specified")
    max_iterations = _to_scalar(max_iterations, int, "max_iterations")
    flat_vars, var_fmt = _flatten(loop_vars)
    if not flat_vars:
        raise MXNetError("loop_vars should contain at least one element")

    steps = 0
    outputs = []
    out_fmt = None
    cur = list(flat_vars)
    while steps < max_iterations and \
            _to_scalar(cond(*cur), bool, "return value of cond"):
        step_out, new_vars = func(*cur)
        if step_out is None:
            step_out = []
        step_out, out_fmt = _flatten(step_out)
        new_vars, _ = _flatten(new_vars)
        if len(new_vars) != len(cur):
            raise MXNetError(
                "the length of loop_vars should be consistent during the loop")
        cur = list(new_vars)
        outputs.append(step_out)
        steps += 1
        if len(step_out) != len(outputs[0]):
            raise MXNetError("number of elements in step_output should be "
                             "the same in each step")
    stacked = []
    for items in zip(*outputs):
        buf = nd_mod.stack(*items)
        pad = max_iterations - len(items)
        if pad:
            buf = nd_mod.concat(
                buf, nd_mod.zeros((pad,) + tuple(items[0].shape),
                                  dtype=items[0].dtype,
                                  ctx=items[0].context), dim=0)
        stacked.append(buf)
    if out_fmt is not None and outputs:
        outputs, _ = _regroup(stacked, out_fmt)
    else:
        outputs = []
    final_vars, _ = _regroup(cur, var_fmt)
    return outputs, final_vars


def cond(pred, then_func, else_func):
    """Eager branch (reference ndarray/contrib.py:398): ``pred`` read
    back to the host, then exactly one branch runs."""
    if _to_scalar(pred, bool, "pred"):
        return then_func()
    return else_func()


def _export_contrib_ops():
    pkg = sys.modules["mxnet_tpu_torch.ndarray"]
    for flat in dir(pkg):
        if flat.startswith("_contrib_"):
            globals().setdefault(flat[len("_contrib_"):], getattr(pkg, flat))


_export_contrib_ops()
