"""Tensor ops: the part of ``mxnet_tpu/ops/tensor.py`` the GPT and SSD
training paths call, in PyTorch.

Elementwise and broadcast arithmetic (and their scalar forms), the unary
ops the losses use, ``sum``/``mean`` with ``exclude``, ``Reshape`` with
MXNet's special codes, ``transpose``, ``SliceChannel``/``split``,
``pick`` and ``Embedding``; and for the SSD path ``Flatten``,
``Concat``, ``BlockGrad``, ``MakeLoss`` (a ``torch.autograd.Function``
with the reference's backward), ``smooth_l1`` and the rest of what
Symbol's operator sugar emits; for the ResNet slice's layers ``Pad``;
for the vision zoo ``clip`` (MobileNet v2's ReLU6) and ``SwapAxis``
(``InstanceNorm`` over another axis). Index tensors are cast to int64 inside
``pick`` and ``Embedding``: torch's gathers need it, and callers feed
int32. Every other op of the JAX module is not ported yet: ``nd.<name>``
does not exist for it, and ``invoke`` raises "not registered".
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import REQUIRED, register

__all__ = []


def _norm_axes(axis, ndim, exclude=False):
    if axis is None or (isinstance(axis, tuple) and len(axis) == 0):
        axes = tuple(range(ndim))
    else:
        if isinstance(axis, int):
            axis = (axis,)
        axes = tuple(sorted(a % ndim if a < 0 else a for a in axis))
    if exclude:
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _reg(name, fn, params=None, inputs=("data",), num_outputs=1,
         aliases=()):
    register(name, params=params, inputs=inputs, num_outputs=num_outputs,
             aliases=aliases)(fn)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

for _n, _f in {"negative": torch.neg, "abs": torch.abs,
               "square": torch.square, "_copy": torch.clone,
               "relu": torch.relu, "sigmoid": torch.sigmoid,
               "zeros_like": torch.zeros_like,
               "ones_like": torch.ones_like}.items():
    _reg(_n, lambda attrs, x, _f=_f: _f(x))

_BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}
for _n, _f in _BINARY.items():
    # the elemwise_* and broadcast_* forms share one body (torch
    # broadcasts natively), as in the JAX package
    _reg("elemwise_" + _n, lambda attrs, a, b, _f=_f: _f(a, b),
         inputs=("lhs", "rhs"), aliases=("_" + _n,))
    _reg("broadcast_" + _n, lambda attrs, a, b, _f=_f: _f(a, b),
         inputs=("lhs", "rhs"))

def _power_any(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.pow(a, b)
    return _int_power(a, b)


# the rest of what Symbol's operator sugar emits (mxnet_tpu/symbol.py:
# 141-210): power, mod and the comparisons, whose result keeps the
# input's dtype (1.0 / 0.0)
_SUGAR = {
    "_power": _power_any,
    "broadcast_power": _power_any,
    "broadcast_mod": torch.remainder,
    "broadcast_equal": lambda a, b: (a == b).to(a.dtype),
    "broadcast_not_equal": lambda a, b: (a != b).to(a.dtype),
    "broadcast_greater": lambda a, b: (a > b).to(a.dtype),
    "broadcast_greater_equal": lambda a, b: (a >= b).to(a.dtype),
    "broadcast_lesser": lambda a, b: (a < b).to(a.dtype),
    "broadcast_lesser_equal": lambda a, b: (a <= b).to(a.dtype),
}
for _n, _f in _SUGAR.items():
    _reg(_n, lambda attrs, a, b, _f=_f: _f(a, b), inputs=("lhs", "rhs"))

def _int_power(base, exp):
    """``base ** exp`` on integer tensors as XLA's integer power gives it:
    a negative exponent gives 1 for a base of 1, +-1 for a base of -1 and
    0 otherwise (torch refuses negative integer exponents)."""
    neg = exp < 0
    out = torch.pow(base, torch.where(neg, torch.zeros_like(exp), exp))
    odd = torch.remainder(exp, 2) == 1
    small = torch.where(base == 1, torch.ones_like(out),
                        torch.where(base == -1,
                                    torch.where(odd, -torch.ones_like(out),
                                                torch.ones_like(out)),
                                    torch.zeros_like(out)))
    return torch.where(neg, small, out)


def _power(a, b):
    if a.is_floating_point() or a.dtype == torch.bool:
        return torch.pow(a, b)
    return _int_power(a, b if torch.is_tensor(b) else torch.full_like(a, b))


def _rpower(a, s):
    if a.is_floating_point() or a.dtype == torch.bool:
        return torch.pow(s, a)
    return _int_power(torch.full_like(a, s), a)


_SCALAR = {
    "_plus_scalar": lambda a, s: a + s,
    "_minus_scalar": lambda a, s: a - s,
    "_rminus_scalar": lambda a, s: s - a,
    "_mul_scalar": lambda a, s: a * s,
    "_div_scalar": lambda a, s: a / s,
    "_rdiv_scalar": lambda a, s: s / a,
    "_mod_scalar": lambda a, s: torch.remainder(a, s),
    "_rmod_scalar": lambda a, s: torch.remainder(torch.full_like(a, s), a),
    "_power_scalar": _power,
    "_rpower_scalar": _rpower,
    "_equal_scalar": lambda a, s: (a == s).to(a.dtype),
    "_not_equal_scalar": lambda a, s: (a != s).to(a.dtype),
    "_greater_scalar": lambda a, s: (a > s).to(a.dtype),
    "_greater_equal_scalar": lambda a, s: (a >= s).to(a.dtype),
    "_lesser_scalar": lambda a, s: (a < s).to(a.dtype),
    "_lesser_equal_scalar": lambda a, s: (a <= s).to(a.dtype),
}


def _scalar_as(s: float, dtype: torch.dtype):
    """The scalar cast to the input's dtype first, as the reference does
    (``jnp.asarray(scalar, dtype=a.dtype)``), kept a Python number so that
    no host-to-device copy is made: an integer dtype truncates it toward
    zero and refuses a value out of its range as numpy does; a float dtype
    rounds it to that precision."""
    if dtype == torch.bool:
        return bool(s)
    if not dtype.is_floating_point:
        v = int(s)
        info = torch.iinfo(dtype)
        if not info.min <= v <= info.max:
            raise OverflowError("Python integer %d out of bounds for %s"
                                % (v, str(dtype).replace("torch.", "")))
        return v
    return torch.tensor(s, dtype=dtype).item()


for _n, _f in _SCALAR.items():
    # the arithmetic follows from the input dtype and the cast scalar (an
    # integer division gives float32); a comparison keeps the input dtype
    _reg(_n, lambda attrs, a, _f=_f: _f(a, _scalar_as(attrs.scalar, a.dtype)),
         params={"scalar": (float, 0.0)})


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

_REDUCE_PARAMS = {"axis": (tuple, None), "keepdims": (bool, False),
                  "exclude": (bool, False)}


def _def_reduce(name, fn):
    def f(attrs, x):
        axes = _norm_axes(attrs.axis, x.dim(), attrs.exclude)
        if not axes:  # torch reads an empty dim list as "all": keep x
            return x
        return fn(x, dim=axes, keepdim=attrs.keepdims)

    _reg(name, f, params=dict(_REDUCE_PARAMS))


def _sum(x, dim, keepdim):
    """The reference's integer sums: 32 bits for integers of up to 32
    (unsigned ones to uint32), as JAX without x64 computes them; 64-bit
    inputs stay 64-bit."""
    if x.is_floating_point() or x.dtype in (torch.int64, torch.uint64):
        return torch.sum(x, dim=dim, keepdim=keepdim)
    out = torch.sum(x, dim=dim, keepdim=keepdim, dtype=torch.int64)
    unsigned = x.dtype in (torch.uint8, torch.uint16, torch.uint32)
    return out.to(torch.uint32 if unsigned else torch.int32)


def _mean(x, dim, keepdim):
    """An integer mean is float32, as the reference's."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keepdim)


_def_reduce("sum", _sum)
_def_reduce("mean", _mean)


# ---------------------------------------------------------------------------
# shape
# ---------------------------------------------------------------------------


def _reshape_infer(shape, target):
    """MXNet Reshape semantics: 0 copies input dim, -1 infers, -2 copies
    rest, -3 merges two dims, -4 splits a dim."""
    out = []
    src = list(shape)
    i = 0
    j = 0
    while j < len(target):
        t = target[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            a, b = target[j + 1], target[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(t)
            i += 1
        j += 1
    if -1 in out:
        known = 1
        for v in out:
            if v != -1:
                known *= v
        total = 1
        for v in shape:
            total *= v
        out[out.index(-1)] = total // known
    return tuple(out)


def _reshape(attrs, x):
    if not attrs.shape:
        return x
    if attrs.reverse:
        return x.reshape(tuple(reversed(_reshape_infer(
            tuple(reversed(x.shape)), tuple(reversed(attrs.shape))))))
    return x.reshape(_reshape_infer(tuple(x.shape), attrs.shape))


_reg("Reshape", _reshape, params={"shape": (tuple, None),
                                  "reverse": (bool, False)},
     aliases=("reshape",))
_reg("Flatten", lambda attrs, x: x.reshape(x.shape[0], -1),
     aliases=("flatten",))


def _pad(attrs, x):
    """``Pad`` (``mxnet_tpu/ops/tensor.py:531``): ``pad_width`` holds a
    (before, after) pair for every axis. ``constant`` pads any axis;
    ``edge`` and ``reflect`` pad the axes after the first two, as MXNet's
    own op does (a pad on the batch or channel axis raises)."""
    pw = attrs.pad_width
    if len(pw) != 2 * x.dim():
        raise MXNetError("Pad: pad_width has %d entries, %d expected"
                         % (len(pw), 2 * x.dim()))
    first = 0 if attrs.mode == "constant" else 2
    if any(pw[:2 * first]):
        raise MXNetError("Pad: mode %r pads the axes after the first two "
                         "only" % attrs.mode)
    widths = []  # F.pad order: last axis first
    for i in reversed(range(first, x.dim())):
        widths += [pw[2 * i], pw[2 * i + 1]]
    if attrs.mode == "constant":
        return torch.nn.functional.pad(x, widths,
                                       value=attrs.constant_value)
    modes = {"edge": "replicate", "reflect": "reflect"}
    if attrs.mode not in modes:
        raise MXNetError("Pad: unknown mode %r" % attrs.mode)
    return torch.nn.functional.pad(x, widths, mode=modes[attrs.mode])


_reg("Pad", _pad,
     params={"mode": (str, "constant"), "pad_width": (tuple, REQUIRED),
             "constant_value": (float, 0.0)},
     aliases=("pad",))
_reg("Concat", lambda attrs, *xs: torch.cat(xs, dim=attrs.dim),
     params={"num_args": (int, 1), "dim": (int, 1)},
     inputs=lambda attrs: ["arg%d" % i
                           for i in range(attrs.get("num_args", 1))],
     aliases=("concat",))
_reg("transpose",
     lambda attrs, x: x.permute(*attrs.axes) if attrs.axes
     else x.permute(*reversed(range(x.dim()))),
     params={"axes": (tuple, None)})
_reg("SwapAxis",
     lambda attrs, x: torch.swapaxes(x, attrs.dim1, attrs.dim2),
     params={"dim1": (int, 0), "dim2": (int, 0)}, aliases=("swapaxes",))
# torch.clamp passes the gradient at either bound, where jnp.clip's
# max/min split it in halves: the two differ only on inputs exactly at a
# bound
_reg("clip", lambda attrs, x: torch.clamp(x, attrs.a_min, attrs.a_max),
     params={"a_min": (float, REQUIRED), "a_max": (float, REQUIRED)})


def _split(attrs, x):
    ax = attrs.axis % x.dim()
    parts = torch.chunk(x, attrs.num_outputs, dim=ax)
    if len(parts) != attrs.num_outputs or x.shape[ax] % attrs.num_outputs:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d" % (ax, x.shape[ax], attrs.num_outputs))
    return tuple(p.squeeze(ax) if attrs.squeeze_axis else p for p in parts)


_reg("SliceChannel", _split,
     params={"num_outputs": (int, REQUIRED), "axis": (int, 1),
             "squeeze_axis": (bool, False)},
     num_outputs=lambda attrs: attrs.num_outputs, aliases=("split",))


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------


def _pick(attrs, x, idx):
    ax = attrs.axis % x.dim()
    idxe = idx.to(torch.int64).unsqueeze(ax).clamp(0, x.shape[ax] - 1)
    out = torch.gather(x, ax, idxe)
    return out if attrs.keepdims else out.squeeze(ax)


_reg("pick", _pick,
     params={"axis": (int, -1), "keepdims": (bool, False),
             "mode": (str, "clip")},
     inputs=("data", "index"))
_reg("Embedding",
     lambda attrs, data, weight: weight[data.to(torch.int64)],
     params={"input_dim": (int, REQUIRED), "output_dim": (int, REQUIRED),
             "dtype": ("dtype", None), "sparse_grad": (bool, False)},
     inputs=("data", "weight"))


# ---------------------------------------------------------------------------
# gradient control and losses
# ---------------------------------------------------------------------------

_reg("BlockGrad", lambda attrs, x: x.detach(), aliases=("stop_gradient",))


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward emits the incoming gradient times
    ``grad_scale``, divided by the batch size (``normalization='batch'``)
    or by the count of entries above ``valid_thresh`` (``'valid'``): the
    JAX ``_make_loss`` custom vjp (``mxnet_tpu/ops/tensor.py:124-150``,
    reference make_loss.cc)."""

    @staticmethod
    def forward(ctx, x, scale, norm, valid_thresh):
        ctx.save_for_backward(x)
        ctx.scale, ctx.norm, ctx.valid_thresh = scale, norm, valid_thresh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # a fill on the device, not a copy from the host: capturable
        s = torch.full((), ctx.scale, dtype=g.dtype, device=g.device)
        if ctx.norm == "batch":
            s = s / x.shape[0]
        elif ctx.norm == "valid":
            s = s / torch.clamp_min(
                (x > ctx.valid_thresh).to(g.dtype).sum(), 1.0)
        return g * s, None, None, None


_reg("make_loss",
     lambda attrs, x: _MakeLoss.apply(x, attrs.grad_scale,
                                      attrs.normalization,
                                      attrs.valid_thresh),
     params={"grad_scale": (float, 1.0), "valid_thresh": (float, 0.0),
             "normalization": (str, "null")},
     aliases=("MakeLoss_", "MakeLoss"))


def _smooth_l1(attrs, x):
    s2 = attrs.scalar ** 2
    return torch.where(x.abs() < 1.0 / s2, 0.5 * (x * attrs.scalar) ** 2,
                       x.abs() - 0.5 / s2)


_reg("smooth_l1", _smooth_l1, params={"scalar": (float, 1.0)})
