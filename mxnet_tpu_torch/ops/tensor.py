"""Tensor ops: the port of ``mxnet_tpu/ops/tensor.py``, every name it
registers, in PyTorch.

Elementwise and broadcast arithmetic with their scalar forms and the
operator-sugar aliases (``_Plus`` ... ``_RPowerScalar``); the unary math
ops; the comparisons and logical ops, whose result keeps the input's
dtype (1 or 0); the reductions (``sum``/``mean``/``prod``/``max``/``min``
with ``exclude``, the ``nan*`` forms, ``norm``, the arg-reductions);
shape ops (``Reshape`` with MXNet's special codes, ``slice``,
``broadcast_*``, ``depth_to_space``, ...); indexing (``take``,
``gather_nd``, ``scatter_nd``, ``one_hot``, ``where``, ``pick``,
``Embedding``); ``dot`` and ``batch_dot`` (``torch.matmul``: the JAX
package leaves them to XLA outside any kernel); creation; ordering
(``topk``, ``sort``, ``argsort``) and ``_histogram``.

The JAX op is the spec, down to its dtypes: integer inputs stay integer
where ``jax.numpy`` keeps them (``abs``, ``floor``, ``prod``, ``max``),
become float32 where it promotes (``sqrt``, ``exp``, ``rint``,
``hypot``), and an integer product runs as a broadcast multiply and sum
(cuBLAS has no integer GEMM). Two kept deviations: 64-bit inputs stay
64-bit (JAX without x64 narrows them to 32), so ``shape_array`` and
``size_array`` give int64; and ``clip``'s gradient at a bound (below).
Ties in ``topk`` keep the lower index first, as XLA's TopK does, by a
stable sort. Index tensors are cast to int64 inside: torch's gathers
need it, and callers feed int32 or float.

An op with no array input (``_zeros``, ``_arange``, ...) makes its result
on the device :func:`out_device` names: the one ``invoke`` resolved from
``ctx=`` or the current context.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, torch_dtype
from .registry import OP_REGISTRY, REQUIRED, register

__all__ = ["out_device"]


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


def out_device(attrs) -> torch.device:
    """The device of an op with no array input: what ``invoke`` put in
    ``attrs['__device__']``, else the op's ``ctx`` attr (a Context or a
    string such as ``'gpu(0)'``), else the current context."""
    from ..context import Context, current_context

    dev = attrs.get("__device__")
    if dev is not None:
        return dev
    ctx = attrs.get("ctx")
    if isinstance(ctx, Context):
        return ctx.torch_device()
    if isinstance(ctx, str) and ctx:
        kind, _, idx = ctx.partition("(")
        return Context(kind, int(idx.rstrip(")")) if idx else 0) \
            .torch_device()
    return current_context().torch_device()


def _float(x):
    """x as float32 when it is not floating already (jax.numpy's
    promotion of an integer input to the default float)."""
    return x if x.is_floating_point() else x.to(torch.float32)


# ---------------------------------------------------------------------------
# unary math
# ---------------------------------------------------------------------------


def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _gamma(x):
    """Gamma as ``jax.scipy.special.gamma``: the sign times
    ``exp(gammaln)``, NaN at the negative integers."""
    x = _float(x)
    fl = torch.floor(x)
    sign = torch.where((x > 0) | (torch.remainder(fl, 2) == 0),
                       torch.ones_like(x), -torch.ones_like(x))
    out = sign * torch.exp(torch.lgamma(x))
    return torch.where((x < 0) & (x == fl), torch.full_like(x, math.nan),
                       out)


def _round_float(fn):
    """floor/ceil/round/trunc: identity on integers (as jax.numpy)."""
    return lambda x: fn(x) if x.is_floating_point() else x.clone()


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "negative": torch.neg,
    "reciprocal": lambda x: torch.reciprocal(_float(x)),
    "square": torch.square,
    "sqrt": lambda x: torch.sqrt(_float(x)),
    "rsqrt": lambda x: torch.rsqrt(_float(x)),
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": lambda x: torch.exp(_float(x)),
    "expm1": lambda x: torch.expm1(_float(x)),
    "log": lambda x: torch.log(_float(x)),
    "log10": lambda x: torch.log10(_float(x)),
    "log2": lambda x: torch.log2(_float(x)),
    "log1p": lambda x: torch.log1p(_float(x)),
    "sin": lambda x: torch.sin(_float(x)),
    "cos": lambda x: torch.cos(_float(x)),
    "tan": lambda x: torch.tan(_float(x)),
    "sinh": lambda x: torch.sinh(_float(x)),
    "cosh": lambda x: torch.cosh(_float(x)),
    "tanh": lambda x: torch.tanh(_float(x)),
    "arcsin": lambda x: torch.asin(_float(x)),
    "arccos": lambda x: torch.acos(_float(x)),
    "arctan": lambda x: torch.atan(_float(x)),
    "arcsinh": lambda x: torch.asinh(_float(x)),
    "arccosh": lambda x: torch.acosh(_float(x)),
    "arctanh": lambda x: torch.atanh(_float(x)),
    "degrees": lambda x: torch.rad2deg(_float(x)),
    "radians": lambda x: torch.deg2rad(_float(x)),
    "floor": _round_float(torch.floor),
    "ceil": _round_float(torch.ceil),
    "round": _round_float(torch.round),  # half to even, as jnp.round
    "rint": lambda x: torch.round(_float(x)),
    "fix": _round_float(torch.trunc),
    "trunc": _round_float(torch.trunc),
    "gamma": _gamma,
    "gammaln": lambda x: torch.lgamma(_float(x)),
    "erf": lambda x: torch.erf(_float(x)),
    "erfinv": lambda x: torch.erfinv(_float(x)),
    "relu": torch.relu,
    "sigmoid": lambda x: torch.sigmoid(_float(x)),
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "_copy": torch.clone,
    "ones_like": torch.ones_like,
    "zeros_like": torch.zeros_like,
}
for _n, _f in _UNARY.items():
    _reg(_n, lambda attrs, x, _f=_f: _f(x))
for _alias in ("_copyto", "_CrossDeviceCopy"):
    # the JAX package's misc_tail.py aliases these to _copy
    OP_REGISTRY.setdefault(_alias, OP_REGISTRY["_copy"])

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
# torch.clamp passes the gradient at either bound, where jnp.clip's
# max/min split it in halves: the two differ only on inputs exactly at a
# bound
_reg("clip", lambda attrs, x: torch.clamp(x, attrs.a_min, attrs.a_max),
     params={"a_min": (float, REQUIRED), "a_max": (float, REQUIRED)})
_reg("Cast", lambda attrs, x: x.to(torch_dtype(attrs.dtype)),
     params={"dtype": ("dtype", REQUIRED)}, aliases=("cast",))


# ---------------------------------------------------------------------------
# binary elementwise and broadcast
# ---------------------------------------------------------------------------


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


def _power_any(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.pow(a, b)
    return _int_power(a, b)


def _hypot(a, b):
    return torch.hypot(_float(a), _float(b))


def _logical(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


_BODIES = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "mod": torch.remainder,
    "power": _power_any,
    "hypot": _hypot,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "equal": lambda a, b: (a == b).to(a.dtype),
    "not_equal": lambda a, b: (a != b).to(a.dtype),
    "greater": lambda a, b: (a > b).to(a.dtype),
    "greater_equal": lambda a, b: (a >= b).to(a.dtype),
    "lesser": lambda a, b: (a < b).to(a.dtype),
    "lesser_equal": lambda a, b: (a <= b).to(a.dtype),
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
}

# the elemwise_*/_<name> forms and their operator-sugar aliases, as the
# JAX package names them
_BINARY = {
    "elemwise_add": ("add", ("_add", "_plus", "_Plus")),
    "elemwise_sub": ("sub", ("_sub", "_minus", "_Minus")),
    "elemwise_mul": ("mul", ("_mul", "_Mul")),
    "elemwise_div": ("div", ("_div", "_Div")),
    "_grad_add": ("add", ()),
    "_mod": ("mod", ("_Mod",)),
    "_power": ("power", ("_Power", "pow")),
    "_hypot": ("hypot", ()),
    "_maximum": ("maximum", ("_Maximum",)),
    "_minimum": ("minimum", ("_Minimum",)),
    "_equal": ("equal", ("_Equal",)),
    "_not_equal": ("not_equal", ("_Not_Equal",)),
    "_greater": ("greater", ("_Greater",)),
    "_greater_equal": ("greater_equal", ("_Greater_Equal",)),
    "_lesser": ("lesser", ("_Lesser",)),
    "_lesser_equal": ("lesser_equal", ("_Lesser_Equal",)),
    "_logical_and": ("logical_and", ()),
    "_logical_or": ("logical_or", ()),
    "_logical_xor": ("logical_xor", ()),
}
for _n, (_b, _al) in _BINARY.items():
    _reg(_n, lambda attrs, a, b, _f=_BODIES[_b]: _f(a, b),
         inputs=("lhs", "rhs"), aliases=_al)
# the broadcast_* family shares the bodies (torch broadcasts natively)
for _b, _f in _BODIES.items():
    _reg("broadcast_" + _b,
         lambda attrs, a, b, _f=_f: _f(a, b), inputs=("lhs", "rhs"))


def _power(a, b):
    if a.is_floating_point() or a.dtype == torch.bool:
        return torch.pow(a, b)
    return _int_power(a, b if torch.is_tensor(b) else torch.full_like(a, b))


def _rpower(a, s):
    if a.is_floating_point() or a.dtype == torch.bool:
        return torch.pow(s, a)
    return _int_power(torch.full_like(a, s), a)


_SCALAR = {
    "_plus_scalar": (lambda a, s: a + s, ("_PlusScalar",)),
    "_minus_scalar": (lambda a, s: a - s, ("_MinusScalar",)),
    "_rminus_scalar": (lambda a, s: s - a, ("_RMinusScalar",)),
    "_mul_scalar": (lambda a, s: a * s, ("_MulScalar",)),
    "_div_scalar": (lambda a, s: a / s, ("_DivScalar",)),
    "_rdiv_scalar": (lambda a, s: s / a, ("_RDivScalar",)),
    "_mod_scalar": (lambda a, s: torch.remainder(a, s), ("_ModScalar",)),
    "_rmod_scalar": (lambda a, s: torch.remainder(torch.full_like(a, s), a),
                     ("_RModScalar",)),
    "_power_scalar": (_power, ("_PowerScalar",)),
    "_rpower_scalar": (_rpower, ("_RPowerScalar",)),
    "_maximum_scalar": (lambda a, s: torch.maximum(a, torch.full_like(a, s)),
                        ("_MaximumScalar",)),
    "_minimum_scalar": (lambda a, s: torch.minimum(a, torch.full_like(a, s)),
                        ("_MinimumScalar",)),
    "_hypot_scalar": (lambda a, s: _hypot(a, torch.full_like(a, s)), ()),
    "_equal_scalar": (lambda a, s: (a == s).to(a.dtype), ()),
    "_not_equal_scalar": (lambda a, s: (a != s).to(a.dtype), ()),
    "_greater_scalar": (lambda a, s: (a > s).to(a.dtype), ()),
    "_greater_equal_scalar": (lambda a, s: (a >= s).to(a.dtype), ()),
    "_lesser_scalar": (lambda a, s: (a < s).to(a.dtype), ()),
    "_lesser_equal_scalar": (lambda a, s: (a <= s).to(a.dtype), ()),
    "_logical_and_scalar": (
        lambda a, s: ((a != 0) & bool(s != 0)).to(a.dtype), ()),
    "_logical_or_scalar": (
        lambda a, s: ((a != 0) | bool(s != 0)).to(a.dtype), ()),
    "_logical_xor_scalar": (
        lambda a, s: ((a != 0) ^ bool(s != 0)).to(a.dtype), ()),
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


for _n, (_f, _al) in _SCALAR.items():
    # the arithmetic follows from the input dtype and the cast scalar (an
    # integer division gives float32); a comparison keeps the input dtype
    _reg(_n, lambda attrs, a, _f=_f: _f(a, _scalar_as(attrs.scalar, a.dtype)),
         params={"scalar": (float, 0.0)}, aliases=_al)

_reg("add_n", lambda attrs, *xs: sum(xs[1:], xs[0]),
     params={"num_args": (int, 1)},
     inputs=lambda attrs: ["arg%d" % i
                           for i in range(attrs.get("num_args", 1))],
     aliases=("ElementWiseSum", "_sum"))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

_REDUCE_PARAMS = {"axis": (tuple, None), "keepdims": (bool, False),
                  "exclude": (bool, False)}


def _def_reduce(name, fn, aliases=()):
    def f(attrs, x):
        axes = _norm_axes(attrs.axis, x.dim(), attrs.exclude)
        if not axes:  # torch reads an empty dim list as "all": keep x
            return x
        return fn(x, dim=axes, keepdim=attrs.keepdims)

    _reg(name, f, params=dict(_REDUCE_PARAMS), aliases=aliases)


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


def _prod(x, dim, keepdim):
    """torch.prod takes one axis: the reduced axes are moved last and
    merged. An integer product keeps the input's dtype (torch's would be
    int64)."""
    keep = [i for i in range(x.dim()) if i not in dim]
    y = x.permute(*keep, *dim).reshape(
        [x.shape[i] for i in keep] + [-1])
    out = torch.prod(y, dim=-1, dtype=None if x.is_floating_point()
                     else x.dtype)
    if keepdim:
        out = out.reshape([1 if i in dim else s
                           for i, s in enumerate(x.shape)])
    return out


def _nansum(x, dim, keepdim):
    if not x.is_floating_point():
        return _sum(x, dim, keepdim)
    return torch.nansum(x, dim=dim, keepdim=keepdim)


def _nanprod(x, dim, keepdim):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, dim, keepdim)


# amax/amin share the gradient among ties evenly, as jnp.max's does
_def_reduce("sum", _sum, aliases=("sum_axis",))
_def_reduce("mean", _mean)
_def_reduce("prod", _prod)
_def_reduce("nansum", _nansum)
_def_reduce("nanprod", _nanprod)
_def_reduce("max", torch.amax, aliases=("max_axis",))
_def_reduce("min", torch.amin, aliases=("min_axis",))


def _norm(attrs, x):
    axes = _norm_axes(attrs.axis, x.dim())
    if attrs.ord == 2:
        return torch.sqrt(_float(_sum(torch.square(x), axes,
                                      attrs.keepdims)))
    return _sum(torch.abs(x), axes, attrs.keepdims)


_reg("norm", _norm,
     params={"ord": (int, 2), "axis": (tuple, None),
             "keepdims": (bool, False)})
_reg("_square_sum",
     lambda attrs, x: _sum(torch.square(x), _norm_axes(
         attrs.axis, x.dim(), attrs.exclude), attrs.keepdims),
     params=dict(_REDUCE_PARAMS))


def _arg_reduce(fn):
    """The index of the first extreme, in the input's dtype."""
    def f(attrs, x):
        if attrs.axis is None:
            return fn(x.reshape(-1), dim=0).to(x.dtype)
        ax = attrs.axis[0] if isinstance(attrs.axis, tuple) \
            else int(attrs.axis)
        return fn(x, dim=ax, keepdim=attrs.keepdims).to(x.dtype)

    return f


_ARG_PARAMS = {"axis": (tuple, None), "keepdims": (bool, False)}
_reg("argmax", _arg_reduce(torch.argmax), params=dict(_ARG_PARAMS))
_reg("argmin", _arg_reduce(torch.argmin), params=dict(_ARG_PARAMS))
_reg("argmax_channel",
     lambda attrs, x: torch.argmax(x, dim=1).to(x.dtype))


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
_reg("stack", lambda attrs, *xs: torch.stack(xs, dim=attrs.axis),
     params={"num_args": (int, 1), "axis": (int, 0)},
     inputs=lambda attrs: ["arg%d" % i
                           for i in range(attrs.get("num_args", 1))])
_reg("transpose",
     lambda attrs, x: x.permute(*attrs.axes) if attrs.axes
     else x.permute(*reversed(range(x.dim()))),
     params={"axes": (tuple, None)})
_reg("SwapAxis",
     lambda attrs, x: torch.swapaxes(x, attrs.dim1, attrs.dim2),
     params={"dim1": (int, 0), "dim2": (int, 0)}, aliases=("swapaxes",))
_reg("expand_dims", lambda attrs, x: x.unsqueeze(attrs.axis),
     params={"axis": (int, REQUIRED)})


def _squeeze(attrs, x):
    if not attrs.axis:
        return x.reshape([s for s in x.shape if s != 1])
    axes = {a % x.dim() for a in attrs.axis}
    for a in axes:
        if x.shape[a] != 1:
            raise MXNetError("squeeze: axis %d has size %d, not 1"
                             % (a, x.shape[a]))
    return x.reshape([s for i, s in enumerate(x.shape) if i not in axes])


_reg("squeeze", _squeeze, params={"axis": (tuple, None)})


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


def _slice_dim(x, dim, begin, end, step):
    """``x`` sliced along ``dim`` as Python's ``slice(begin, end,
    step)`` (torch refuses a negative step in basic indexing: such a
    slice gathers by an index range made on the device)."""
    if step is None or step > 0:
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(begin, end, step)
        return x[tuple(idx)]
    r = range(*slice(begin, end, step).indices(x.shape[dim]))
    index = torch.arange(r.start, r.stop, r.step, device=x.device)
    return x.index_select(dim, index)


def _slice(attrs, x):
    nd = x.dim()
    begin = list(attrs.begin) + [None] * (nd - len(attrs.begin))
    end = list(attrs.end) + [None] * (nd - len(attrs.end))
    step = list(attrs.step or ()) + [None] * (nd - len(attrs.step or ()))
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _slice_dim(x, d, b, e, None if s == 0 else s)
    return x


_reg("slice", _slice,
     params={"begin": (tuple, REQUIRED), "end": (tuple, REQUIRED),
             "step": (tuple, None)},
     aliases=("crop",))


def _slice_axis(attrs, x):
    ax = attrs.axis % x.dim()
    n = x.shape[ax]
    b = attrs.begin if attrs.begin >= 0 else n + attrs.begin
    e = n if attrs.end is None else (attrs.end if attrs.end >= 0
                                     else n + attrs.end)
    return x.narrow(ax, b, max(0, e - b))


_reg("slice_axis", _slice_axis,
     params={"axis": (int, REQUIRED), "begin": (int, REQUIRED),
             "end": (int, None)})


def _slice_like(attrs, x, like):
    axes = None if not attrs.axes else [a % x.dim() for a in attrs.axes]
    return x[tuple(slice(0, like.shape[i]) if axes is None or i in axes
                   else slice(None) for i in range(x.dim()))]


_reg("slice_like", _slice_like, params={"axes": (tuple, None)},
     inputs=("data", "shape_like"))
_reg("tile", lambda attrs, x: torch.tile(x, attrs.reps),
     params={"reps": (tuple, REQUIRED)})
_reg("repeat",
     lambda attrs, x: torch.repeat_interleave(x, attrs.repeats,
                                              dim=attrs.axis),
     params={"repeats": (int, REQUIRED), "axis": (int, None)})
_reg("reverse", lambda attrs, x: torch.flip(x, attrs.axis),
     params={"axis": (tuple, REQUIRED)}, aliases=("flip",))


def _broadcast_to(attrs, x):
    tgt = attrs.shape
    if len(tgt) == x.dim():  # 0 means "keep input dim" (reference)
        tgt = tuple(t if t != 0 else s for t, s in zip(tgt, x.shape))
    return torch.broadcast_to(x, tgt)


def _broadcast_axis(attrs, x):
    axes = [a % x.dim() for a in attrs.axis]
    return torch.broadcast_to(x, tuple(
        attrs.size[axes.index(i)] if i in axes else s
        for i, s in enumerate(x.shape)))


_reg("broadcast_to", _broadcast_to, params={"shape": (tuple, REQUIRED)})
_reg("broadcast_axis", _broadcast_axis,
     params={"axis": (tuple, REQUIRED), "size": (tuple, REQUIRED)},
     aliases=("broadcast_axes",))
_reg("broadcast_like",
     lambda attrs, x, like: torch.broadcast_to(x, like.shape),
     inputs=("lhs", "rhs"))
_reg("reshape_like", lambda attrs, x, like: x.reshape(like.shape),
     inputs=("lhs", "rhs"))
# int64, where JAX without x64 gives int32 (a kept deviation)
_reg("shape_array",
     lambda attrs, x: torch.tensor(x.shape, dtype=torch.int64,
                                   device=x.device))
_reg("size_array",
     lambda attrs, x: torch.full((1,), x.numel(), dtype=torch.int64,
                                 device=x.device))


def _depth_to_space(attrs, x):
    b = attrs.block_size
    n, c, h, w = x.shape
    x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _space_to_depth(attrs, x):
    b = attrs.block_size
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


_reg("depth_to_space", _depth_to_space,
     params={"block_size": (int, REQUIRED)})
_reg("space_to_depth", _space_to_depth,
     params={"block_size": (int, REQUIRED)})
_reg("diag",
     lambda attrs, x: torch.diag(x, attrs.k) if x.dim() <= 2
     else torch.diagonal(x, attrs.k, attrs.axis1, attrs.axis2),
     params={"k": (int, 0), "axis1": (int, 0), "axis2": (int, 1)})


def _where(attrs, cond, a, b):
    c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())) != 0
    return torch.where(c, a, b)


_reg("where", _where, inputs=("condition", "x", "y"))


# ---------------------------------------------------------------------------
# dot / batch_dot
# ---------------------------------------------------------------------------


def _matmul(a, b):
    """torch.matmul; integers as a broadcast multiply and sum, exact
    (cuBLAS has no integer GEMM)."""
    if a.is_floating_point() or b.is_floating_point():
        return torch.matmul(a, b)
    if b.dim() == 1:
        return (a * b).sum(-1).to(a.dtype)
    av = a.unsqueeze(0) if a.dim() == 1 else a
    out = (av.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2).to(a.dtype)
    return out.squeeze(-2) if a.dim() == 1 else out


def _dot(attrs, a, b):
    """Contract a's last axis with b's first: a.shape[:-1] + b.shape[1:]
    (reference dot-inl.h)."""
    if a.dim() == 1 and b.dim() == 1:
        return _matmul(a, b)
    am = torch.swapaxes(a, -1, -2) if attrs.transpose_a else a
    bm = torch.swapaxes(b, 0, 1) if attrs.transpose_b else b
    if bm.dim() == 2:
        return _matmul(am, bm)
    flat = bm.reshape(bm.shape[0], -1)
    return _matmul(am, flat).reshape(am.shape[:-1] + bm.shape[1:])


def _batch_dot(attrs, a, b):
    am = torch.swapaxes(a, -1, -2) if attrs.transpose_a else a
    bm = torch.swapaxes(b, -1, -2) if attrs.transpose_b else b
    return _matmul(am, bm)


_DOT_PARAMS = {"transpose_a": (bool, False), "transpose_b": (bool, False)}
_reg("dot", _dot, params=dict(_DOT_PARAMS), inputs=("lhs", "rhs"))
_reg("batch_dot", _batch_dot, params=dict(_DOT_PARAMS),
     inputs=("lhs", "rhs"))


def _khatri_rao(attrs, *mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out.unsqueeze(1) * m.unsqueeze(0)).reshape(
            (out.shape[0] * m.shape[0],) + tuple(out.shape[1:]))
    return out


_reg("khatri_rao", _khatri_rao, params={"num_args": (int, 1)},
     inputs=lambda attrs: ["arg%d" % i
                           for i in range(attrs.get("num_args", 1))])


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------


def _take(attrs, a, idx):
    """``jnp.take`` with ``clip`` (``raise`` clips too) or ``wrap``."""
    ax = attrs.axis % a.dim()
    n = a.shape[ax]
    i = idx.to(torch.int64)
    if attrs.mode == "wrap":
        i = torch.remainder(i, n)
    elif attrs.mode in ("clip", "raise"):
        i = i.clamp(0, n - 1)
    else:
        raise MXNetError("take: unknown mode %r" % attrs.mode)
    out = a.index_select(ax, i.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


_reg("take", _take, params={"axis": (int, 0), "mode": (str, "clip")},
     inputs=("a", "indices"))


def _fill_value(dtype):
    """What a JAX gather gives out of bounds: NaN, or the least integer."""
    if dtype.is_floating_point:
        return math.nan
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype != torch.uint8 else 255


def _batch_take(attrs, a, idx):
    """Row r takes ``a[r, idx[r]]``: negative indices count from the end
    once, and an index still out of range gives the gather's fill
    (``jnp.take_along_axis``)."""
    n = a.shape[1]
    i = idx.to(torch.int64).reshape(-1, 1)
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    out = torch.gather(a, 1, i.clamp(0, n - 1))
    out = torch.where(ok, out, torch.full_like(out, _fill_value(a.dtype)))
    return out.reshape(idx.shape)


_reg("batch_take", _batch_take, inputs=("a", "indices"))


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


def _one_hot(attrs, idx):
    """An index out of [0, depth) gives a row of ``off_value``, as
    ``jax.nn.one_hot``."""
    dtype = torch.float32 if attrs.dtype is None else torch_dtype(
        attrs.dtype)
    hot = idx.to(torch.int64).unsqueeze(-1) == torch.arange(
        attrs.depth, device=idx.device)
    return hot.to(dtype) * (attrs.on_value - attrs.off_value) \
        + attrs.off_value


_reg("one_hot", _one_hot,
     params={"depth": (int, REQUIRED), "on_value": (float, 1.0),
             "off_value": (float, 0.0), "dtype": ("dtype", None)},
     inputs=("indices",))


def _nd_index(data, indices):
    """The leading-axes index tuple of ``indices`` (M, ...): a negative
    index counts from the end, then each is clamped into range (a JAX
    gather's semantics)."""
    idx = []
    for k in range(indices.shape[0]):
        n = data.shape[k]
        i = indices[k].to(torch.int64)
        idx.append(torch.where(i < 0, i + n, i).clamp(0, n - 1))
    return tuple(idx)


_reg("gather_nd",
     lambda attrs, data, indices: data[_nd_index(data, indices)],
     inputs=("data", "indices"))


def _scatter_nd(attrs, data, indices):
    out = torch.zeros(attrs.shape, dtype=data.dtype, device=data.device)
    idx = tuple(i.to(torch.int64) for i in indices)
    return out.index_put(idx, data, accumulate=True)


_reg("scatter_nd", _scatter_nd, params={"shape": (tuple, REQUIRED)},
     inputs=("data", "indices"))
_reg("_scatter_set_nd",
     lambda attrs, lhs, rhs, indices: lhs.index_put(
         tuple(i.to(torch.int64) for i in indices), rhs),
     params={"shape": (tuple, None)}, inputs=("lhs", "rhs", "indices"))


def _ravel(attrs, data):
    strides, acc = [], 1
    for s in reversed(attrs.shape):
        strides.append(acc)
        acc *= s
    st = torch.tensor(list(reversed(strides)), dtype=data.dtype,
                      device=data.device)
    return _sum(data * st.reshape(-1, *([1] * (data.dim() - 1))), (0,),
                False)


def _unravel(attrs, data):
    idx = data.to(torch.int64)
    outs = []
    for s in reversed(attrs.shape):
        outs.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(list(reversed(outs)), dim=0).to(data.dtype)


_reg("_ravel_multi_index", _ravel, params={"shape": (tuple, REQUIRED)})
_reg("_unravel_index", _unravel, params={"shape": (tuple, REQUIRED)})


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def _out_dtype(attrs):
    return torch.float32 if attrs.dtype is None else torch_dtype(
        attrs.dtype)


_INIT_PARAMS = {"shape": (tuple, None), "dtype": ("dtype", None),
                "ctx": (str, "")}
_reg("_zeros",
     lambda attrs: torch.zeros(attrs.shape or (), dtype=_out_dtype(attrs),
                               device=out_device(attrs)),
     params=dict(_INIT_PARAMS), inputs=())
_reg("_ones",
     lambda attrs: torch.ones(attrs.shape or (), dtype=_out_dtype(attrs),
                              device=out_device(attrs)),
     params=dict(_INIT_PARAMS), inputs=())
_reg("_full",
     lambda attrs: torch.full(attrs.shape or (), attrs.value,
                              dtype=_out_dtype(attrs),
                              device=out_device(attrs)),
     params=dict(_INIT_PARAMS, value=(float, 0.0)), inputs=())


def _arange(attrs):
    start, stop = attrs.start, attrs.stop
    if stop is None:
        start, stop = 0.0, start
    # computed in float64 as numpy's arange, then cast
    out = torch.arange(start, stop, attrs.step, dtype=torch.float64,
                       device=out_device(attrs)).to(_out_dtype(attrs))
    return torch.repeat_interleave(out, attrs.repeat) if attrs.repeat > 1 \
        else out


_reg("_arange", _arange,
     params={"start": (float, 0.0), "stop": (float, None),
             "step": (float, 1.0), "repeat": (int, 1),
             "dtype": ("dtype", None), "ctx": (str, ""),
             "infer_range": (bool, False)},
     inputs=())


def _eye(attrs):
    dev = out_device(attrs)
    m = attrs.M or attrs.N
    rows = torch.arange(attrs.N, device=dev).unsqueeze(1)
    return (rows + attrs.k == torch.arange(m, device=dev)).to(
        _out_dtype(attrs))


_reg("_eye", _eye,
     params={"N": (int, REQUIRED), "M": (int, 0), "k": (int, 0),
             "dtype": ("dtype", None), "ctx": (str, "")},
     inputs=())
_reg("_identity_with_attr_like_rhs", lambda attrs, lhs, rhs: lhs,
     inputs=("lhs", "rhs"))
_reg("_NoGradient",
     lambda attrs: torch.zeros((), device=out_device(attrs)), inputs=())


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


def _index_dtype(attrs):
    return torch.float32 if attrs.dtype is None else torch_dtype(
        attrs.dtype)


def _topk(attrs, x):
    """The k largest (smallest with ``is_ascend``) along ``axis``, ties in
    index order (a stable sort, as XLA's TopK)."""
    ax = x.dim() - 1 if attrs.axis is None else attrs.axis % x.dim()
    k = attrs.k if attrs.k > 0 else x.shape[ax]
    vals, idxs = torch.sort(x, dim=ax, descending=not attrs.is_ascend,
                            stable=True)
    vals, idxs = vals.narrow(ax, 0, k), idxs.narrow(ax, 0, k)
    rt = attrs.ret_typ
    if rt == "value":
        return vals
    if rt == "indices":
        return idxs.to(_index_dtype(attrs))
    if rt == "mask":
        return torch.zeros_like(x).scatter(ax, idxs, 1)
    if rt == "both":
        return vals, idxs.to(_index_dtype(attrs))
    raise MXNetError("topk: unknown ret_typ %r" % rt)


_reg("topk", _topk,
     params={"axis": (int, -1), "k": (int, 1),
             "ret_typ": (str, "indices"), "is_ascend": (bool, False),
             "dtype": ("dtype", None)},
     num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both" else 1)


def _sort(attrs, x):
    ax = x.dim() - 1 if attrs.axis is None else attrs.axis % x.dim()
    s = torch.sort(x, dim=ax, stable=True).values
    return s if attrs.is_ascend else torch.flip(s, (ax,))


_reg("sort", _sort, params={"axis": (int, -1), "is_ascend": (bool, True)})


def _argsort(attrs, x):
    """A stable ascending argsort, flipped when descending (so ties come
    in reverse index order then, as ``jnp.flip(jnp.argsort(x))``)."""
    ax = x.dim() - 1 if attrs.axis is None else attrs.axis % x.dim()
    s = torch.argsort(x, dim=ax, stable=True)
    if not attrs.is_ascend:
        s = torch.flip(s, (ax,))
    return s.to(_index_dtype(attrs))


_reg("argsort", _argsort,
     params={"axis": (int, -1), "is_ascend": (bool, True),
             "dtype": ("dtype", None)})


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------


def _histogram(attrs, data, *bins):
    """``jnp.histogram`` of the flattened data: counts in bins [e_i,
    e_i+1), the last one closed; returns (counts, edges). Without a bins
    input the edges span ``range`` (or the data's min and max, widened by
    0.5 either way when they are equal) in ``bin_cnt`` steps."""
    x = _float(data.reshape(-1))
    if bins:
        edges = bins[0]
    else:
        if attrs.range:
            lo, hi = float(attrs.range[0]), float(attrs.range[1])
        else:
            lo, hi = float(x.min()), float(x.max())
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, (attrs.bin_cnt or 10) + 1,
                               dtype=x.dtype, device=x.device)
    nb = edges.shape[0] - 1
    e = edges.to(x.dtype)
    slot = torch.bucketize(x, e, right=True) - 1
    slot = torch.where(x == e[-1], torch.full_like(slot, nb - 1), slot)
    slot = torch.where((x < e[0]) | (x > e[-1]) | (slot < 0),
                       torch.full_like(slot, nb), slot)
    counts = torch.bincount(slot, minlength=nb + 1)[:nb]
    return counts, edges


_reg("_histogram", _histogram,
     params={"bin_cnt": (int, None), "range": (tuple, None)},
     inputs=("data",), num_outputs=2)
