"""Custom operators written in Python, the port of ``mxnet_tpu/operator.py``
(reference ``python/mxnet/operator.py``: CustomOp :426, CustomOpProp
:472, register :692).

A :class:`CustomOpProp` registered under a name describes an op (its
inputs, outputs, shapes and types) and makes its :class:`CustomOp`, whose
``forward``/``backward`` take NDArrays. The registered op ``Custom``
(``nd.Custom``, ``sym.Custom``) runs it through a
``torch.autograd.Function``:

* forward wraps the input tensors as NDArrays on their own device,
  allocates the outputs from ``prop.infer_shape``/``infer_type``, and
  runs ``op.forward`` with recording paused (``is_train`` is
  ``autograd.is_training()``, which the executor sets) and the inputs'
  context current, so arrays the op makes land beside its inputs;
* backward runs ``op.backward(["write"] * n, out_grad, in_data,
  out_data, in_grad, [])`` on the same op object and hands torch the
  gradients of the inputs that need one.

Where the JAX package escapes its compiled graph with ``pure_callback``
and a ``custom_vjp``, copying every input to the host, the port runs
eagerly: ``in_data`` stays on the device it came from, and an op may
launch device kernels on it (``rtc.CudaModule``). ``create_operator``
gets the inputs' :class:`Context` (the JAX package passes None). On
``meta`` tensors (``Symbol.infer_shape``) the op returns outputs shaped
by the prop and never calls the user's code.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import autograd
from .base import MXNetError, np_dtype, torch_dtype
from .context import from_device
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]

_CUSTOM_REGISTRY: Dict[str, type] = {}


class CustomOp(object):
    """Base for custom op implementations (reference operator.py:426)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` under the request: ``write`` and
        ``inplace`` rebind ``dst`` to ``src`` on ``dst``'s device and
        dtype, ``add`` adds to it, ``null`` leaves it (reference
        operator.py CustomOp.assign)."""
        if req == "null":
            return
        data = src._data if hasattr(src, "_data") else torch.as_tensor(src)
        data = data.detach().to(device=dst._data.device,
                                dtype=dst._data.dtype)
        if req in ("write", "inplace"):
            dst._data = data
        elif req == "add":
            dst._data = dst._data + data
        else:
            raise MXNetError("unknown req %r" % req)


class CustomOpProp(object):
    """Describes a custom op: interface names, shapes, and instantiation
    (reference operator.py:472)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Class decorator registering a CustomOpProp under ``op_type``
    (reference operator.py:692); usable afterwards as
    ``mx.nd.Custom(..., op_type=reg_name)`` and ``mx.sym.Custom``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered():
    return dict(_CUSTOM_REGISTRY)


def _make_prop(attrs):
    op_type = attrs.get("op_type")
    if not op_type or op_type not in _CUSTOM_REGISTRY:
        raise MXNetError(
            "Custom: op_type %r is not registered (use "
            "mx.operator.register)" % (op_type,))
    kwargs = {k: v for k, v in attrs.items()
              if k not in ("op_type",) and not k.startswith("__")}
    return _CUSTOM_REGISTRY[op_type](**kwargs)


def fill_input_shapes(attrs, in_shapes):
    """The input shapes ``prop.infer_shape`` gives for a ``Custom`` node
    whose inputs are partly unknown (an unknown one passed as ``[]``, as
    the reference does), for ``Symbol.infer_shape`` to back-fill (the
    label of a loss op). None when the prop cannot tell from what is
    known."""
    prop = _make_prop(attrs)
    try:
        filled, _, _ = prop.infer_shape(
            [list(s) if s is not None else [] for s in in_shapes])
    except (IndexError, TypeError):  # it needs an input that is unknown
        return None
    return [tuple(int(d) for d in f) if old is None and f else old
            for old, f in zip(in_shapes, filled)]


def _custom_inputs(attrs):
    return list(_make_prop(attrs).list_arguments())


def _custom_num_outputs(attrs):
    return len(_make_prop(attrs).list_outputs())


def _obj(v):
    return v


class _CustomFunction(torch.autograd.Function):
    """The torch node of one ``Custom`` call."""

    @staticmethod
    def forward(ctx, prop, out_specs, is_train, *xs):
        from .ndarray.ndarray import NDArray

        dev = xs[0].device
        op = prop.create_operator(from_device(dev),
                                  [list(x.shape) for x in xs],
                                  [np_dtype(x.dtype) for x in xs])
        in_nd = [NDArray(x.detach()) for x in xs]
        out_nd = [NDArray(torch.zeros(s, dtype=dt, device=dev))
                  for s, dt in out_specs]
        with from_device(dev), autograd.pause(train_mode=is_train):
            op.forward(is_train, ["write"] * len(out_nd), in_nd, out_nd, [])
        outs = []
        for o, (s, dt) in zip(out_nd, out_specs):
            t = o._data.to(device=dev, dtype=dt)
            if tuple(t.shape) != tuple(s):
                raise MXNetError("Custom: forward wrote an output of shape "
                                 "%s, infer_shape says %s"
                                 % (tuple(t.shape), tuple(s)))
            # an input handed back as it is would alias the node's input
            outs.append(t.clone() if any(t is x for x in xs) else t)
        ctx.op = op
        ctx.save_for_backward(*xs, *outs)
        ctx.n_in = len(xs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        dev = xs[0].device
        in_nd = [NDArray(x) for x in xs]
        out_nd = [NDArray(o) for o in outs]
        og_nd = [NDArray(g if g is not None else torch.zeros_like(o))
                 for g, o in zip(grads, outs)]
        in_grad = [NDArray(torch.zeros_like(x)) for x in xs]
        with from_device(dev), autograd.pause():
            ctx.op.backward(["write"] * len(xs), og_nd, in_nd, out_nd,
                            in_grad, [])
        return (None, None, None) + tuple(
            g._data.to(device=x.device, dtype=x.dtype) if need else None
            for g, x, need in zip(in_grad, xs, ctx.needs_input_grad[3:]))


@_register_op("Custom",
              params={"op_type": (_obj, None)},
              inputs=_custom_inputs, num_outputs=_custom_num_outputs)
def _custom_fcompute(attrs, *inputs):
    """Run a registered CustomOp: through :class:`_CustomFunction` on real
    tensors, or as outputs shaped by the prop on ``meta`` ones."""
    prop = _make_prop(attrs)
    _, out_shapes, _ = prop.infer_shape([list(x.shape) for x in inputs])
    _, out_types, _ = prop.infer_type([np_dtype(x.dtype) for x in inputs])
    out_specs = [(tuple(int(d) for d in s), torch_dtype(dt))
                 for s, dt in zip(out_shapes, out_types)]
    if any(x.device.type == "meta" for x in inputs):
        outs = tuple(torch.empty(s, dtype=dt, device="meta")
                     for s, dt in out_specs)
    else:
        outs = _CustomFunction.apply(prop, out_specs,
                                     autograd.is_training(), *inputs)
    return outs if len(outs) > 1 else outs[0]
