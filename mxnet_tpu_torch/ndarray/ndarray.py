"""NDArray over a ``torch.Tensor``: the port of
``mxnet_tpu/ndarray/ndarray.py``.

An :class:`NDArray` holds one tensor on the CPU or the card; its context
is the tensor's device. :func:`invoke` is the eager op dispatch of the
JAX package (``ndarray.py:552-641``): it parses the op's attrs, runs the
registered ``fcompute`` on the tensors and wraps the outputs. While
``autograd.record()`` is active and an input is in the graph, it runs
with torch autograd on, so the outputs carry torch's graph; otherwise it
runs under ``torch.no_grad()``.

Inside :func:`no_host_reads`, ``asnumpy`` (and so ``asscalar``,
``float()`` and ``int()``) raises: a captured step cannot read a value
back to the host, and ``trainplane`` runs its first pass under it on
every device, so a forward that reads back is refused on the CPU as the
card's capture refuses it.

Rebinding follows the JAX package: in-place operators (``+=``) and
``out=`` rebind ``_data`` to a new tensor and never write into the old
one, so an op recorded earlier keeps the value it saw (and torch's
version counter never fires). Only the optimizer writes in place, under
``torch.no_grad()`` outside ``record()``.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, current_context, from_device
from ..ops.registry import get_op

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "no_host_reads"]

_HOST_READS = threading.local()


@contextlib.contextmanager
def no_host_reads(what):
    """Make a read back to the host (``asnumpy``) raise inside, naming
    ``what``."""
    prev = getattr(_HOST_READS, "refused_by", None)
    _HOST_READS.refused_by = what
    try:
        yield
    finally:
        _HOST_READS.refused_by = prev


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "_marked", "_leaf",
                 "_fresh_grad", "__weakref__")

    def __init__(self, data):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %s"
                             % type(data).__name__)
        self._data = data
        self._grad: Optional["NDArray"] = None
        self._grad_req = "null"
        self._marked = False  # True once attach_grad() marks a leaf
        self._leaf: Optional[torch.Tensor] = None  # the marked leaf tensor

    # -- properties ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return int(self._data.numel())

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return from_device(self._data.device)

    ctx = context

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    # -- conversion / sync ------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        what = getattr(_HOST_READS, "refused_by", None)
        if what is not None:
            raise MXNetError("%s: the step reads a value back to the host, "
                             "which a captured step cannot do" % what)
        t = self._data.detach()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __array__(self, dtype=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self.context)

    def astype(self, dtype) -> "NDArray":
        """A copy cast to ``dtype``."""
        return NDArray(self._data.detach().to(torch_dtype(dtype), copy=True))

    def copy(self) -> "NDArray":
        return invoke("_copy", self)

    def copyto(self, other) -> "NDArray":
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device()))
        if isinstance(other, NDArray):
            other._data = self._data.detach().to(other._data.device)
            return other
        raise MXNetError("copyto: unsupported target %r" % (other,))

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark this array as a gradient leaf with a zero ``.grad``."""
        _make_leaf(self, grad_req)
        self._grad = NDArray(torch.zeros_like(self._data))
        # a leaf no backward has reached yet is stale (Trainer's
        # ignore_stale_grad contract holds from the first step)
        self._fresh_grad = False

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    @property
    def _in_graph(self) -> bool:
        return self._data.requires_grad

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, key):
        """Basic and advanced indexing (a view for basic slices, as in
        MXNet); differentiable under ``record()``."""
        from .. import autograd

        if isinstance(key, NDArray):
            key = key._data.long()
        with torch.set_grad_enabled(autograd.is_recording()
                                    and self._in_graph):
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """``x[key] = value``: rebinds to a new tensor with the slice
        replaced (an op recorded earlier keeps the value it saw)."""
        if isinstance(value, NDArray):
            v = value._data.detach()
        elif isinstance(value, (int, float, bool, np.generic)):
            v = value
        else:
            v = torch.as_tensor(np.asarray(value))
        new = self._data.detach().clone()
        new[key] = v.to(new) if isinstance(v, torch.Tensor) else v
        self._data = new

    # -- op methods -------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape")
        return invoke("Reshape", self, shape=shape,
                      reverse=kwargs.get("reverse", False))

    def transpose(self, axes=None):
        return invoke("transpose", self, axes=axes)

    def swapaxes(self, dim1, dim2):
        return invoke("SwapAxis", self, dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("SliceChannel", self, num_outputs=num_outputs,
                      axis=axis, squeeze_axis=squeeze_axis)

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("pick", self, index, axis=axis, keepdims=keepdims)

    def softmax(self, axis=-1):
        return invoke("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", self, axis=axis)

    def sum(self, axis=None, keepdims=False, exclude=False):
        return invoke("sum", self, axis=axis, keepdims=keepdims,
                      exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return invoke("mean", self, axis=axis, keepdims=keepdims,
                      exclude=exclude)

    def square(self):
        return invoke("square", self)

    def abs(self):
        return invoke("abs", self)

    # -- arithmetic (broadcast semantics) ---------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(op, a, b)
        if isinstance(other, (int, float, np.generic)):
            return invoke(scalar_op, self, scalar=float(other))
        if isinstance(other, np.ndarray):
            o = array(other, ctx=self.context, dtype=self._data.dtype)
            a, b = (o, self) if reverse else (self, o)
            return invoke(op, a, b)
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        if isinstance(o, (int, float, np.generic)):
            return invoke("_rminus_scalar", self, scalar=float(o))
        return self._binop(o, "broadcast_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        if isinstance(o, (int, float, np.generic)):
            return invoke("_rdiv_scalar", self, scalar=float(o))
        return self._binop(o, "broadcast_div", "_div_scalar", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        if isinstance(o, (int, float, np.generic)):
            return invoke("_rmod_scalar", self, scalar=float(o))
        return self._binop(o, "broadcast_mod", "_mod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        if isinstance(o, (int, float, np.generic)):
            return invoke("_rpower_scalar", self, scalar=float(o))
        return NotImplemented

    def __neg__(self):
        return invoke("negative", self)

    def __abs__(self):
        return invoke("abs", self)

    # comparisons are elementwise, 1 or 0 in the input's dtype, as the
    # reference's (mxnet_tpu/ndarray/ndarray.py); hashing stays by identity
    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # in place: rebind the tensor (an earlier recorded op keeps its input)
    def __iadd__(self, o):
        self._data = self.__add__(o)._data
        return self

    def __isub__(self, o):
        self._data = self.__sub__(o)._data
        return self

    def __imul__(self, o):
        self._data = self.__mul__(o)._data
        return self

    def __itruediv__(self, o):
        self._data = self.__truediv__(o)._data
        return self


#: every live NDArray marked as a leaf (backward's candidates)
_MARKED: "weakref.WeakSet[NDArray]" = weakref.WeakSet()
_MARKED_LOCK = threading.Lock()


def _make_leaf(arr: NDArray, grad_req: str):
    """Make ``arr``'s tensor a torch leaf that backward maps back to
    ``arr``: a fresh detached tensor (sharing storage) that requires grad
    when its dtype can carry one, kept in ``arr._leaf`` (``_data`` may be
    rebound later; the graph holds the leaf). A 'null' leaf is in the
    graph too, as in the JAX package; backward just gives it nothing."""
    if grad_req not in ("write", "add", "null"):
        raise MXNetError("grad_req must be write, add, or null, got %r"
                         % (grad_req,))
    arr._marked = True
    arr._grad_req = grad_req
    t = arr._data.detach()
    if t.is_floating_point() or t.is_complex():
        t.requires_grad_(True)
        arr._leaf = t
    else:
        arr._leaf = None
    arr._data = t
    with _MARKED_LOCK:
        _MARKED.add(arr)


# ---------------------------------------------------------------------------
# eager dispatch
# ---------------------------------------------------------------------------


def invoke(op_name: str, *inputs, out=None, **kwargs):
    """Run registered op ``op_name`` on ``inputs`` (NDArrays, ``None`` for
    an absent optional input, or array-likes) and return NDArray
    output(s); ``out=`` rebinds the given NDArray(s) to the result."""
    from .. import autograd

    opdef = get_op(op_name)
    attrs = opdef.parse_attrs(kwargs)
    nds: List[Optional[NDArray]] = [i if isinstance(i, NDArray) else None
                                    for i in inputs]
    first = next((nd for nd in nds if nd is not None), None)
    dev = first._data.device if first is not None \
        else current_context().torch_device()
    datas = []
    for i, nd in zip(inputs, nds):
        if nd is not None:
            datas.append(nd._data)
        elif i is None:
            datas.append(None)
        else:
            datas.append(torch.as_tensor(np.asarray(i), device=dev))
    record = autograd.is_recording() and any(
        nd is not None and nd._in_graph for nd in nds)
    with torch.set_grad_enabled(record):
        outputs = opdef.fcompute(attrs, *datas)
    if isinstance(outputs, (tuple, list)):
        result = [NDArray(o) for o in outputs]
    else:
        result = NDArray(outputs)
    return _bind_out(out, result)


def _bind_out(out, result):
    if out is None:
        return result
    if isinstance(out, NDArray) and isinstance(result, NDArray):
        out._data = result._data
        return out
    if isinstance(out, (list, tuple)) and isinstance(result, list) \
            and len(out) == len(result):
        for o, r in zip(out, result):
            o._data = r._data
        return out
    raise MXNetError("out= does not match the op's outputs")


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def _device(ctx) -> torch.device:
    return (ctx or current_context()).torch_device()


def _dtype(dtype, default=torch.float32) -> torch.dtype:
    return default if dtype is None else torch_dtype(dtype)


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray from an array-like (float64 becomes float32, as in the
    JAX package), on ``ctx`` or the current context."""
    data = source.asnumpy() if isinstance(source, NDArray) \
        else np.asarray(source)
    if dtype is None:
        dtype = np.float32 if data.dtype == np.float64 else data.dtype
    dev = _device(ctx)
    td = torch_dtype(dtype)
    # a copy, as MXNet's nd.array makes: the array never aliases source
    host = np.array(data, np.float32 if td == torch.bfloat16
                    else np.dtype(np_dtype(dtype)))
    return NDArray(torch.from_numpy(host).to(device=dev, dtype=td))


def zeros(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return NDArray(torch.zeros(shape, dtype=_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return NDArray(torch.ones(shape, dtype=_dtype(dtype),
                              device=_device(ctx)))
