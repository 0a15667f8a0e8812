"""NDArray over a ``torch.Tensor``: the port of
``mxnet_tpu/ndarray/ndarray.py``.

An :class:`NDArray` holds one tensor on the CPU or the card; its context
is the tensor's device. :func:`invoke` is the eager op dispatch of the
JAX package (``ndarray.py:552-641``): it parses the op's attrs, runs the
registered ``fcompute`` on the tensors and wraps the outputs (an op with
no array input, ``_zeros`` or ``_random_uniform``, makes its result on
the context of ``ctx=`` or the current one). While
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
import torch.utils.dlpack

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, current_context, from_device
from ..ops.registry import get_op
from ..ops.tensor import out_device

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "eye", "concat", "stack", "waitall", "onehot_encode",
           "concatenate", "moveaxis", "histogram", "logical_and",
           "logical_or", "logical_xor", "modulo", "true_divide", "imdecode",
           "to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack",
           "no_host_reads"]

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
                 "_fresh_grad", "_cpu_id", "__weakref__")

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
        """The array's device as a context; a host array keeps the ``i``
        of the ``cpu(i)`` it was made for (several contexts in one
        process: every ``cpu(i)`` is the host)."""
        dev = self._data.device
        if dev.type == "cpu":
            return Context("cpu", getattr(self, "_cpu_id", 0))
        return from_device(dev)

    ctx = context

    @property
    def stype(self) -> str:
        """The storage type: always ``'default'`` (dense) in the port."""
        return "default"

    @property
    def T(self) -> "NDArray":
        """The transpose (all axes reversed); differentiable."""
        return invoke("transpose", self)

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

        def copy():
            # a copy, as MXNet's: a host tensor's numpy() shares its
            # memory, which an in-place optimizer step would write into
            return t.numpy().copy() if t.device.type == "cpu" \
                else t.cpu().numpy()

        from .. import resilience, telemetry

        # chaos site transfer.asnumpy, as the JAX package's: under an
        # active schedule the copy can fault and retries under the policy;
        # with chaos off this is one module-global boolean
        if resilience.chaos.ENABLED:
            def attempt():
                resilience.chaos.maybe_fail("transfer.asnumpy")
                return copy()

            out = resilience.call("transfer.asnumpy", attempt)
        else:
            out = copy()
        telemetry.record_transfer("asnumpy", (out,))
        return out

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
        return _like(self, NDArray(self._data.detach().to(torch_dtype(dtype),
                                                          copy=True)))

    def copy(self) -> "NDArray":
        return invoke("_copy", self)

    def copyto(self, other) -> "NDArray":
        if isinstance(other, Context):
            # a copy always, as MXNet's: cpu(0) and cpu(1) are one device
            return _on(NDArray(cross_copy(self._data.detach(),
                                          other.torch_device(), "copyto",
                                          copy=True)), other)
        if isinstance(other, NDArray):
            other._data = self._data.detach().to(other._data.device)
            return other
        raise MXNetError("copyto: unsupported target %r" % (other,))

    def as_in_context(self, ctx: Context) -> "NDArray":
        """This array if it is on ``ctx`` already, else a copy there."""
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def wait_to_read(self):
        """Wait until the work queued on this array's stream is done (its
        device's current stream; the host's arrays are always ready)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def tostype(self, stype):
        """``'default'`` gives a copy; ``'csr'`` or ``'row_sparse'`` the
        sparse array (``cast_storage``)."""
        if stype == "default":
            return self.copy()
        from .sparse import cast_storage

        return cast_storage(self, stype)

    def to_dlpack_for_read(self):
        """A DLPack capsule sharing this array's memory, after its stream
        is done (``torch.utils.dlpack``)."""
        self.wait_to_read()
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    def to_dlpack_for_write(self):
        """A DLPack capsule through which the consumer may write this
        array's memory in place, as MXNet's (the JAX package refuses it:
        XLA buffers are immutable)."""
        return self.to_dlpack_for_read()

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark this array as a gradient leaf with a zero ``.grad``. The
        gradient is dense whatever ``stype`` asks, as in the JAX package
        (a sparse dot's gradient reaches a dense weight densely)."""
        if stype not in (None, "default", "row_sparse", "csr"):
            raise MXNetError("attach_grad: unknown stype %r" % (stype,))
        _make_leaf(self, grad_req)
        self._grad = _like(self, NDArray(torch.zeros_like(self._data)))
        # a leaf no backward has reached yet is stale (Trainer's
        # ignore_stale_grad contract holds from the first step)
        self._fresh_grad = False

    def detach(self) -> "NDArray":
        return _like(self, NDArray(self._data.detach()))

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
            return _like(self, NDArray(self._data[key]))

    def __setitem__(self, key, value):
        """``x[key] = value``: rebinds to a new tensor with the slice
        replaced (an op recorded earlier keeps the value it saw). An array
        marked by ``attach_grad`` stays a gradient leaf, with its
        ``.grad``, as in the JAX package."""
        if isinstance(value, NDArray):
            v = value._data.detach()
        elif isinstance(value, (int, float, bool, np.generic)):
            v = value
        else:
            v = torch.as_tensor(np.asarray(value))
        new = self._data.detach().clone()
        new[key] = v.to(new) if isinstance(v, torch.Tensor) else v
        self._data = new
        if self._marked:
            _make_leaf(self, self._grad_req)

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

    def reshape_like(self, other):
        return invoke("reshape_like", self, other)

    def expand_dims(self, axis):
        return invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return invoke("squeeze", self, axis=axis)

    def flatten(self):
        return invoke("Flatten", self)

    def flip(self, axis):
        return invoke("reverse", self, axis=axis)

    def slice(self, begin, end, step=None):
        return invoke("slice", self, begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, **kw):
        return invoke("one_hot", self, depth=depth, **kw)

    def tile(self, reps):
        return invoke("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return invoke("repeat", self, repeats=repeats, axis=axis)

    def broadcast_to(self, shape):
        return invoke("broadcast_to", self, shape=shape)

    def broadcast_like(self, other):
        return invoke("broadcast_like", self, other)

    def pad(self, mode, pad_width, constant_value=0.0):
        return invoke("Pad", self, mode=mode, pad_width=pad_width,
                      constant_value=constant_value)

    def clip(self, a_min, a_max):
        return invoke("clip", self, a_min=a_min, a_max=a_max)

    def sign(self):
        return invoke("sign", self)

    def sqrt(self):
        return invoke("sqrt", self)

    def exp(self):
        return invoke("exp", self)

    def log(self):
        return invoke("log", self)

    def relu(self):
        return invoke("relu", self)

    def sigmoid(self):
        return invoke("sigmoid", self)

    def tanh(self):
        return invoke("tanh", self)

    def prod(self, axis=None, keepdims=False):
        return invoke("prod", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return invoke("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return invoke("min", self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return invoke("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return invoke("argmin", self, axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", self, axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", self, axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke("topk", self, axis=axis, k=k, ret_typ=ret_typ,
                      is_ascend=is_ascend)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", self, other, transpose_a=transpose_a,
                      transpose_b=transpose_b)

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


from .. import profiler as _profiler  # noqa: E402


# a profiler region of category "operator" named by the op, as the JAX
# package's; with the profiler off the wrapper returns at once (one flag
# read and one extra Python call an op)
@_profiler.profiled("operator", lambda op_name, *i, **kw: op_name)
def invoke(op_name: str, *inputs, out=None, **kwargs):
    """Run registered op ``op_name`` on ``inputs`` (NDArrays, ``None`` for
    an absent optional input, or array-likes) and return NDArray
    output(s); ``out=`` rebinds the given NDArray(s) to the result."""
    from .. import autograd

    opdef = get_op(op_name)
    attrs = opdef.parse_attrs(kwargs)
    if opdef.fcompute_ex is not None:
        from .sparse import BaseSparseNDArray

        if opdef.dispatch_ex_always or any(
                isinstance(i, BaseSparseNDArray) for i in inputs):
            # an ex op without a gradient must not drop the tape: while
            # recording with a dense input in the graph, an op whose
            # dense fcompute is a full equivalent takes that path (the
            # sparse input's dense value read on the way)
            dense_tape = (opdef.ex_grad_fallback
                          and not opdef.ex_differentiable
                          and not opdef.dispatch_ex_always
                          and autograd.is_recording()
                          and any(isinstance(i, NDArray)
                                  and not isinstance(i, BaseSparseNDArray)
                                  and i._in_graph for i in inputs))
            if not dense_tape:
                return _invoke_ex(opdef, attrs, inputs, out)
    nds: List[Optional[NDArray]] = [i if isinstance(i, NDArray) else None
                                    for i in inputs]
    first = next((nd for nd in nds if nd is not None), None)
    if first is not None:
        dev = first._data.device
    else:  # no array input: the op makes its result on ctx= or the
        # current context (ops/tensor.py:out_device)
        dev = out_device(attrs)
        attrs["__device__"] = dev
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
        result = [_like(first, NDArray(o)) for o in outputs]
    else:
        result = _like(first, NDArray(outputs))
    return _bind_out(out, result)


def _invoke_ex(opdef, attrs, inputs, out):
    """The storage-type path: sparse inputs go in as ``SparseRep``s of
    their components, a ``SparseRep`` output comes back as a sparse
    NDArray. A ``differentiable`` ex op runs with autograd on while
    recording with a dense input in the graph; a sparse input's
    components carry no gradient (``mxnet_tpu/ndarray/ndarray.py:705``)."""
    from .. import autograd
    from ..ops.sparse import SparseRep
    from .sparse import BaseSparseNDArray, _wrap

    dev = next((i.context.torch_device() for i in inputs
                if isinstance(i, NDArray)), None)
    datas = []
    for i in inputs:
        if isinstance(i, BaseSparseNDArray):
            datas.append(i.rep())
        elif isinstance(i, NDArray):
            datas.append(i._data)
        elif i is None:
            datas.append(None)
        else:
            datas.append(torch.as_tensor(np.asarray(i), device=dev))
    record = (opdef.ex_differentiable and autograd.is_recording()
              and any(isinstance(i, NDArray)
                      and not isinstance(i, BaseSparseNDArray)
                      and i._in_graph for i in inputs))
    with torch.set_grad_enabled(record):
        outputs = opdef.fcompute_ex(attrs, *datas)

    def wrap(o):
        return _wrap(o) if isinstance(o, SparseRep) else NDArray(o)

    if isinstance(outputs, (tuple, list)) \
            and not isinstance(outputs, SparseRep):
        result = [wrap(o) for o in outputs]
    else:
        result = wrap(outputs)
    return _bind_out(out, result)


def _bind_out(out, result):
    """Rebind ``out=`` to the result. Sparse storage is refused on either
    side: a sparse array's components would go on describing the old
    value."""
    if out is None:
        return result
    from .sparse import BaseSparseNDArray

    for o in (list(out) if isinstance(out, (list, tuple)) else [out]) + (
            result if isinstance(result, list) else [result]):
        if isinstance(o, BaseSparseNDArray):
            raise MXNetError(
                "out= is not supported for sparse storage; rebind the "
                "result instead (sparse NDArrays are immutable views)")
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


def cross_copy(t: torch.Tensor, device: torch.device, site: str,
               copy: bool = False):
    """``t`` on ``device`` (``t`` itself where it lies there, unless
    ``copy``); a copy between the card and the host counts its bytes under
    ``site`` in ``mxnet_cross_device_bytes_total`` (the edges of several
    contexts in one process: a kvstore's reduce and pull, a batch's
    slices, a ``group2ctx`` graph's crossing tensors), and so does the
    gradient a backward sends back across it."""
    if t.device.type == torch.device(device).type:
        return t.to(device, copy=copy)
    from ..telemetry import registry as _registry

    counter = _registry.counter(
        "mxnet_cross_device_bytes_total",
        "bytes copied between the card and the host by the paths of "
        "several contexts in one process, by site", labels=("site",))
    counter.inc(t.numel() * t.element_size(), site=site)
    out = t.to(device, copy=copy)
    if out.requires_grad:
        out.register_hook(lambda g: counter.inc(
            g.numel() * g.element_size(), site=site))
    return out


def _on(nd: NDArray, ctx: Optional[Context]) -> NDArray:
    """``nd`` marked as made for ``ctx`` (the current context when None):
    a host array keeps which ``cpu(i)`` it is."""
    ctx = ctx or current_context()
    if ctx.device_type == "cpu" and ctx.device_id:
        nd._cpu_id = ctx.device_id
    return nd


def _like(src: Optional[NDArray], nd: NDArray) -> NDArray:
    """``nd`` on ``src``'s context: an op's output, a view or a copy of a
    host array keeps its ``cpu(i)``."""
    cid = getattr(src, "_cpu_id", 0)
    if cid and nd._data.device.type == "cpu":
        nd._cpu_id = cid
    return nd


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
    return _on(NDArray(torch.from_numpy(host).to(device=dev, dtype=td)), ctx)


def zeros(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return _on(NDArray(torch.zeros(shape, dtype=_dtype(dtype),
                                   device=_device(ctx))), ctx)


def ones(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return _on(NDArray(torch.ones(shape, dtype=_dtype(dtype),
                                  device=_device(ctx))), ctx)


def full(shape, val, ctx=None, dtype=None, **kw) -> NDArray:
    return _on(NDArray(torch.full(shape if isinstance(shape, (tuple, list))
                                  else (shape,), val, dtype=_dtype(dtype),
                                  device=_device(ctx))), ctx)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Zeros, as the JAX package's ``empty``."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    """numpy's ``arange`` (each value ``repeat`` times), on ``ctx``."""
    a = np.arange(start, stop, step, dtype=np.dtype(np_dtype(
        dtype or "float32")))
    if repeat > 1:
        a = np.repeat(a, repeat)
    return array(a, ctx=ctx, dtype=dtype or a.dtype)


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    return array(np.eye(N, M or None, k), ctx=ctx, dtype=dtype or "float32")


def concat(*args, dim=1, num_args=None):
    """Join the arrays (or one list of them) along ``dim``; ``num_args``,
    the op's attribute, may be given as it is to ``nd.Concat``."""
    arrs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return invoke("Concat", *arrs, num_args=len(arrs), dim=dim)


def stack(*args, axis=0, num_args=None):
    arrs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return invoke("stack", *arrs, num_args=len(arrs), axis=axis)


def waitall():
    """Wait for all queued work on every card (MXNet's
    ``Engine::WaitForAll``)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` into ``out`` (rebinds it)."""
    res = invoke("one_hot", indices, depth=out.shape[1])
    out._data = res._data
    return out


def concatenate(arrays, axis=0, always_copy=True):
    """Concatenate along an axis (the result is always a new tensor)."""
    return invoke("Concat", *arrays, dim=axis, num_args=len(arrays))


def moveaxis(tensor, source, destination):
    """Move axes as ``np.moveaxis``, through ``transpose``."""
    ndim = len(tensor.shape)
    src = [source] if isinstance(source, int) else list(source)
    dst = [destination] if isinstance(destination, int) \
        else list(destination)
    src = [s % ndim for s in src]
    dst = [d % ndim for d in dst]
    order = [a for a in range(ndim) if a not in src]
    for d, s in sorted(zip(dst, src)):
        order.insert(d, s)
    return invoke("transpose", tensor, axes=tuple(order))


def histogram(a, bins=10, range=None):
    """(counts, bin_edges) of ``a``: ``bins`` edges as an NDArray, or a
    count of equal bins over ``range`` (the data's min and max by
    default, read back to the host)."""
    if isinstance(bins, NDArray):
        return tuple(invoke("_histogram", a, bins,
                            bin_cnt=bins.shape[0] - 1))
    if range is None:
        amin = float(a.min().asnumpy())
        amax = float(a.max().asnumpy())
        range = (amin, amax if amax > amin else amin + 1.0)
    edges = np.linspace(range[0], range[1], bins + 1).astype(np.float32)
    return tuple(invoke("_histogram", a, array(edges, ctx=a.context),
                        bin_cnt=bins))


def logical_and(lhs, rhs):
    return invoke("broadcast_logical_and", lhs, rhs)


def logical_or(lhs, rhs):
    return invoke("broadcast_logical_or", lhs, rhs)


def logical_xor(lhs, rhs):
    return invoke("broadcast_logical_xor", lhs, rhs)


def modulo(lhs, rhs):
    return lhs % rhs


def true_divide(lhs, rhs):
    return lhs / rhs


def imdecode(buf, **kwargs):
    """Decode an image byte buffer (JPEG or PNG): ``image.imdecode``."""
    from .. import image as _image

    return _image.imdecode(buf, **kwargs)


def to_dlpack_for_read(data: NDArray):
    return data.to_dlpack_for_read()


def to_dlpack_for_write(data: NDArray):
    return data.to_dlpack_for_write()


def from_dlpack(obj, ctx: Optional[Context] = None) -> NDArray:
    """An NDArray over a DLPack capsule or an object with ``__dlpack__``
    (a torch tensor, a numpy array), sharing its memory; its context is
    the memory's device."""
    return NDArray(torch.utils.dlpack.from_dlpack(obj))
