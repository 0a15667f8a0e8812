"""``mx.nd``: NDArray plus one function per registered op, generated from
the registry as the JAX package's ``ndarray/__init__.py`` does,
``invoke``, the way ``F.invoke`` reaches an op by name, the creation and
module-level functions (``full``, ``arange``, ``stack``, ``waitall``,
``moveaxis``, ``histogram``, the dlpack pair, ...) and the reference's
aliases (``power``, ``maximum``, ``equal``, ...), ``nd.random`` (the
samplers), ``nd.sparse`` (CSR and row_sparse storage), ``nd.contrib``,
the ``_contrib_*`` ops under their short names, and ``save``/``load`` of
the ``.params`` container (:mod:`.io_utils`)."""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..ops.registry import OP_REGISTRY as _REG
from . import io_utils  # noqa: F401
from .io_utils import load, save
from .ndarray import (NDArray, arange, array, concat, concatenate, empty,
                      eye, from_dlpack, full, histogram, imdecode, invoke,
                      logical_and, logical_or, logical_xor, modulo, moveaxis,
                      onehot_encode, ones, stack, to_dlpack_for_read,
                      to_dlpack_for_write, true_divide, waitall, zeros)
from . import random  # noqa: F401
from . import sparse  # noqa: F401
from .sparse import CSRNDArray, RowSparseNDArray

__all__ = ["NDArray", "array", "invoke", "ones", "zeros", "full", "empty",
           "arange", "eye", "concat", "stack", "waitall", "onehot_encode",
           "concatenate", "moveaxis", "histogram", "logical_and",
           "logical_or", "logical_xor", "modulo", "true_divide", "imdecode",
           "to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack",
           "random", "save", "load", "sparse", "RowSparseNDArray",
           "CSRNDArray"]


def _make_op_func(_name):
    _param_names = list(_REG[_name].params.keys())

    def _fn(*args, out=None, **kwargs):
        # MXNet's generated-wrapper convention: leading positional arrays
        # (or None) are inputs; trailing positional scalars fill the op's
        # parameters in declaration order
        arrays = []
        scalars = []
        for a in args:
            if isinstance(a, NDArray) or a is None or (
                    not isinstance(a, (int, float, str, tuple, list, bool))
                    and hasattr(a, "shape")):
                arrays.append(a)
            else:
                scalars.append(a)
        if scalars:
            free = [p for p in _param_names if p not in kwargs]
            for p, v in zip(free, scalars):
                kwargs[p] = v
        return invoke(_name, *arrays, out=out, **kwargs)

    _fn.__name__ = _name
    _fn.__qualname__ = _name
    _fn.__doc__ = _REG[_name].doc
    return _fn


_mod = _sys.modules[__name__]
for _opname in list(_REG):
    if not hasattr(_mod, _opname):
        setattr(_mod, _opname, _make_op_func(_opname))

add = getattr(_mod, "broadcast_add")
subtract = getattr(_mod, "broadcast_sub")
multiply = getattr(_mod, "broadcast_mul")
divide = getattr(_mod, "broadcast_div")
split = getattr(_mod, "SliceChannel")
power = getattr(_mod, "broadcast_power")
maximum = getattr(_mod, "broadcast_maximum")
minimum = getattr(_mod, "broadcast_minimum")
equal = getattr(_mod, "broadcast_equal")
not_equal = getattr(_mod, "broadcast_not_equal")
greater = getattr(_mod, "broadcast_greater")
greater_equal = getattr(_mod, "broadcast_greater_equal")
lesser = getattr(_mod, "broadcast_lesser")
lesser_equal = getattr(_mod, "broadcast_lesser_equal")

from . import contrib  # noqa: E402  (reads the generated functions above)
