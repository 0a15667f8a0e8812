"""Sparse NDArrays: the port of ``mxnet_tpu/ndarray/sparse.py``.

A :class:`CSRNDArray` keeps its ``(data, indices, indptr)`` triple on its
device and builds its dense value only when something reads it (an op
without a sparse path, ``asnumpy``), then keeps it. The JAX package
builds that dense array at construction (``mxnet_tpu/ndarray/
sparse.py:93``); the values are the same, only where they are kept
differs, and a batch of an Avazu-sized LibSVM file (8192 x 1,000,000)
made dense would take 32.8 GB. A :class:`RowSparseNDArray` has its
parameter's dense shape, so it keeps a dense copy from the start, as the
JAX package does.

Sparse arrays are immutable: an in-place operator or ``out=`` on one
raises, as in the JAX package (``_bind_out``). Row indices are kept
sorted and unique (the ex ops binary-search them).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import from_device
from ..ops.sparse import SparseRep, densify
from .ndarray import NDArray, array, invoke

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "retain",
           "dot", "zeros"]


class BaseSparseNDArray(NDArray):
    """The common part: shape, dtype and context come from the
    components, and the dense value (``_data``) is built on first read."""

    __slots__ = ("_dense", "_full_shape")

    def _init_base(self, shape):
        self._dense = None
        self._full_shape = tuple(int(s) for s in shape)
        self._grad = None
        self._grad_req = "null"
        self._marked = False
        self._leaf = None

    @property
    def _data(self) -> torch.Tensor:
        if self._dense is None:
            self._dense = densify(self.rep())
        return self._dense

    @_data.setter
    def _data(self, value):
        raise MXNetError("a sparse NDArray cannot be written in place; "
                         "rebind the result instead (sparse NDArrays are "
                         "immutable views)")

    def rep(self) -> SparseRep:
        raise NotImplementedError

    @property
    def shape(self):
        return self._full_shape

    @property
    def dtype(self):
        return np_dtype(self.rep().data.dtype)

    @property
    def size(self) -> int:
        return int(np.prod(self._full_shape))

    @property
    def ndim(self) -> int:
        return len(self._full_shape)

    @property
    def context(self):
        return from_device(self.rep().data.device)

    ctx = context

    @property
    def _in_graph(self) -> bool:
        return False  # no gradient reaches a sparse operand

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError("attach_grad on a sparse NDArray: the sparse "
                         "operand of an op gets no gradient")

    def copyto(self, other):
        from ..context import Context

        if isinstance(other, Context):
            dev = other.torch_device()
            r = self.rep()
            return _wrap(SparseRep(
                r.stype, r.data.to(dev), r.indices.to(dev),
                None if r.indptr is None else r.indptr.to(dev), r.shape))
        raise MXNetError("copyto: a sparse array copies to a Context")

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                   "x".join(map(str, self.shape)),
                                   self.context)


class RowSparseNDArray(BaseSparseNDArray):
    """Values ``(rows, *row_shape)`` of the sorted unique row ids
    ``indices``; the other rows are zero."""

    __slots__ = ("_values", "_indices")

    def __init__(self, values, indices, shape):
        self._init_base(shape)
        self._values = values._data if isinstance(values, NDArray) \
            else values
        self._indices = (indices._data if isinstance(indices, NDArray)
                         else indices).to(torch.int64)
        self._dense = densify(self.rep())

    def rep(self) -> SparseRep:
        return SparseRep("row_sparse", self._values, self._indices, None,
                         self._full_shape)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices)

    @property
    def data(self) -> NDArray:
        return NDArray(self._values)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        return cast_storage(self, stype)

    def retain(self, row_ids) -> "RowSparseNDArray":
        return invoke("_sparse_retain", self, row_ids)


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix: ``data`` and column ``indices`` of
    the stored values, row offsets ``indptr``."""

    __slots__ = ("_csr_data", "_csr_indices", "_csr_indptr")

    def __init__(self, data, indices, indptr, shape):
        self._init_base(shape)
        self._csr_data = data._data if isinstance(data, NDArray) else data
        self._csr_indices = (indices._data if isinstance(indices, NDArray)
                             else indices).to(torch.int64)
        self._csr_indptr = (indptr._data if isinstance(indptr, NDArray)
                            else indptr).to(torch.int64)

    def rep(self) -> SparseRep:
        return SparseRep("csr", self._csr_data, self._csr_indices,
                         self._csr_indptr, self._full_shape)

    @property
    def stype(self):
        return "csr"

    @property
    def data(self) -> NDArray:
        return NDArray(self._csr_data)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._csr_indices)

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._csr_indptr)

    @property
    def densified(self) -> bool:
        """Whether the dense value has been built (a read without a sparse
        path builds it)."""
        return self._dense is not None

    def tostype(self, stype):
        if stype == "csr":
            return self
        return cast_storage(self, stype)


def _wrap(rep: SparseRep) -> BaseSparseNDArray:
    if rep.stype == "row_sparse":
        return RowSparseNDArray(rep.data, rep.indices, rep.shape)
    return CSRNDArray(rep.data, rep.indices, rep.indptr, rep.shape)


def _component(x, ctx, dtype):
    """A component as a tensor: an NDArray keeps its device (cast to
    ``dtype`` if given), anything else goes through ``array``."""
    if isinstance(x, NDArray):
        t = x._data.detach()
        return t if dtype is None else t.to(torch_dtype(dtype))
    return array(x, ctx=ctx, dtype=dtype)._data


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(values, row ids)`` (unsorted ids are
    sorted, the values with them) or from a dense array-like."""
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2:
        values, indices = arg1
        idx = np.asarray(indices.asnumpy() if isinstance(indices, NDArray)
                         else indices, np.int64)
        val = values.asnumpy() if isinstance(values, NDArray) \
            else np.asarray(values)
        if idx.size > 1 and np.any(np.diff(idx) < 0):
            order = np.argsort(idx, kind="stable")
            idx, val = idx[order], val[order]
        v = array(val, ctx=ctx, dtype=dtype)._data
        i = array(idx, ctx=ctx, dtype="int64")._data
        return RowSparseNDArray(v, i, shape)
    return cast_storage(array(arg1, ctx=ctx, dtype=dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` (NDArrays stay on
    their device, no host copy) or from a dense array-like."""
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data, indices, indptr = arg1
        d = _component(data, ctx, dtype)
        i = _component(indices, ctx, "int64")
        p = _component(indptr, ctx, "int64")
        if shape is None:
            raise MXNetError("csr_matrix from components needs shape=")
        return CSRNDArray(d, i, p, shape)
    return cast_storage(array(arg1, ctx=ctx, dtype=dtype), "csr")


def cast_storage(arr: NDArray, stype: str):
    """The registered op ``cast_storage`` (its ex path)."""
    return invoke("cast_storage", arr, stype=stype)


def retain(arr: RowSparseNDArray, row_ids):
    """The registered op ``_sparse_retain``."""
    return invoke("_sparse_retain", arr, row_ids)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``dot`` with a sparse operand (the reference's
    ``mx.nd.sparse.dot``)."""
    return invoke("dot", lhs, rhs, transpose_a=transpose_a,
                  transpose_b=transpose_b)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage ``stype``."""
    from .ndarray import zeros as dense_zeros

    d = dense_zeros(shape, ctx=ctx, dtype=dtype)
    return cast_storage(d, stype) if stype != "default" else d
