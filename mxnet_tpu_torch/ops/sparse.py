"""Sparse operators: the storage-type path (FComputeEx) of
``mxnet_tpu/ops/sparse.py``, in PyTorch.

:func:`mxnet_tpu_torch.ndarray.invoke` routes a call here when an input
is a sparse NDArray (or the op sets ``always``, as ``cast_storage``
does, whose output is the sparse one). A sparse input arrives as a
:class:`SparseRep` of tensors on its device, a dense one as a tensor;
an output may be a ``SparseRep``, which ``invoke`` wraps as a sparse
NDArray. Nothing here builds a CSR matrix's dense value.

The JAX package lowers these to ``segment_sum`` over the stored values
(no Pallas kernel); here they are gathers (``index_select``) and
``index_add`` by row id, PyTorch's own. On the card ``index_add`` sums
with atomics, in no fixed order, so two runs may differ in the last bit.
Gradients: ``dot`` is differentiable with respect to its dense operand
only; a sparse operand's components never carry a gradient, as the
reference's sparse dot gives its csr input ``grad_req='null'``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..base import MXNetError
from . import tensor as _tensor  # noqa: F401  (registers dot, elemwise_*)
from .registry import REQUIRED, register, register_ex

__all__ = ["SparseRep", "csr_row_ids", "densify"]


class SparseRep(NamedTuple):
    """A sparse NDArray's components, as tensors on its device."""

    stype: str                       # "csr" or "row_sparse"
    data: torch.Tensor               # csr: (nnz,); rsp: (rows, *row)
    indices: torch.Tensor            # csr: column ids; rsp: sorted row ids
    indptr: Optional[torch.Tensor]   # csr: (rows + 1,) offsets
    shape: Tuple[int, ...]           # the dense shape


def csr_row_ids(rep: SparseRep) -> torch.Tensor:
    """The row of each stored value: ``searchsorted`` of its position in
    ``indptr`` (no host read of the row lengths)."""
    nnz = rep.data.shape[0]
    pos = torch.arange(nnz, device=rep.data.device, dtype=torch.int64)
    return torch.searchsorted(rep.indptr[1:].to(torch.int64), pos,
                              right=True)


def _seg_sum(vals, ids, num):
    out = torch.zeros((num,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, ids, vals)


def densify(rep: SparseRep) -> torch.Tensor:
    """The dense tensor a sparse value stands for."""
    out = torch.zeros(rep.shape, dtype=rep.data.dtype,
                      device=rep.data.device)
    if rep.stype == "row_sparse":
        out[rep.indices.to(torch.int64)] = rep.data
        return out
    out[csr_row_ids(rep), rep.indices.to(torch.int64)] = rep.data
    return out


# ---------------------------------------------------------------------------
# dot(csr, dense) and dot(csr.T, dense) (reference dot-inl.h)
# ---------------------------------------------------------------------------


@register_ex("dot", differentiable=True)
def _dot_ex(attrs, lhs, rhs):
    """csr x dense (a matrix or a vector), ``transpose_a`` for csr.T:
    each stored (r, c, v) adds ``v * rhs[c]`` to ``out[r]`` (``v *
    rhs[r]`` to ``out[c]`` transposed): one gather, one ``index_add``."""
    if not isinstance(lhs, SparseRep) or isinstance(rhs, SparseRep):
        raise MXNetError(
            "sparse dot supports dot(csr, dense); got lhs=%s rhs=%s"
            % (getattr(lhs, "stype", "default"),
               getattr(rhs, "stype", "default")))
    if lhs.stype != "csr":
        raise MXNetError("sparse dot lhs must be csr, got %s" % lhs.stype)
    if attrs.transpose_b and rhs.dim() > 1:
        rhs = rhs.swapaxes(0, 1)
    rows = csr_row_ids(lhs)
    cols = lhs.indices.to(torch.int64)
    v = lhs.data if rhs.dim() == 1 else lhs.data[:, None]
    if attrs.transpose_a:
        return _seg_sum(v * rhs.index_select(0, rows), cols, lhs.shape[1])
    return _seg_sum(v * rhs.index_select(0, cols), rows, lhs.shape[0])


# ---------------------------------------------------------------------------
# cast_storage (reference cast_storage-inl.h)
# ---------------------------------------------------------------------------


@register("cast_storage", params={"stype": (str, REQUIRED)},
          inputs=("data",))
def _cast_storage_dense(attrs, x):
    """dense -> dense is the identity; a sparse target takes the ex
    path."""
    if attrs.stype != "default":
        raise MXNetError("cast_storage to %r dispatches FComputeEx"
                         % attrs.stype)
    return x


@register_ex("cast_storage", always=True)
def _cast_storage_ex(attrs, x):
    """Any storage to any: sparse -> sparse goes through dense; dense ->
    sparse counts the stored values on the device (its size depends on
    the data, so the op is eager only, as the reference's)."""
    stype = attrs.stype
    if isinstance(x, SparseRep):
        if stype == x.stype:
            return x
        x = densify(x)
    if stype == "default":
        return x
    if stype == "row_sparse":
        nz = (x.reshape(x.shape[0], -1) != 0).any(dim=1).nonzero()[:, 0]
        return SparseRep("row_sparse", x[nz], nz, None, tuple(x.shape))
    if stype == "csr":
        if x.dim() != 2:
            raise MXNetError("cast_storage to csr requires 2-D input")
        r, c = x.nonzero(as_tuple=True)
        indptr = torch.searchsorted(
            r, torch.arange(x.shape[0] + 1, device=x.device))
        return SparseRep("csr", x[r, c], c, indptr, tuple(x.shape))
    raise MXNetError("cast_storage: unknown stype %r" % stype)


# ---------------------------------------------------------------------------
# _sparse_retain (reference sparse_retain-inl.h)
# ---------------------------------------------------------------------------


@register("_sparse_retain", inputs=("data", "indices"))
def _sparse_retain_dense(attrs, data, indices):
    raise MXNetError("_sparse_retain requires a row_sparse input")


@register_ex("_sparse_retain")
def _sparse_retain_ex(attrs, data, indices):
    """The rows ``indices`` of a row_sparse array; a row asked for but not
    stored comes back zero."""
    if not isinstance(data, SparseRep) or data.stype != "row_sparse":
        raise MXNetError("_sparse_retain data must be row_sparse")
    ids = indices.data if isinstance(indices, SparseRep) else indices
    ids = torch.sort(ids.to(torch.int64).reshape(-1)).values
    stored = data.indices.to(torch.int64)
    if stored.numel() == 0:
        vals = torch.zeros((ids.shape[0],) + tuple(data.data.shape[1:]),
                           dtype=data.data.dtype, device=data.data.device)
        return SparseRep("row_sparse", vals, ids, None, data.shape)
    pos = torch.searchsorted(stored, ids).clamp(0, stored.shape[0] - 1)
    hit = stored[pos] == ids
    vals = data.data.index_select(0, pos)
    mask = hit.reshape((-1,) + (1,) * (vals.dim() - 1))
    return SparseRep("row_sparse", torch.where(mask, vals,
                                               torch.zeros_like(vals)),
                     ids, None, data.shape)


# ---------------------------------------------------------------------------
# _square_sum of a row_sparse array (reference square_sum-inl.h)
# ---------------------------------------------------------------------------


@register_ex("_square_sum")
def _square_sum_ex(attrs, x):
    """sum(x^2) of a row_sparse input over its stored rows: ``axis=1``
    with ``keepdims`` a row_sparse result on the same rows (what lazy
    AdaGrad reads), ``axis=1`` a dense vector, ``axis=0`` and the full
    sum dense."""
    if not isinstance(x, SparseRep) or x.stype != "row_sparse":
        raise MXNetError("_square_sum ex kernel expects row_sparse input")
    axes = attrs.axis
    if isinstance(axes, tuple) and len(axes) == 1:
        axes = axes[0]
    sq = torch.square(x.data)
    if axes is None or axes == ():
        return sq.sum()
    if axes == 1 and x.data.dim() == 2:
        vals = sq.sum(dim=1, keepdim=attrs.keepdims)
        if attrs.keepdims:
            return SparseRep("row_sparse", vals, x.indices, None,
                             (x.shape[0], 1))
        return _seg_sum(vals, x.indices.to(torch.int64), x.shape[0])
    if axes == 0:
        # the rows not stored are zero: the stored rows' sum is the sum
        return sq.sum(dim=0, keepdim=attrs.keepdims)
    raise MXNetError(
        "_square_sum on row_sparse supports axis=None/0/1 with 2-D values; "
        "got axis=%r for values of rank %d (cast_storage to default for "
        "general reductions)" % (attrs.axis, x.data.dim()))


# ---------------------------------------------------------------------------
# _contrib_SparseEmbedding (reference indexing_op.h)
# ---------------------------------------------------------------------------


@register("_contrib_SparseEmbedding",
          params={"input_dim": (int, REQUIRED),
                  "output_dim": (int, REQUIRED),
                  "dtype": ("dtype", None)},
          inputs=("data", "weight"))
def _sparse_embedding(attrs, data, weight):
    """The rows ``data`` of ``weight``: only the rows looked up get a
    gradient."""
    return weight[data.to(torch.int64)]


# ---------------------------------------------------------------------------
# row_sparse elemwise add and sub (reference elemwise_binary_op_basic.cc)
# ---------------------------------------------------------------------------


def _rsp_union_addsub(lhs: SparseRep, rhs: SparseRep, sign: float):
    """rsp +/- rsp on the union of their rows, on the device."""
    li = lhs.indices.to(torch.int64)
    ri = rhs.indices.to(torch.int64)
    if ri.numel() == 0:
        return lhs
    if li.numel() == 0:
        rv = rhs.data if sign > 0 else -rhs.data
        return SparseRep("row_sparse", rv, rhs.indices, None, rhs.shape)
    union = torch.unique(torch.cat([li, ri]))  # sorted
    lpos = torch.searchsorted(li, union).clamp(max=li.numel() - 1)
    rpos = torch.searchsorted(ri, union).clamp(max=ri.numel() - 1)
    shape = (-1,) + (1,) * (lhs.data.dim() - 1)
    lv = lhs.data.index_select(0, lpos) \
        * (li[lpos] == union).to(lhs.data.dtype).reshape(shape)
    rv = rhs.data.index_select(0, rpos) \
        * (ri[rpos] == union).to(rhs.data.dtype).reshape(shape)
    out = lv + rv if sign > 0 else lv - rv
    return SparseRep("row_sparse", out, union, None, lhs.shape)


def _binary_ex(sign):
    def ex(attrs, lhs, rhs):
        if isinstance(lhs, SparseRep) and isinstance(rhs, SparseRep) \
                and lhs.stype == rhs.stype == "row_sparse":
            return _rsp_union_addsub(lhs, rhs, sign)
        a = densify(lhs) if isinstance(lhs, SparseRep) else lhs
        b = densify(rhs) if isinstance(rhs, SparseRep) else rhs
        return a + b if sign > 0 else a - b

    return ex


register_ex("elemwise_add", grad_fallback=True)(_binary_ex(1.0))
register_ex("elemwise_sub", grad_fallback=True)(_binary_ex(-1.0))
