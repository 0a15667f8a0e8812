"""Linear-algebra ops: the port of ``mxnet_tpu/ops/linalg.py`` (reference
``src/operator/tensor/la_op.cc``), on ``torch.linalg`` (cuSOLVER and
cuBLAS on the card, LAPACK on the CPU), with autograd's gradients.

Each op takes a batch of matrices in the last two axes. ``potrf`` and
``syevd`` read the symmetric part ``(A + A^T) / 2`` of their input, as
``jnp.linalg.cholesky``/``eigh`` do by default. ``syevd`` returns the
eigenvectors as rows (``U``, with ``A = U^T diag(w) U``) and ``gelqf``
the LQ factors from a QR of ``A^T``; both are fixed only up to the sign
of each vector, which the solver chooses.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


def _sym(a):
    return (a + a.transpose(-1, -2)) / 2


@register("_linalg_gemm",
          params={"transpose_a": (bool, False), "transpose_b": (bool, False),
                  "alpha": (float, 1.0), "beta": (float, 1.0),
                  "axis": (int, -2)},
          inputs=("A", "B", "C"), aliases=("linalg_gemm",))
def linalg_gemm(attrs, a, b, c):
    """alpha * op(A) op(B) + beta * C."""
    return attrs.alpha * torch.matmul(_t(a, attrs.transpose_a),
                                      _t(b, attrs.transpose_b)) \
        + attrs.beta * c


@register("_linalg_gemm2",
          params={"transpose_a": (bool, False), "transpose_b": (bool, False),
                  "alpha": (float, 1.0), "axis": (int, -2)},
          inputs=("A", "B"), aliases=("linalg_gemm2",))
def linalg_gemm2(attrs, a, b):
    """alpha * op(A) op(B)."""
    return attrs.alpha * torch.matmul(_t(a, attrs.transpose_a),
                                      _t(b, attrs.transpose_b))


@register("_linalg_potrf", inputs=("A",), aliases=("linalg_potrf",))
def linalg_potrf(attrs, a):
    """The lower Cholesky factor of an SPD matrix."""
    return torch.linalg.cholesky(_sym(a))


@register("_linalg_potri", inputs=("A",), aliases=("linalg_potri",))
def linalg_potri(attrs, a):
    """The inverse of the SPD matrix whose Cholesky factor is A."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device) \
        .expand(a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


_TRI_PARAMS = {"transpose": (bool, False), "rightside": (bool, False),
               "lower": (bool, True), "alpha": (float, 1.0)}


@register("_linalg_trmm", params=dict(_TRI_PARAMS), inputs=("A", "B"),
          aliases=("linalg_trmm",))
def linalg_trmm(attrs, a, b):
    """alpha * op(A) B (B op(A) with ``rightside``), A taken whole, as
    the JAX op takes it."""
    at = _t(a, attrs.transpose)
    out = torch.matmul(b, at) if attrs.rightside else torch.matmul(at, b)
    return attrs.alpha * out


@register("_linalg_trsm", params=dict(_TRI_PARAMS), inputs=("A", "B"),
          aliases=("linalg_trsm",))
def linalg_trsm(attrs, a, b):
    """X with op(A) X = alpha B (X op(A) = alpha B with ``rightside``),
    A triangular (``lower``)."""
    lower = attrs.lower != attrs.transpose
    if attrs.rightside:
        xt = torch.linalg.solve_triangular(
            _t(a, not attrs.transpose), _t(attrs.alpha * b, True),
            upper=lower)
        return _t(xt, True)
    return torch.linalg.solve_triangular(_t(a, attrs.transpose),
                                         attrs.alpha * b, upper=not lower)


@register("_linalg_sumlogdiag", inputs=("A",),
          aliases=("linalg_sumlogdiag",))
def linalg_sumlogdiag(attrs, a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_syrk",
          params={"transpose": (bool, False), "alpha": (float, 1.0)},
          inputs=("A",), aliases=("linalg_syrk",))
def linalg_syrk(attrs, a):
    """alpha * A^T A (``transpose``) or alpha * A A^T."""
    at = a.transpose(-1, -2)
    return attrs.alpha * (torch.matmul(at, a) if attrs.transpose
                          else torch.matmul(a, at))


@register("_linalg_syevd", inputs=("A",), num_outputs=2,
          aliases=("linalg_syevd",))
def linalg_syevd(attrs, a):
    """(U, w): the eigenvectors as the rows of U, the eigenvalues w
    ascending."""
    w, v = torch.linalg.eigh(_sym(a))
    return v.transpose(-1, -2), w


@register("_linalg_gelqf", inputs=("A",), num_outputs=2,
          aliases=("linalg_gelqf",))
def linalg_gelqf(attrs, a):
    """(L, Q) with A = L Q, Q's rows orthonormal."""
    q, r = torch.linalg.qr(a.transpose(-1, -2))
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register("_linalg_makediag", params={"offset": (int, 0)}, inputs=("A",),
          aliases=("linalg_makediag",))
def linalg_makediag(attrs, a):
    """Square matrices with A on diagonal ``offset``."""
    return torch.diag_embed(a, offset=attrs.offset)


@register("_linalg_extractdiag", params={"offset": (int, 0)},
          inputs=("A",), aliases=("linalg_extractdiag",))
def linalg_extractdiag(attrs, a):
    return torch.diagonal(a, offset=attrs.offset, dim1=-2, dim2=-1)


@register("_linalg_inverse", inputs=("A",), aliases=("linalg_inverse",))
def linalg_inverse(attrs, a):
    return torch.linalg.inv(a)


@register("_linalg_det", inputs=("A",), aliases=("linalg_det",))
def linalg_det(attrs, a):
    return torch.linalg.det(a)


@register("_linalg_slogdet", inputs=("A",), num_outputs=2,
          aliases=("linalg_slogdet",))
def linalg_slogdet(attrs, a):
    """(sign, log |det|)."""
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet
