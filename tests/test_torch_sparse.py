"""The port's sparse storage (``ndarray/sparse.py``, ``ops/sparse.py``,
storage-type dispatch in ``invoke``) against the JAX package's (CPU).

Every case of ``tests/test_sparse_ops.py``, mirrored: the same seeded
numpy inputs through both packages, float32 values within
``rtol=atol=2e-5`` (gradients 1e-4), indices, indptr and storage types
exactly. Then what the port adds: a CSR array keeps its triple and
builds its dense value only when read (and keeps it); a sparse array
refuses in-place writes; the scatter ops keep sparse storage; and
``nd.sparse.zeros``/``tostype``/``copyto``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, nd
from mxnet_tpu_torch.ndarray import sparse as mxs

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def rand_sparse(m, n, density=0.3, seed=11):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, n) * (rs.rand(m, n) < density)).astype(np.float32)


def both(fn):
    """``fn(pkg)`` in the JAX package and in the port on the CPU."""
    want = fn(jmx)
    with mx.cpu():
        got = fn(mx)
    return got, want


def same_sparse(got, want):
    assert got.stype == want.stype
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    if got.stype in ("csr", "row_sparse"):
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      want.indices.asnumpy())
        np.testing.assert_allclose(got.data.asnumpy(), want.data.asnumpy(),
                                   **TOL)
    if got.stype == "csr":
        np.testing.assert_array_equal(got.indptr.asnumpy(),
                                      want.indptr.asnumpy())


def test_cast_storage_csr_matches_jax():
    a = rand_sparse(13, 7)
    got, want = both(lambda p: p.nd.sparse.cast_storage(p.nd.array(a),
                                                        "csr"))
    same_sparse(got, want)
    back = mxs.cast_storage(got, "default")
    assert back.stype == "default"
    np.testing.assert_allclose(back.asnumpy(), a, **TOL)


def test_cast_storage_row_sparse_roundtrip():
    a = rand_sparse(9, 5)
    a[3] = 0

    def run(p):
        rsp = p.nd.sparse.cast_storage(p.nd.array(a), "row_sparse")
        return (rsp, p.nd.sparse.cast_storage(rsp, "default"),
                p.nd.sparse.cast_storage(rsp, "csr"))

    got, want = both(run)
    for g, w in zip(got, want):
        same_sparse(g, w)
    assert 3 not in got[0].indices.asnumpy().tolist()


@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_csr_dense(transpose_a):
    a = rand_sparse(12, 8)
    b = np.random.RandomState(1).randn(12 if transpose_a else 8, 6) \
        .astype(np.float32)
    got, want = both(lambda p: p.nd.sparse.dot(
        p.nd.sparse.cast_storage(p.nd.array(a), "csr"), p.nd.array(b),
        transpose_a=transpose_a))
    same_sparse(got, want)
    np.testing.assert_allclose(got.asnumpy(),
                               (a.T @ b) if transpose_a else a @ b,
                               rtol=1e-4, atol=1e-5)


def test_dot_csr_vector():
    a = rand_sparse(10, 4)
    b = np.random.RandomState(2).randn(4).astype(np.float32)
    got, want = both(lambda p: p.nd.sparse.dot(
        p.nd.sparse.cast_storage(p.nd.array(a), "csr"), p.nd.array(b)))
    same_sparse(got, want)


def test_dot_dense_fallback_unchanged():
    rs = np.random.RandomState(3)
    a, b = rs.randn(5, 4).astype(np.float32), rs.randn(4, 3).astype(
        np.float32)
    got, want = both(lambda p: p.nd.invoke("dot", p.nd.array(a),
                                           p.nd.array(b)))
    same_sparse(got, want)


def test_dot_csr_gradient_wrt_dense():
    """The gradient reaches the dense operand densely (csr^T g); the csr
    operand gets none."""
    a = rand_sparse(12, 8)
    w0 = np.random.RandomState(4).randn(8, 3).astype(np.float32)

    def run(p):
        csr = p.nd.sparse.cast_storage(p.nd.array(a), "csr")
        w = p.nd.array(w0)
        w.attach_grad()
        with p.autograd.record():
            y = p.nd.sparse.dot(csr, w)
            loss = (y * y).sum()
        loss.backward()
        return w.grad

    got, want = both(run)
    assert got.stype == "default"
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **GRAD_TOL)
    np.testing.assert_allclose(got.asnumpy(), 2 * a.T @ (a @ w0),
                               rtol=1e-4, atol=1e-5)


def test_sparse_retain():
    a = rand_sparse(8, 3)
    a[2] = 0
    got, want = both(lambda p: p.nd.sparse.retain(
        p.nd.sparse.cast_storage(p.nd.array(a), "row_sparse"), [1, 2, 5]))
    same_sparse(got, want)
    np.testing.assert_array_equal(got.asnumpy()[2], np.zeros(3, np.float32))


def test_square_sum_row_sparse():
    a = rand_sparse(10, 6)

    def run(p):
        rsp = p.nd.sparse.cast_storage(p.nd.array(a), "row_sparse")
        return [p.nd.invoke("_square_sum", rsp, axis=(1,), keepdims=True),
                p.nd.invoke("_square_sum", rsp, axis=(1,)),
                p.nd.invoke("_square_sum", rsp, axis=(0,)),
                p.nd.invoke("_square_sum", rsp)]

    got, want = both(run)
    assert got[0].stype == "row_sparse"
    for g, w in zip(got, want):
        same_sparse(g, w)


def test_square_sum_dense_path_still_works():
    a = np.random.RandomState(5).randn(4, 5).astype(np.float32)
    got, want = both(lambda p: p.nd.invoke("_square_sum", p.nd.array(a),
                                           axis=(1,)))
    same_sparse(got, want)


def test_sparse_embedding():
    rs = np.random.RandomState(6)
    w0 = rs.randn(20, 6).astype(np.float32)
    ids = rs.randint(0, 20, (4, 3)).astype(np.int64)

    def run(p):
        w = p.nd.array(w0)
        w.attach_grad()
        with p.autograd.record():
            e = p.nd.invoke("_contrib_SparseEmbedding", p.nd.array(ids), w,
                            input_dim=20, output_dim=6)
            loss = (e * e).sum()
        loss.backward()
        return e, w.grad

    got, want = both(run)
    for g, w in zip(got, want):
        same_sparse(g, w)
    g = got[1].asnumpy()
    untouched = sorted(set(range(20)) - set(ids.ravel().tolist()))
    assert not g[untouched].any()


def test_sparse_dot_rejects_unsupported_combination():
    a = rand_sparse(6, 4)
    for p in (jmx, mx):
        with mx.cpu():
            rsp = p.nd.sparse.cast_storage(p.nd.array(a), "row_sparse")
            with pytest.raises(Exception, match="csr"):
                p.nd.sparse.dot(rsp, p.nd.array(np.ones((4, 2),
                                                        np.float32)))


def test_dot_csr_vector_transpose_b_noop():
    a = rand_sparse(6, 4)
    b = np.random.RandomState(7).randn(4).astype(np.float32)
    got, want = both(lambda p: p.nd.sparse.dot(
        p.nd.sparse.cast_storage(p.nd.array(a), "csr"), p.nd.array(b),
        transpose_b=True))
    same_sparse(got, want)


def test_square_sum_unsupported_axis_raises():
    with mx.cpu():
        rsp = mxs.cast_storage(nd.array(rand_sparse(5, 4)), "row_sparse")
        with pytest.raises(MXNetError, match="axis"):
            nd.invoke("_square_sum", rsp, axis=(2,))


def test_out_with_sparse_storage_rejected():
    a = rand_sparse(5, 4)
    with mx.cpu():
        rsp = mxs.cast_storage(nd.array(a), "row_sparse")
        with pytest.raises(MXNetError, match="sparse"):
            nd.invoke("cast_storage", nd.array(a), stype="row_sparse",
                      out=rsp)
        with pytest.raises(MXNetError, match="sparse"):
            nd.invoke("_square_sum", rsp, axis=(1,), keepdims=True,
                      out=nd.zeros((5, 1)))


def test_sparse_elemwise_add_sub():
    rs = np.random.RandomState(8)
    a = np.zeros((6, 3), np.float32)
    b = np.zeros((6, 3), np.float32)
    a[[0, 2]] = rs.randn(2, 3)
    b[[2, 5]] = rs.randn(2, 3)

    def run(p):
        ra = p.nd.sparse.cast_storage(p.nd.array(a), "row_sparse")
        rb = p.nd.sparse.cast_storage(p.nd.array(b), "row_sparse")
        z = p.nd.sparse.cast_storage(p.nd.array(np.zeros((6, 3),
                                                         np.float32)),
                                     "row_sparse")
        return [p.nd.invoke("elemwise_add", ra, rb),
                p.nd.invoke("elemwise_sub", ra, rb),
                p.nd.invoke("elemwise_add", ra, p.nd.array(b)),
                p.nd.invoke("elemwise_add", ra, z),
                p.nd.invoke("elemwise_sub", z, rb)]

    got, want = both(run)
    assert [g.stype for g in got] == ["row_sparse", "row_sparse",
                                      "default", "row_sparse",
                                      "row_sparse"]
    for g, w in zip(got, want):
        same_sparse(g, w)
    assert got[0].indices.asnumpy().tolist() == [0, 2, 5]


def test_sparse_elemwise_add_taped_dense_grad():
    """Recording with a dense operand in the graph, the add takes its
    dense path, and the gradient flows."""
    a = rand_sparse(5, 3)
    w0 = np.random.RandomState(9).randn(5, 3).astype(np.float32)

    def run(p):
        rsp = p.nd.sparse.cast_storage(p.nd.array(a), "row_sparse")
        w = p.nd.array(w0)
        w.attach_grad()
        with p.autograd.record():
            y = p.nd.invoke("elemwise_add", w, rsp)
            loss = (y * y).sum()
        loss.backward()
        return w.grad

    got, want = both(run)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **GRAD_TOL)
    np.testing.assert_allclose(got.asnumpy(), 2 * (w0 + a), rtol=1e-5)


def test_row_sparse_array_unsorted_indices_canonicalized():
    vals = np.array([[5., 5.], [1., 1.]], np.float32)
    eye = np.eye(6, 2, dtype=np.float32)

    def run(p):
        rsp = p.nd.sparse.row_sparse_array((vals, [5, 1]), shape=(6, 2))
        other = p.nd.sparse.cast_storage(p.nd.array(eye), "row_sparse")
        return rsp, p.nd.invoke("elemwise_add", rsp, other)

    got, want = both(run)
    for g, w in zip(got, want):
        same_sparse(g, w)
    np.testing.assert_array_equal(got[0].indices.asnumpy(), [1, 5])


def test_sparse_retain_works_under_record():
    a = rand_sparse(6, 3)
    with mx.cpu():
        rsp = mxs.cast_storage(nd.array(a), "row_sparse")
        w = nd.array(np.ones((2, 2), np.float32))
        w.attach_grad()
        with autograd.record():
            _ = (w * w).sum()
            ret = mxs.retain(rsp, [0, 2])
    assert ret.stype == "row_sparse"


def test_sparse_elemwise_add_int_dtype_preserved():
    a = np.zeros((4, 2), np.int32)
    a[1] = 3
    b = np.zeros((4, 2), np.int32)
    b[2] = 4

    def run(p):
        ra = p.nd.sparse.cast_storage(p.nd.array(a, dtype="int32"),
                                      "row_sparse")
        rb = p.nd.sparse.cast_storage(p.nd.array(b, dtype="int32"),
                                      "row_sparse")
        return [p.nd.invoke("elemwise_add", ra, rb),
                p.nd.invoke("elemwise_sub", ra, rb)]

    got, want = both(run)
    for g, w in zip(got, want):
        assert g.asnumpy().dtype == w.asnumpy().dtype == np.int32
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


# -- what the port adds -------------------------------------------------------


def test_csr_builds_its_dense_value_only_when_read():
    a = rand_sparse(7, 9)
    with mx.cpu():
        csr = mxs.csr_matrix(a)
        assert not csr.densified
        assert csr.shape == (7, 9) and csr.dtype == np.float32
        assert csr.context == mx.cpu() and csr.size == 63
        w = nd.array(np.ones((9, 2), np.float32))
        mxs.dot(csr, w)
        mxs.dot(csr, w, transpose_a=True)
        assert not csr.densified   # the ex path reads the triple only
        y = csr * 2.0              # no ex path: the dense value is built
        assert csr.densified
        np.testing.assert_allclose(y.asnumpy(), 2 * a, **TOL)


def test_csr_matrix_from_device_components_keeps_them():
    a = rand_sparse(5, 6)
    with mx.cpu():
        csr = mxs.csr_matrix(a)
        sq = mxs.csr_matrix((csr.data ** 2, csr.indices, csr.indptr),
                            shape=csr.shape)
    np.testing.assert_allclose(sq.asnumpy(), a * a, **TOL)
    np.testing.assert_array_equal(sq.indices.asnumpy(),
                                  csr.indices.asnumpy())


def test_sparse_arrays_refuse_in_place_writes_and_gradients():
    with mx.cpu():
        rsp = mxs.cast_storage(nd.array(rand_sparse(4, 3)), "row_sparse")
        with pytest.raises(MXNetError, match="in place"):
            rsp += 1.0
        with pytest.raises(MXNetError, match="no gradient"):
            rsp.attach_grad()


def test_scatter_ops_keep_sparse_storage():
    a = rand_sparse(6, 4)
    d = np.random.RandomState(10).uniform(0.5, 2.0, (6, 4)).astype(
        np.float32)

    def run(p):
        out = []
        for stype in ("row_sparse", "csr"):
            s = p.nd.sparse.cast_storage(p.nd.array(a), stype)
            out += [p.nd.invoke("_scatter_plus_scalar", s, scalar=1.5),
                    p.nd.invoke("_scatter_minus_scalar", s, scalar=0.5),
                    p.nd.invoke("_scatter_elemwise_div", s, p.nd.array(d))]
        return out

    got, want = both(run)
    for g, w in zip(got, want):
        same_sparse(g, w)


def test_zeros_tostype_and_copyto():
    with mx.cpu():
        z = mxs.zeros("row_sparse", (4, 3))
        assert z.stype == "row_sparse" and z.indices.shape == (0,)
        c = nd.array(rand_sparse(4, 3)).tostype("csr")
        assert c.tostype("csr") is c
        assert c.tostype("row_sparse").stype == "row_sparse"
        moved = c.copyto(mx.cpu())
        assert moved.stype == "csr" and not moved.densified
        np.testing.assert_array_equal(moved.asnumpy(), c.asnumpy())
    assert isinstance(c, mx.nd.CSRNDArray)
    assert isinstance(z, mx.nd.RowSparseNDArray)
