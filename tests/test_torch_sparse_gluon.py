"""The sparse surface of the store and of gluon against the JAX
package's (CPU): ``kvstore.row_sparse_pull`` into a ``RowSparseNDArray``
out and into a dense out (copied in place: the out's tensor keeps its
address), and ``gluon.Parameter``'s ``stype``, ``grad_stype``,
``row_sparse_data`` and ``list_row_sparse_data``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon, nd

W = np.random.RandomState(0).randn(6, 3).astype(np.float32)
ROWS = np.array([4, 1, 4], np.int64)


def _pull(pkg, out):
    kv = pkg.kv.create("local")
    kv.init("w", pkg.nd.array(W))
    kv.row_sparse_pull("w", out=out, row_ids=pkg.nd.array(ROWS,
                                                          dtype="int64"))
    return out


def test_row_sparse_pull_into_row_sparse_out():
    want = _pull(jmx, jmx.nd.sparse.zeros("row_sparse", (6, 3)))
    with mx.cpu():
        out = _pull(mx, mx.nd.sparse.zeros("row_sparse", (6, 3)))
    assert out.stype == "row_sparse"
    np.testing.assert_array_equal(out.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(out.indices.asnumpy(), [1, 4])
    np.testing.assert_array_equal(out.data.asnumpy(), W[[1, 4]])


def test_row_sparse_pull_into_dense_out_copies_in_place():
    want = _pull(jmx, jmx.nd.zeros((6, 3)))
    with mx.cpu():
        out = nd.zeros((6, 3))
        ptr = out._data.data_ptr()
        _pull(mx, out)
    assert out._data.data_ptr() == ptr
    np.testing.assert_array_equal(out.asnumpy(), want.asnumpy())


def test_parameter_sparse_attributes_match_jax():
    for pkg in (jmx, mx):
        p = pkg.gluon.Parameter("w", shape=(6, 3), stype="row_sparse",
                                grad_stype="row_sparse")
        assert (p.stype, p.grad_stype) == ("row_sparse", "row_sparse")
        q = pkg.gluon.Parameter("q", shape=(2,))
        assert (q.stype, q.grad_stype) == ("default", "default")
        with pytest.raises(Exception, match="stype"):
            pkg.gluon.Parameter("bad", stype="coo")
    want = jmx.gluon.Parameter("w", shape=(6, 3), stype="row_sparse")
    want.initialize(init=jmx.initializer.One(), ctx=jmx.cpu())
    got = gluon.Parameter("w", shape=(6, 3), stype="row_sparse")
    got.initialize(init=mx.initializer.One(), ctx=mx.cpu())
    rows = [0, 2]
    np.testing.assert_array_equal(
        got.row_sparse_data(nd.array(rows, ctx=mx.cpu())).asnumpy(),
        want.row_sparse_data(jmx.nd.array(rows)).asnumpy())
    g_list = got.list_row_sparse_data(nd.array(rows, ctx=mx.cpu()))
    w_list = want.list_row_sparse_data(jmx.nd.array(rows))
    assert len(g_list) == len(w_list) == 1
    np.testing.assert_array_equal(g_list[0].asnumpy(), w_list[0].asnumpy())


def test_parameter_dict_get_checks_stype():
    pd = gluon.ParameterDict("net_")
    p = pd.get("w", shape=(2, 2), stype="row_sparse")
    assert pd.get("w", stype="row_sparse") is p
    with pytest.raises(MXNetError, match="stype"):
        pd.get("w", stype="default")
