"""The port's ``io.LibSVMIter`` against the JAX package's (CPU).

The same LibSVM files (a multi-label first column, blank lines, rows
with no feature) through both iterators: every batch's CSR triple
(values within 2e-5, column ids and offsets exactly), labels, ``pad``,
``provide_data``/``provide_label``, with ``round_batch`` on and off,
labels from a second LibSVM file (``label_libsvm``, with and without
``label_shape``), and ``reset``. The port's batches stay CSR (the dense
value is never built) on the iterator's context.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _write(path, rows, labels):
    with open(path, "w") as f:
        for k, (lab, feats) in enumerate(zip(labels, rows)):
            f.write("%s %s\n" % (lab, " ".join("%d:%.4f" % kv
                                                for kv in feats)))
            if k == 3:
                f.write("\n")  # a blank line is skipped


def _data(tmp_path, n=11, dim=20, seed=0):
    rs = np.random.RandomState(seed)
    rows, labels = [], []
    for i in range(n):
        k = 0 if i == 5 else rs.randint(1, 6)
        idx = np.sort(rs.choice(dim, k, replace=False))
        rows.append([(j, rs.randn()) for j in idx])
        labels.append("%g,%g" % (i % 3, i % 2) if i % 4 == 0
                      else "%g" % (i % 3))
    path = tmp_path / "data.libsvm"
    _write(path, rows, labels)
    lab_rows = [[(j, 1.0 + j) for j in sorted(rs.choice(4, rs.randint(1, 3),
                                                          replace=False))]
                for _ in range(n)]
    lpath = tmp_path / "label.libsvm"
    _write(lpath, lab_rows, ["0"] * n)
    return str(path), str(lpath)


def _batches(pkg, **kw):
    it = pkg.io.LibSVMIter(**kw)
    out = []
    for _ in range(2):  # reset gives the same batches again
        it.reset()
        for b in it:
            x = b.data[0]
            assert x.stype == "csr"
            out.append((x.data.asnumpy(), x.indices.asnumpy(),
                        x.indptr.asnumpy(), tuple(x.shape),
                        b.label[0].asnumpy(), b.pad))
    return out, it.provide_data, it.provide_label


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("labels", ["first", "file", "file_shaped"])
def test_libsvm_batches_match_jax(tmp_path, round_batch, labels):
    path, lpath = _data(tmp_path)
    kw = dict(data_libsvm=path, data_shape=(20,), batch_size=4,
              round_batch=round_batch)
    if labels != "first":
        kw["label_libsvm"] = lpath
    if labels == "file_shaped":
        kw["label_shape"] = (5,)
    want, want_pd, want_pl = _batches(jmx, **kw)
    with mx.cpu():
        got, got_pd, got_pl = _batches(mx, **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert g[3] == w[3]
        np.testing.assert_array_equal(g[4], w[4])
        assert g[5] == w[5]
    assert [(d.name, tuple(d.shape)) for d in got_pd] == \
        [(d.name, tuple(d.shape)) for d in want_pd]
    assert [(d.name, tuple(d.shape)) for d in got_pl] == \
        [(d.name, tuple(d.shape)) for d in want_pl]


def test_libsvm_batches_stay_sparse_on_the_iterators_context(tmp_path):
    path, _ = _data(tmp_path)
    with mx.cpu():
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=20, batch_size=4)
    batch = next(iter(it))
    x = batch.data[0]
    assert x.context == mx.cpu() and batch.label[0].context == mx.cpu()
    assert not x.densified and x.shape == (4, 20)
