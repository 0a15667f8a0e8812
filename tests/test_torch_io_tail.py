"""The port's iterator tail (``mxnet_tpu_torch/io.py``) against the JAX
package's (CPU): ``NDArrayIter``'s ``hard_reset``/``state_dict``/
``set_state``, ``ResizeIter``, ``PrefetchingIter`` (one and two base
iterators, renames, resume, an error raised at ``next()``), ``CSVIter``,
``MXDataIter`` by name, and ``DevicePrefetchIter`` under ``mx.cpu()``
(pass-through, reset, resume, errors at ``next()``, the sharding
argument). Batches, labels and pads are compared exactly (tolerance 0:
no arithmetic runs).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, parallel

X = np.arange(70, dtype=np.float32).reshape(14, 5)
Y = np.arange(14, dtype=np.float32)


def _batches(it, n=None):
    out = []
    for i, b in enumerate(it):
        if n is not None and i >= n:
            break
        out.append(([d.asnumpy() for d in b.data],
                    [x.asnumpy() for x in b.label or []], b.pad))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_state_and_hard_reset(handle):
    its = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            its.append(pkg.io.NDArrayIter(X, Y, batch_size=4,
                                          last_batch_handle=handle))
    jit, tit = its
    for it in its:
        it.next()
        it.next()
    assert tit.state_dict() == jit.state_dict()
    state = tit.state_dict()
    want = _batches(jit)
    with mx.cpu():
        tit2 = mx.io.NDArrayIter(X, Y, batch_size=4, last_batch_handle=handle)
        tit2.set_state(state)
        _same(_batches(tit2), want)
    for it in its:
        it.hard_reset()
    with mx.cpu():
        _same(_batches(tit), _batches(jit))


def test_resize_iter():
    for size, internal in ((5, True), (2, False), (9, True)):
        outs = []
        for pkg in (jmx, mx):
            with pkg.cpu():
                base = pkg.io.NDArrayIter(X, Y, batch_size=4)
                it = pkg.io.ResizeIter(base, size, reset_internal=internal)
                first = _batches(it)
                it.reset()
                outs.append(first + _batches(it))
                assert it.provide_data[0].shape == (4, 5)
        _same(*outs[::-1])


def test_prefetching_iter_one_and_two_bases():
    outs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            a = pkg.io.NDArrayIter(X, Y, batch_size=3)
            b = pkg.io.NDArrayIter(X * 2, Y + 1, batch_size=3,
                                   data_name="d2", label_name="l2")
            it = pkg.io.PrefetchingIter(
                [a, b], rename_data=[{"data": "x0"}, {"d2": "x1"}])
            names = [d.name for d in it.provide_data]
            first = _batches(it)
            it.reset()
            outs.append((names, first + _batches(it)))
            single = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(X, Y, 5))
            outs[-1] += (_batches(single),)
    assert outs[0][0] == outs[1][0] == ["x0", "x1"]
    _same(outs[1][1], outs[0][1])
    _same(outs[1][2], outs[0][2])


def test_prefetching_iter_resume():
    with mx.cpu():
        it = mx.io.PrefetchingIter(mx.io.NDArrayIter(X, Y, batch_size=2))
        want = _batches(it)
        it.reset()
        it.next()
        it.next()
        it.next()
        state = it.state_dict()
        assert state == {"delivered": 3}
        it2 = mx.io.PrefetchingIter(mx.io.NDArrayIter(X, Y, batch_size=2))
        it2.set_state(state)
        _same(_batches(it2), want[3:])
    with jmx.cpu():
        jit = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(X, Y, batch_size=2))
        jit.set_state(state)
        _same(_batches(jit), want[3:])


def test_prefetching_iter_raises_at_next():
    class Boom(mx.io.NDArrayIter):
        def next(self):
            raise ValueError("prefetch boom")

    with mx.cpu():
        it = mx.io.PrefetchingIter(Boom(X, Y, batch_size=2))
        with pytest.raises(ValueError, match="prefetch boom"):
            it.next()
        with pytest.raises(StopIteration):
            it.next()  # the stream reads as ended until reset()


def test_csv_iter(tmp_path):
    data = np.random.RandomState(0).rand(11, 6).astype(np.float32)
    label = np.arange(11, dtype=np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for round_batch in (True, False):
        outs = []
        for pkg in (jmx, mx):
            with pkg.cpu():
                it = pkg.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                                    data_shape=(2, 3),
                                    label_csv=str(tmp_path / "l.csv"),
                                    batch_size=4, round_batch=round_batch)
                outs.append(_batches(it))
        _same(outs[1], outs[0])
        assert outs[1][0][0][0].shape == (4, 2, 3)


def test_mx_data_iter_by_name(tmp_path):
    np.savetxt(tmp_path / "d.csv", X, delimiter=",")
    outs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            a = pkg.io.MXDataIter(name="NDArrayIter", data=X, label=Y,
                                  batch_size=5)
            b = pkg.io.MXDataIter("CSVIter", data_csv=str(tmp_path / "d.csv"),
                                  data_shape=(5,), batch_size=7)
            outs.append(_batches(a) + _batches(b))
    _same(outs[1], outs[0])
    with pytest.raises(MXNetError, match="unknown iterator"):
        mx.io.MXDataIter(name="NoSuchIter")


def test_device_prefetch_iter_on_the_host():
    outs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            base = pkg.io.NDArrayIter(X, Y, batch_size=5)
            it = pkg.io.DevicePrefetchIter(base, ctx=pkg.cpu(), depth=2)
            first = _batches(it)
            it.reset()
            outs.append(first + _batches(it))
    _same(outs[1], outs[0])
    with mx.cpu():
        it = mx.io.DevicePrefetchIter(mx.io.NDArrayIter(X, Y, batch_size=5),
                                      ctx=mx.cpu())
        b = it.next()
        assert b.data[0]._data.device.type == "cpu"
        assert it.state_dict() == {"delivered": 1}
        it2 = mx.io.DevicePrefetchIter(mx.io.NDArrayIter(X, Y, batch_size=5),
                                       ctx=mx.cpu())
        it2.set_state({"delivered": 2})
        _same(_batches(it2), outs[1][2:3])


def test_device_prefetch_iter_sharding_and_errors():
    class Boom(mx.io.NDArrayIter):
        def next(self):
            raise ValueError("infeed boom")

    with mx.cpu():
        it = mx.io.DevicePrefetchIter(Boom(X, Y, batch_size=2), ctx=mx.cpu())
        with pytest.raises(ValueError, match="infeed boom"):
            it.next()
        with pytest.raises(StopIteration):
            it.next()
        mesh = parallel.device_mesh(1, devices=[mx.cpu()])
        for sharding in (mesh, mx.cpu(), lambda ndim: mesh):
            it = mx.io.DevicePrefetchIter(
                mx.io.NDArrayIter(X, Y, batch_size=7), sharding=sharding)
            assert len(_batches(it)) == 2

        class TwoDevices:
            devices = ["cpu", "cpu"]

        it = mx.io.DevicePrefetchIter(mx.io.NDArrayIter(X, Y, batch_size=7),
                                      sharding=TwoDevices())
        with pytest.raises(MXNetError, match="not ported yet"):
            it.next()


def test_context_scope_entered_again_and_from_threads():
    """An iterator's context object may be entered again inside its own
    scope, or by its prefetch thread: leaving restores the scope outside
    it (the host scope must not outlive its ``with``)."""
    import threading

    import torch

    ctx = mx.cpu()
    with ctx:
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            ctx.__enter__() is ctx and ctx.__exit__(None, None, None)))
        t.start()
        t.join(timeout=10)
        assert seen == [None] and mx.current_context() is ctx
        with ctx:
            assert mx.current_context() is ctx
        assert mx.current_context() is ctx
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.current_context()
