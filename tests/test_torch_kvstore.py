"""The port's kvstore against the JAX package's (CPU): every case of
``tests/test_kvstore.py`` but ``dist_async``, run through both packages
on the same numpy values, plus what the port adds: pull writes in place,
the batched exchanges equal the per-key ones bit for bit, and a fault
injected at ``kvstore.push`` is retried to the same bits.

The JAX ``tpu`` store of the multi-device cases is the port's ``local``
store here: the port reduces the copies it is given on one device, and
``tpu``/``dist*`` raise "not ported yet".
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore import OPS
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.resilience import chaos

SHAPE = (4, 5)
N = 4  # gradient copies a push, as the JAX tests push one per device


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _p(a):
    return NDArray(torch.from_numpy(np.array(a, np.float32)))


def _j(a):
    return JNDArray(jnp.asarray(np.array(a, np.float32)), jmx.cpu())


def _both(fn):
    """``fn(mx_module, array_maker)`` in both packages."""
    return fn(mx, _p), fn(jmx, _j)


def _same(a, b, tol=0.0):
    a = a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)
    b = b.asnumpy() if hasattr(b, "asnumpy") else np.asarray(b)
    if tol:
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(a, b)


def test_kv_alias_and_counter():
    assert mx.kv is mx.kvstore
    kv = mx.kv.create("local")
    kv.init(0, nd.ones(SHAPE))
    before = OPS.value(op="push"), OPS.value(op="pull")
    kv.push(0, nd.ones(SHAPE))
    kv.pull(0, out=nd.zeros(SHAPE))
    assert (OPS.value(op="push"), OPS.value(op="pull")) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_single_kv_pair(kv_type):
    def run(m, arr):
        kv = m.kv.create(kv_type)
        kv.init(3, arr(np.ones(SHAPE)))
        out = arr(np.zeros(SHAPE))
        kv.pull(3, out=out)
        first = out.asnumpy().copy()
        kv.push(3, arr(np.full(SHAPE, 4.0)))
        kv.pull(3, out=out)
        return first, out.asnumpy()

    (p1, p2), (j1, j2) = _both(run)
    _same(p1, j1)
    _same(p2, j2)
    np.testing.assert_allclose(p2, 4.0)


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_list_kv_pairs(kv_type):
    def run(m, arr):
        kv = m.kv.create(kv_type)
        keys = [5, 7, 9]
        kv.init(keys, [arr(np.ones(SHAPE))] * 3)
        kv.push(keys, [arr(np.full(SHAPE, 2.0 + k)) for k in keys])
        outs = [arr(np.zeros(SHAPE)) for _ in keys]
        kv.pull(keys, out=outs)
        return [o.asnumpy() for o in outs]

    for a, b in zip(*_both(run)):
        _same(a, b)


def test_push_copies_aggregate_in_list_order():
    rs = np.random.RandomState(0)
    vals = [rs.randn(*SHAPE).astype(np.float32) for _ in range(N)]

    def run(m, arr):
        kv = m.kv.create("local")
        kv.init("w", arr(np.zeros(SHAPE)))
        kv.push("w", [arr(v) for v in vals])
        outs = [arr(np.zeros(SHAPE)) for _ in range(N)]
        kv.pull("w", out=outs)
        # a second push replaces the entry, it does not add
        kv.push("w", [arr(v) for v in vals])
        out = arr(np.zeros(SHAPE))
        kv.pull("w", out=out)
        return [o.asnumpy() for o in outs] + [out.asnumpy()]

    p, j = _both(run)
    for a, b in zip(p, j):
        _same(a, b)  # bit for bit: acc = d0 + d1 + ... in both


def test_updater_runs_server_side():
    rs = np.random.RandomState(1)
    g = rs.randn(*SHAPE).astype(np.float32)

    def run(m, arr):
        kv = m.kv.create("local")
        kv.init("w", arr(np.ones(SHAPE)))
        kv.set_optimizer(m.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        out = arr(np.zeros(SHAPE))
        for _ in range(3):
            kv.push("w", [arr(g)] * N)
            kv.pull("w", out=out)
        return out.asnumpy(), kv._updater.states["w"]

    (pw, ps), (jw, js) = _both(run)
    _same(pw, jw, 2e-5)
    _same(ps.numpy(), np.asarray(js), 2e-5)


def test_uninitialized_key_and_bad_lists_raise():
    kv = mx.kv.create("local")
    with pytest.raises(MXNetError):
        kv.push("nope", nd.ones(SHAPE))
    with pytest.raises(MXNetError):
        kv.pull("nope", out=nd.zeros(SHAPE))
    with pytest.raises(MXNetError):
        kv.init([1, 2], [nd.ones(SHAPE)])
    with pytest.raises(MXNetError):
        kv.init(1, [[nd.ones(SHAPE)]])


def test_rank_num_workers_and_factory():
    for name in ("local", "local_update_cpu", "local_allreduce_cpu",
                 "device", "local_allreduce_device", "nccl"):
        kv, jkv = mx.kv.create(name), jmx.kv.create(name)
        assert kv.type == jkv.type
        assert (kv.rank, kv.num_workers) == (jkv.rank, jkv.num_workers) \
            == (0, 1)
        kv._barrier()
    for name in ("tpu", "dist", "dist_sync", "dist_async",
                 "dist_device_sync"):
        with pytest.raises(MXNetError, match="not ported yet"):
            mx.kv.create(name)
    with pytest.raises(MXNetError):
        mx.kv.create("bogus")
    with pytest.raises(TypeError):
        mx.kv.create(7)


def test_two_bit_compression_matches_jax_with_residuals():
    rs = np.random.RandomState(2)
    grads = [rs.uniform(-0.8, 0.8, (6,)).astype(np.float32)
             for _ in range(8)]

    def run(m, arr):
        kv = m.kv.create("local")
        kv.init("g", arr(np.zeros(6)))
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        out = arr(np.zeros(6))
        pulled = []
        for g in grads:
            kv.push("g", arr(g))
            kv.pull("g", out=out)
            pulled.append(out.asnumpy().copy())
        res = kv._compression._residuals["g"]
        return pulled, np.asarray(res.numpy() if hasattr(res, "numpy")
                                  else res)

    (pp, pr), (jp, jr) = _both(run)
    for a, b in zip(pp, jp):
        _same(a, b)
        assert set(np.unique(a)) <= {-0.5, 0.0, 0.5}
    _same(pr, jr)
    with pytest.raises(MXNetError):
        mx.kv.create("local").set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("outs", [1, 2])
def test_row_sparse_pull(outs):
    w = np.arange(20, dtype=np.float32).reshape(5, 4)

    def run(m, arr):
        kv = m.kv.create("local")
        kv.init("emb", arr(w))
        out = [arr(np.zeros((5, 4))) for _ in range(outs)]
        kv.row_sparse_pull("emb", out=out if outs > 1 else out[0],
                           row_ids=arr(np.array([1, 3])))
        return [o.asnumpy() for o in out]

    for a, b in zip(*_both(run)):
        _same(a, b)
    expect = np.zeros_like(w)
    expect[[1, 3]] = w[[1, 3]]
    _same(run(mx, _p)[0], expect)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_optimizer_states_load_in_the_other_package(tmp_path, writer):
    g = np.full((3,), 0.7, np.float32)
    fname = str(tmp_path / "states")

    def make(m, arr, w):
        kv = m.kv.create("local")
        kv.init(0, arr(w))
        kv.set_optimizer(m.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        return kv

    src_m, src_a = (mx, _p) if writer == "port" else (jmx, _j)
    dst_m, dst_a = (jmx, _j) if writer == "port" else (mx, _p)
    src = make(src_m, src_a, np.ones(3))
    src.push(0, src_a(g))
    src.save_optimizer_states(fname)
    w_now = src_a(np.zeros(3))
    src.pull(0, out=w_now)
    dst = make(dst_m, dst_a, w_now.asnumpy())
    dst.load_optimizer_states(fname)
    # the states file keys the integer parameter by int
    assert list(dst._updater.states) == [0]
    for kv, arr in ((src, src_a), (dst, dst_a)):
        kv.push(0, arr(g))
    o1, o2 = src_a(np.zeros(3)), dst_a(np.zeros(3))
    src.pull(0, out=o1)
    dst.pull(0, out=o2)
    _same(o1, o2, 1e-6)


def test_pull_writes_in_place():
    kv = mx.kv.create("local")
    w = nd.array(np.ones(SHAPE, np.float32))
    kv.init(0, w)
    assert kv._store["0"]._data.data_ptr() != w._data.data_ptr()
    out = nd.zeros(SHAPE)
    ptr = out._data.data_ptr()
    kv.push(0, nd.array(np.full(SHAPE, 3.0, np.float32)))
    kv.pull(0, out=out)
    assert out._data.data_ptr() == ptr
    np.testing.assert_array_equal(out.asnumpy(), 3.0)
    # the store's tensor is its own: writing the out leaves it alone
    out._data.fill_(9.0)
    again = nd.zeros(SHAPE)
    kv.pull(0, out=again)
    np.testing.assert_array_equal(again.asnumpy(), 3.0)
    # a float16 out takes the value cast, in place
    half = NDArray(torch.zeros(SHAPE, dtype=torch.float16))
    ptr = half._data.data_ptr()
    kv.pull(0, out=half)
    assert half._data.data_ptr() == ptr and half._data.dtype == torch.float16


def _keys_and_grads(seed=3):
    rs = np.random.RandomState(seed)
    shapes = [(4, 3), (7,), (2, 2, 2)]
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [rs.randn(*s).astype(np.float32) for s in shapes]
    return ws, gs


def test_pushpull_multi_equals_push_then_pull():
    ws, gs = _keys_and_grads()
    results = []
    for fused in (True, False):
        kv = mx.kv.create("local")
        kv.init(list(range(3)), [_p(w) for w in ws])
        grads = [[_p(g), _p(2 * g)] for g in gs]
        if fused:
            kv.pushpull_multi(list(range(3)), grads, grads)
        else:
            for i, g in enumerate(grads):
                kv.push(i, g)
                kv.pull(i, g)
        results.append([x.asnumpy() for g in grads for x in g])
    for a, b in zip(*results):
        _same(a, b)


def test_pushpull_update_multi_equals_the_per_key_loop():
    ws, gs = _keys_and_grads(4)
    results = []
    for fused in (True, False):
        kv = mx.kv.create("local")
        kv.init(list(range(3)), [_p(w) for w in ws])
        kv.set_optimizer(mx.optimizer.create("adam", learning_rate=0.01))
        outs = [[_p(np.zeros_like(w))] for w in ws]
        for _ in range(2):
            grads = [[_p(g)] for g in gs]
            if fused:
                kv.pushpull_update_multi(list(range(3)), grads, outs)
            else:
                for i in range(3):
                    kv.push(i, grads[i])
                    kv.pull(i, outs[i])
        results.append([o[0].asnumpy() for o in outs])
    for a, b in zip(*results):
        assert a.tobytes() == b.tobytes()
    # and the fused path is refused where it does not apply
    kv = mx.kv.create("local")
    kv.init(0, _p(ws[0]))
    with pytest.raises(MXNetError):
        kv.pushpull_update_multi([0], [[_p(gs[0])]], [[_p(ws[0])]])
    kv.set_optimizer(mx.optimizer.create("sgd"))
    assert not kv._can_fuse_pushpull()
    with pytest.raises(MXNetError):
        kv.pushpull_multi([0], [[_p(gs[0])]], [[_p(gs[0])]])


def test_injected_push_fault_is_retried_to_the_same_bits():
    ws, gs = _keys_and_grads(5)

    def run():
        kv = mx.kv.create("local")
        kv.init(0, _p(ws[0]))
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        out = _p(np.zeros_like(ws[0]))
        for _ in range(3):
            kv.push(0, [_p(gs[0]), _p(gs[0])])
            kv.pull(0, out)
        return out.asnumpy()

    clean = run()
    with chaos.active("seed=1,site=kvstore.push,p=1.0,max=2"):
        faulty = run()
        injected = chaos.injected_counts()
    assert injected.get("kvstore.push", 0) == 2
    assert clean.tobytes() == faulty.tobytes()


@pytest.mark.parametrize("fastpath_on", ["1", "0"])
def test_model_exchanges_match_jax(monkeypatch, fastpath_on):
    """``model._update_params_on_kvstore`` (push grad, the store's update,
    pull weight) and ``model._update_params`` (the store's reduce, then
    the module-side updater), fused and per key, against the JAX
    package's."""
    from mxnet_tpu import model as jmodel
    from mxnet_tpu_torch import model

    monkeypatch.setenv("MXNET_FASTPATH", fastpath_on)
    ws, gs = _keys_and_grads(6)
    out = {}
    for m, arr, mod in ((mx, _p, model), (jmx, _j, jmodel)):
        kv = m.kv.create("local")
        kv.init(list(range(3)), [arr(w) for w in ws])
        kv.set_optimizer(m.optimizer.create("sgd", learning_rate=0.1,
                                            momentum=0.9))
        params = [[arr(w)] for w in ws]
        for _ in range(2):
            mod._update_params_on_kvstore(params, [[arr(g)] for g in gs],
                                          kv, None)
        plain = m.kv.create("local")
        plain.init(list(range(3)), [arr(w) for w in ws])
        upd = m.optimizer.get_updater(m.optimizer.create(
            "adam", learning_rate=0.01))
        mine = [[arr(w)] for w in ws]
        for _ in range(2):
            mod._update_params(mine, [[arr(g)] for g in gs], upd, 1,
                               kvstore=plain)
        out[m.__name__] = [p[0].asnumpy() for p in params + mine]
    for a, b in zip(out["mxnet_tpu_torch"], out["mxnet_tpu"]):
        _same(a, b, 2e-5)
