"""The request-granularity serving path: ``serving.Server`` over
``BlockEngine`` and engines of the tests' own, the port against the JAX
package (CPU).

Every case of ``tests/test_serving.py``'s buckets, server and robustness
sections, and the ``Server`` cases of ``test_tenancy.py``,
``test_resilience.py`` and ``test_telemetry.py``, runs the same scenario
on the same seeded inputs through both packages; the JAX nets' weights
are carried into the port's (``gluon.params_from_jax``) and outputs agree
within fp32 2e-5. The ``cuda``-marked case holds ``BlockEngine``'s
captured rungs against the eager forward on the card.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import resilience as jres
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=2e-5, atol=2e-5)
PKGS = {"jax": (jmx, jserving, jres, jtel), "port": (mx, tserving, tres, ttel)}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True)
def _no_chaos():
    for res in (jres, tres):
        res.chaos.disable()
    yield
    for res in (jres, tres):
        res.chaos.disable()


def _uname(prefix):
    return "%s%d" % (prefix, np.random.randint(1 << 30))


# ---------------------------------------------------------------------------
# engines of the tests' own (pure numpy: the same in both packages)
# ---------------------------------------------------------------------------

def _engines(S):
    class Double(S.Engine):
        kind = "double"

        def __init__(self):
            self.batch_sizes = []

        def run(self, batch):
            self.batch_sizes.append(batch.shape[0])
            return batch * 2.0

    class Gate(Double):
        def __init__(self, hold_s=0.3):
            super().__init__()
            self.started = threading.Event()
            self.gate = threading.Event()
            self.hold_s = hold_s

        def run(self, batch):
            self.started.set()
            self.gate.wait(self.hold_s)
            return super().run(batch)

    class Poison(Double):
        POISON = 42.0

        def run(self, batch):
            if np.any(batch[:, 0] == self.POISON):
                raise ValueError("poisoned batch")
            return super().run(batch)

    class MultiOut(S.Engine):
        def run(self, batch):
            return batch * 2.0, batch + 1.0

    return Double, Gate, Poison, MultiOut


def _mlp(pkg, in_dim=8, out_dim=4, hybrid=False, seed=7):
    """The JAX MLP of ``test_serving.py``; for the port, the same net with
    the JAX one's weights (built under ``mx.cpu()``)."""
    nn = jmx.gluon.nn
    jmx.random.seed(seed)
    jnet = (nn.HybridSequential if hybrid else nn.Sequential)()
    jnet.add(nn.Dense(16, activation="relu"), nn.Dense(out_dim))
    jnet.initialize()
    jnet(jmx.nd.array(np.zeros((1, in_dim), np.float32)))
    if pkg == "jax":
        return jnet
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnn = mx.gluon.nn
    with mx.cpu():
        net = (tnn.HybridSequential if hybrid else tnn.Sequential)()
        net.add(tnn.Dense(16, activation="relu"), tnn.Dense(out_dim))
        net.initialize()
        net(mx.nd.array(np.zeros((1, in_dim), np.float32)))
        tgluon.params_from_jax(net, arrays)
    return net


def _forward(pkg, net, x):
    m = PKGS[pkg][0]
    with m.autograd.pause():
        if pkg == "port":
            with mx.cpu():
                return net(m.nd.array(x)).asnumpy()
        return net(m.nd.array(x)).asnumpy()


def _serve_block(pkg, net, shape, **kw):
    S = PKGS[pkg][1]
    if pkg == "port":
        kw["device"] = "cpu"
    return S.serve_block(net, shape, **kw)


def test_serving_all_is_the_jax_all():
    assert set(jserving.__all__) - set(tserving.__all__) == set()
    assert set(tserving.__all__) - set(jserving.__all__) == \
        {"params_from_jax"}
    for name in ("Server", "Engine", "BlockEngine", "StableHLOEngine",
                 "serve_block", "serve_stablehlo"):
        assert callable(getattr(tserving, name))


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------

@BOTH
def test_bucket_ladder_default_and_env(pkg, monkeypatch):
    S = PKGS[pkg][1]
    assert S.bucket_ladder() == (1, 4, 16, 32)
    monkeypatch.setenv("MXNET_SERVING_BUCKETS", "2,8")
    assert S.bucket_ladder() == (2, 8)
    assert S.bucket_ladder([32, 1, 8]) == (1, 8, 32)


@BOTH
def test_bucket_ladder_rejects_garbage(pkg):
    S = PKGS[pkg][1]
    for bad in ([0, 4], [4, 4], []):
        with pytest.raises(Exception) as ei:
            S.bucket_ladder(bad)
        assert type(ei.value).__name__ == "MXNetError"


def test_select_and_pad_agree_with_jax():
    ladder = (1, 4, 16)
    for n in (1, 2, 4, 5, 16, 99):
        assert tserving.select_bucket(n, ladder) == \
            jserving.select_bucket(n, ladder)
    rows = [np.full((3,), i, np.float32) for i in range(3)]
    np.testing.assert_array_equal(tserving.pad_to_bucket(rows, 4),
                                  jserving.pad_to_bucket(rows, 4))
    with pytest.raises(MXNetError):
        tserving.pad_to_bucket(rows, 2)
    with pytest.raises(MXNetError):
        tserving.select_bucket(0, ladder)


# ---------------------------------------------------------------------------
# server correctness over a live block
# ---------------------------------------------------------------------------

def test_serve_block_matches_direct_forward_and_jax():
    x = np.random.RandomState(0).randn(6, 8).astype(np.float32)
    got = {}
    for pkg in ("jax", "port"):
        net = _mlp(pkg)
        expect = _forward(pkg, net, x)
        with _serve_block(pkg, net, (8,), buckets=[1, 4, 16],
                          max_delay_ms=5.0) as srv:
            futs = [srv.submit(x[i]) for i in range(6)]
            got[pkg] = np.stack([f.result(timeout=10) for f in futs])
        np.testing.assert_allclose(got[pkg], expect, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)


def test_hybrid_block_engine_and_refresh_keep_the_captures():
    x = np.random.RandomState(4).randn(3, 8).astype(np.float32)
    seen = {}
    for pkg in ("jax", "port"):
        m, S = PKGS[pkg][:2]
        net = _mlp(pkg, hybrid=True)
        kw = {"device": "cpu"} if pkg == "port" else {}
        eng = S.BlockEngine(net, **kw)
        with S.Server(eng, (8,), buckets=[1, 4], max_delay_ms=5.0,
                      name=_uname("hyb")) as srv:
            srv.warmup()
            compiled = eng.compile_count
            got = srv.submit(x[0]).result(timeout=10)
            np.testing.assert_allclose(got, _forward(pkg, net, x[:1])[0],
                                       rtol=1e-5, atol=1e-6)
            w = net[1].weight
            if pkg == "port":
                with mx.cpu():
                    w.set_data(w.data() * 2.0)
            else:
                w.set_data(w.data() * 2.0)
            eng.refresh_params()
            got2 = srv.submit(x[0]).result(timeout=10)
            np.testing.assert_allclose(got2, _forward(pkg, net, x[:1])[0],
                                       rtol=1e-5, atol=1e-6)
            assert not np.allclose(got, got2)
            assert eng.compile_count == compiled == 2
        seen[pkg] = (got, got2)
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_allclose(b, a, **TOL)


def test_compile_once_across_traffic():
    stats = {}
    for pkg in ("jax", "port"):
        srv = _serve_block(pkg, _mlp(pkg), (8,), buckets=[1, 2, 4],
                           max_delay_ms=2.0, name=_uname("once"))
        assert srv.warmup() == 3
        rs = np.random.RandomState(1)
        for wave in (1, 2, 3, 4, 7, 1, 5):
            futs = [srv.submit(rs.randn(8).astype(np.float32))
                    for _ in range(wave)]
            for f in futs:
                f.result(timeout=10)
        st = srv.stats()
        srv.close()
        assert st["compile_count"] == 3
        assert st["steady_state_recompiles"] == 0
        assert st["completed"] == 23
        assert st["p50_ms"] > 0 and st["p99_ms"] >= st["p50_ms"]
        assert 0 < st["batch_fill"] <= 1
        stats[pkg] = st
    assert set(stats["port"]) == set(stats["jax"])


def test_conv_bn_hybrid_block_engine_rungs_match_jax():
    """A HybridSequential of Conv2D + BatchNorm + Dense: every rung of the
    port's BlockEngine against the JAX BlockEngine, same weights (moving
    statistics included: predict mode)."""
    def build(m):
        nn = m.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Dense(5))
        return net

    rs = np.random.RandomState(3)
    x = rs.randn(4, 2, 6, 6).astype(np.float32)
    jmx.random.seed(11)
    jnet = build(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k in arrays:  # non-trivial moving statistics
        if k.endswith("running_mean"):
            arrays[k] = rs.randn(*arrays[k].shape).astype(np.float32) * 0.1
        if k.endswith("running_var"):
            arrays[k] = rs.rand(*arrays[k].shape).astype(np.float32) + 0.5
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(arrays[k]))
    with mx.cpu():
        net = build(mx)
        net.initialize()
        net(mx.nd.array(x))
        tgluon.params_from_jax(net, arrays)
    jeng = jserving.BlockEngine(jnet)
    teng = tserving.BlockEngine(net, device="cpu")
    for b in (1, 2, 4):
        np.testing.assert_allclose(teng.run(x[:b]), jeng.run(x[:b]), **TOL)
    assert teng.compile_count == jeng.compile_count == 3
    teng.run(x[:2])
    assert teng.compile_count == 3


def test_block_engine_returns_every_output():
    """A block of two outputs: the engine returns both (InferStep keeps
    only the first) and the server delivers both to each request."""
    def build(m):
        class Two(m.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.a = m.gluon.nn.Dense(3)
                    self.b = m.gluon.nn.Dense(2)

            def hybrid_forward(self, F, x):
                return self.a(x), self.b(x)

        return Two()

    x = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    jmx.random.seed(2)
    jnet = build(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    with mx.cpu():
        net = build(mx)
        net.initialize()
        net(mx.nd.array(x))
        tgluon.params_from_jax(net, arrays)
    want = jserving.BlockEngine(jnet).run(x)
    got = tserving.BlockEngine(net, device="cpu").run(x)
    assert isinstance(got, tuple) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    with tserving.serve_block(net, (4,), buckets=[4], max_delay_ms=1.0,
                              device="cpu", name=_uname("two")) as srv:
        out = srv.submit(x[1]).result(timeout=10)
    assert isinstance(out, tuple) and len(out) == 2
    np.testing.assert_allclose(out[0], want[0][1], **TOL)
    np.testing.assert_allclose(out[1], want[1][1], **TOL)


def test_engines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    net = _mlp("port")
    with pytest.raises(MXNetError, match="CUDA device"):
        tserving.BlockEngine(net)
    with pytest.raises(MXNetError, match="CUDA device"):
        tserving.serve_block(net, (8,))
    with mx.cpu():  # the current context decides
        eng = tserving.BlockEngine(net)
    assert eng._device.type == "cpu"


def test_block_engine_runs_from_many_threads_at_once():
    """The engine's lock under contention: more threads than cores call
    ``run`` at three batch sizes with a short switch interval; every
    result is the block's (an unlocked run would serve one thread's rows
    over another's parameter swap) and each shape counts once."""
    import sys

    net = _mlp("port")
    eng = tserving.BlockEngine(net, device="cpu")
    rs = np.random.RandomState(8)
    xs = {b: rs.randn(b, 8).astype(np.float32) for b in (1, 2, 4)}
    want = {b: _forward("port", net, x) for b, x in xs.items()}
    with mx.cpu():  # the block moves on; the engine's snapshot does not
        for p in net.collect_params().values():
            p.set_data(p.data() * 2.0)
    own = [p.data()._data for p in net.collect_params().values()]
    errors = []

    def worker(k):
        try:
            for i in range(20):
                b = (1, 2, 4)[(k + i) % 3]
                np.testing.assert_allclose(eng.run(xs[b]), want[b], **TOL)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(repr(e))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert eng.compile_count == 3
    # and the block holds its own parameters again
    assert all(p.data()._data is t
               for p, t in zip(net.collect_params().values(), own))


@BOTH
def test_concurrent_submit_exact_results(pkg):
    S = PKGS[pkg][1]
    eng = _engines(S)[0]()
    srv = S.Server(eng, (4,), buckets=[1, 4, 16], max_delay_ms=1.0,
                   queue_depth=1024, name=_uname("conc"))
    n_threads, per = 4, 30
    results = {}

    def client(tid):
        futs = []
        for i in range(per):
            row = np.full((4,), tid * 1000 + i, np.float32)
            futs.append((row, srv.submit(row)))
        results[tid] = [(row, f.result(timeout=10)) for row, f in futs]

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.close()
    assert sorted(results) == list(range(n_threads))
    for tid in results:
        for row, got in results[tid]:
            np.testing.assert_array_equal(got, row * 2.0)
    assert max(eng.batch_sizes) <= 16


@BOTH
def test_submit_validates_shape_before_enqueue(pkg):
    S = PKGS[pkg][1]
    with S.Server(_engines(S)[0](), (4,), buckets=[1],
                  name=_uname("val")) as srv:
        with pytest.raises(Exception) as ei:
            srv.submit(np.zeros((5,), np.float32))
        assert type(ei.value).__name__ == "MXNetError"
        assert srv.stats()["submitted"] == 0


@BOTH
def test_multi_output_delivery(pkg):
    S = PKGS[pkg][1]
    with S.Server(_engines(S)[3](), (3,), buckets=[4], max_delay_ms=1.0,
                  name=_uname("multi")) as srv:
        row = np.arange(3, dtype=np.float32)
        out = srv.submit(row).result(timeout=10)
    assert isinstance(out, tuple) and len(out) == 2
    np.testing.assert_array_equal(out[0], row * 2.0)
    np.testing.assert_array_equal(out[1], row + 1.0)


# ---------------------------------------------------------------------------
# robustness policy
# ---------------------------------------------------------------------------

@BOTH
def test_timeout_of_stale_queued_request(pkg):
    S = PKGS[pkg][1]
    eng = _engines(S)[1](hold_s=0.5)
    srv = S.Server(eng, (2,), buckets=[1], max_delay_ms=0.0, timeout_ms=0,
                   name=_uname("stale"))
    f1 = srv.submit(np.zeros(2, np.float32))
    assert eng.started.wait(5)
    f2 = srv.submit(np.ones(2, np.float32), timeout_ms=50)
    time.sleep(0.1)
    eng.gate.set()
    np.testing.assert_array_equal(f1.result(timeout=10), np.zeros(2))
    with pytest.raises(S.RequestTimeoutError):
        f2.result(timeout=10)
    st = srv.stats()
    srv.close()
    assert st["timeouts"] == 1 and st["completed"] == 1


@BOTH
def test_shed_on_full_queue(pkg):
    S = PKGS[pkg][1]
    eng = _engines(S)[1](hold_s=1.0)
    srv = S.Server(eng, (2,), buckets=[1], max_delay_ms=0.0, queue_depth=2,
                   timeout_ms=0, name=_uname("shed"))
    first = srv.submit(np.zeros(2, np.float32))
    assert eng.started.wait(5)
    q1 = srv.submit(np.ones(2, np.float32))
    q2 = srv.submit(np.ones(2, np.float32))
    with pytest.raises(S.QueueFullError):
        srv.submit(np.ones(2, np.float32))
    eng.gate.set()
    for f in (first, q1, q2):
        f.result(timeout=10)
    st = srv.stats()
    srv.close()
    assert st["shed"] == 1 and st["completed"] == 3


@BOTH
def test_graceful_drain_on_close(pkg):
    S = PKGS[pkg][1]
    srv = S.Server(_engines(S)[0](), (2,), buckets=[1, 4], max_delay_ms=20.0,
                   queue_depth=256, timeout_ms=0, name=_uname("drain"))
    futs = [srv.submit(np.full(2, i, np.float32)) for i in range(25)]
    srv.close()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=0.001),
                                      np.full(2, 2 * i))
    assert srv.stats()["completed"] == 25


@BOTH
def test_close_without_drain_fails_queued(pkg):
    S = PKGS[pkg][1]
    eng = _engines(S)[1](hold_s=0.3)
    srv = S.Server(eng, (2,), buckets=[1], max_delay_ms=0.0, timeout_ms=0,
                   name=_uname("nodrain"))
    f1 = srv.submit(np.zeros(2, np.float32))
    assert eng.started.wait(5)
    f2 = srv.submit(np.ones(2, np.float32))
    srv.close(drain=False)
    np.testing.assert_array_equal(f1.result(timeout=10), np.zeros(2))
    with pytest.raises(S.ServerClosedError):
        f2.result(timeout=10)
    with pytest.raises(S.ServerClosedError):
        srv.submit(np.zeros(2, np.float32))


@BOTH
def test_error_isolation_poisoned_request(pkg):
    S = PKGS[pkg][1]
    Poison = _engines(S)[2]
    srv = S.Server(Poison(), (4,), buckets=[4], max_delay_ms=100.0,
                   timeout_ms=0, name=_uname("poison"))
    rows = [np.full((4,), i + 1, np.float32) for i in range(3)]
    rows.append(np.full((4,), Poison.POISON, np.float32))
    futs = [srv.submit(r) for r in rows]
    for r, f in zip(rows[:3], futs[:3]):
        np.testing.assert_array_equal(f.result(timeout=10), r * 2.0)
    with pytest.raises(ValueError):
        futs[3].result(timeout=10)
    st = srv.stats()
    srv.close()
    assert st["isolation_retries"] >= 1
    assert st["errors"] == 1 and st["completed"] == 3


@BOTH
def test_batcher_survives_malformed_engine_output(pkg):
    S = PKGS[pkg][1]

    class BadOnce(S.Engine):
        def __init__(self):
            self.calls = 0

        def run(self, batch):
            self.calls += 1
            if self.calls == 1:
                return batch[:1] * 2.0
            return batch * 2.0

    srv = S.Server(BadOnce(), (2,), buckets=[2], max_delay_ms=50.0,
                   timeout_ms=0, name=_uname("bad"))
    f1 = srv.submit(np.zeros(2, np.float32))
    f2 = srv.submit(np.ones(2, np.float32))
    with pytest.raises(Exception):
        f1.result(timeout=10), f2.result(timeout=10)
    f3 = srv.submit(np.full(2, 3.0, np.float32))
    f4 = srv.submit(np.full(2, 4.0, np.float32))
    np.testing.assert_array_equal(f3.result(timeout=10), np.full(2, 6.0))
    np.testing.assert_array_equal(f4.result(timeout=10), np.full(2, 8.0))
    srv.close()


@BOTH
def test_env_knob_defaults(pkg, monkeypatch):
    S = PKGS[pkg][1]
    monkeypatch.setenv("MXNET_SERVING_QUEUE_DEPTH", "3")
    monkeypatch.setenv("MXNET_SERVING_BUCKETS", "1,2")
    srv = S.Server(_engines(S)[0](), (2,), name=_uname("env"))
    try:
        assert srv._queue_depth == 3
        assert srv._ladder == (1, 2)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# tenancy, resilience and telemetry over the Server
# ---------------------------------------------------------------------------

def _poison_tenant_run(S, unavailable):
    class PoisonRows(S.Engine):
        kind = "poison"

        def run(self, batch):
            if (batch > 100.0).any():
                raise RuntimeError("poisoned row in batch")
            return batch * 2.0

        @property
        def compile_count(self):
            return 0

    srv = S.Server(PoisonRows(), (4,), buckets=[1, 4], max_delay_ms=1.0,
                   timeout_ms=0, name=_uname("srv"), breaker_threshold=100)
    srv.tenants.register("evil", breaker_threshold=3, breaker_window_s=60.0,
                         breaker_reset_s=60.0)
    srv.tenants.register("good")
    outcomes = []
    try:
        poison = np.full((4,), 200.0, np.float32)
        ok = np.ones((4,), np.float32)
        for _ in range(8):
            try:
                f = srv.submit(poison, tenant="evil")
                with pytest.raises(RuntimeError):
                    f.result(timeout=30)
                outcomes.append("failed")
            except unavailable:
                outcomes.append("shed")
            out = srv.submit(ok, tenant="good").result(timeout=30)
            np.testing.assert_allclose(out, ok * 2.0)
        stats = srv.stats()
    finally:
        srv.close(timeout=10)
    return outcomes, stats


def test_server_tenant_breaker_sheds_poison_tenant_alone():
    runs = {}
    for pkg in ("jax", "port"):
        S = PKGS[pkg][1]
        outcomes, stats = _poison_tenant_run(S, S.TenantUnavailableError)
        assert outcomes.count("failed") >= 3 and "shed" in outcomes
        assert stats["tenants"]["evil"]["breaker"] in ("open", "half_open")
        assert stats["tenants"]["good"]["completed"] == 8
        assert stats["tenants"]["good"]["breaker"] == "closed"
        assert stats["breakers"]["primary"] == "closed"
        runs[pkg] = outcomes
    assert runs["port"] == runs["jax"]


@BOTH
def test_server_refresh_params_is_a_live_swap(pkg):
    S = PKGS[pkg][1]

    class Swappable(S.Engine):
        kind = "swappable"

        def __init__(self):
            self.source = {"scale": 2.0}
            self._scale = 2.0

        def refresh_params(self):
            self._scale = self.source["scale"]

        def run(self, batch):
            return batch * self._scale

        @property
        def compile_count(self):
            return 0

    srv = S.Server(Swappable(), (2,), buckets=[1, 4], max_delay_ms=1.0,
                   timeout_ms=0, name=_uname("srv"))
    try:
        x = np.asarray([1.0, 2.0], np.float32)
        np.testing.assert_allclose(srv.submit(x).result(timeout=30), x * 2)
        srv._engine.source["scale"] = 3.0
        assert srv.refresh_params() == 1
        np.testing.assert_allclose(srv.submit(x).result(timeout=30), x * 3)
        assert srv.stats()["errors"] == 0
    finally:
        srv.close(timeout=10)


@BOTH
def test_server_weighted_fair_batch_fill(pkg):
    S = PKGS[pkg][1]

    class Slow(S.Engine):
        kind = "slow"

        def run(self, batch):
            time.sleep(0.01)
            return batch * 2.0

        @property
        def compile_count(self):
            return 0

    srv = S.Server(Slow(), (2,), buckets=[2], max_delay_ms=1.0, timeout_ms=0,
                   name=_uname("srv"), tenants="hot;bg")
    try:
        order = []
        futs = []
        x = np.ones((2,), np.float32)
        for i in range(12):
            f = srv.submit(x * i, tenant="hot")
            f.add_done_callback(lambda _f: order.append("hot"))
            futs.append(f)
        for _ in range(3):
            f = srv.submit(x, tenant="bg")
            f.add_done_callback(lambda _f: order.append("bg"))
            futs.append(f)
        for f in futs:
            f.result(timeout=60)
        stats = srv.stats()
        assert stats["tenants"]["bg"]["completed"] == 3
        assert max(i for i, t in enumerate(order) if t == "bg") < 14
    finally:
        srv.close(timeout=10)


def test_chaos_serving_soak_every_request_answered():
    n = 120
    rs = np.random.RandomState(0)
    reqs = rs.rand(n, 4).astype(np.float32)
    for pkg in ("jax", "port"):
        _m, S, res, tel = PKGS[pkg]
        Double = _engines(S)[0]
        name = _uname("soak")
        with res.chaos.active("seed=7,site=serving.engine,p=0.1"):
            srv = S.Server(Double(), (4,), buckets=[1, 4, 8],
                           max_delay_ms=1.0, timeout_ms=0, name=name)
            futures = []

            def client(lo, hi):
                for i in range(lo, hi):
                    futures.append((i, srv.submit(reqs[i])))

            threads = [threading.Thread(target=client,
                                        args=(c * 30, (c + 1) * 30))
                       for c in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            answered = errored = 0
            for i, fut in futures:
                try:
                    out = fut.result(timeout=30)
                    np.testing.assert_allclose(out, reqs[i] * 2.0, rtol=1e-6)
                    answered += 1
                except Exception:
                    errored += 1
            stats = srv.stats()
            srv.close(timeout=10)
            injected = res.chaos.injected_counts()
        assert answered + errored == n
        assert injected.get("serving.engine", 0) > 0
        assert answered >= int(n * 0.9)
        assert stats["completed"] == answered
        assert stats["breakers"]["primary"] in ("closed", "half_open", "open")
        retries = tel.REGISTRY.get("mxnet_retries_total")
        assert retries.value(site="serving.engine", outcome="retry") > 0


@BOTH
def test_serving_breaker_trips_falls_back_and_recovers(pkg):
    _m, S, res, tel = PKGS[pkg]

    class Flaky(S.Engine):
        kind = "flaky"

        def __init__(self):
            self.broken = True

        def run(self, batch):
            if self.broken:
                raise ValueError("engine down")
            return batch * 10.0

    primary = Flaky()
    name = _uname("brk")
    srv = S.Server(primary, (3,), buckets=[1, 4], max_delay_ms=1.0,
                   fallback_engine=_engines(S)[0](), breaker_threshold=2,
                   breaker_reset_s=0.2, name=name,
                   retry_policy=res.RetryPolicy(max_attempts=1))
    x = np.ones(3, np.float32)
    for _ in range(4):
        np.testing.assert_allclose(srv.submit(x).result(10), x * 2.0)
    st = srv.stats()
    assert st["breakers"]["primary"] in ("open", "half_open")
    assert st["breakers"]["fallback"] == "closed"
    assert st["fallbacks"] == 4
    assert st["engine_failures"]["primary"] == 2
    g = tel.REGISTRY.get("mxnet_breaker_state")
    assert g.value(site="serving.%s.primary" % name) in (1, 2)
    primary.broken = False
    time.sleep(0.25)
    np.testing.assert_allclose(srv.submit(x).result(10), x * 10.0)
    assert srv.stats()["breakers"]["primary"] == "closed"
    srv.close()


@BOTH
def test_serving_load_sheds_when_all_breakers_open(pkg):
    _m, S, res, _tel = PKGS[pkg]

    class Dead(S.Engine):
        def run(self, batch):
            raise ValueError("permanently down")

    srv = S.Server(Dead(), (3,), buckets=[1], max_delay_ms=0.5,
                   breaker_threshold=1, breaker_reset_s=30.0,
                   name=_uname("dead"),
                   retry_policy=res.RetryPolicy(max_attempts=1))
    x = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        srv.submit(x).result(10)
    with pytest.raises(S.EngineUnavailableError):
        srv.submit(x).result(10)
    st = srv.stats()
    srv.close()
    assert st["unavailable"] == 1
    assert st["breakers"]["primary"] == "open"


def test_serving_smoke_series_match_jax_names():
    """The serving half of ``test_telemetry.py``'s smoke: a tiny MLP
    behind a Server publishes the latency summary, the steady-state
    gauge at 0, and the same serving families as the JAX package's."""
    fams = {}
    for pkg in ("jax", "port"):
        _m, S, _res, tel = PKGS[pkg]
        name = _uname("t_smoke")
        net = _mlp(pkg, in_dim=4, out_dim=2)
        srv = _serve_block(pkg, net, (4,), buckets=(1, 4), max_delay_ms=1.0,
                           name=name)
        try:
            srv.warmup()
            rs = np.random.RandomState(9)
            futs = [srv.submit(rs.rand(4).astype(np.float32))
                    for _ in range(8)]
            for f in futs:
                f.result(timeout=30)
            stats = srv.stats()
        finally:
            srv.close()
        assert stats["steady_state_recompiles"] == 0
        assert tel.STEADY_STATE_RECOMPILES.value(
            site="serving." + name) == 0.0
        text = tel.render_prometheus()
        samples = [l for l in text.splitlines()
                   if l and not l.startswith("#") and name in l]
        assert any('quantile="0.5"' in s for s in samples
                   if s.startswith("mxnet_serving_latency_ms"))
        assert any('quantile="0.99"' in s for s in samples
                   if s.startswith("mxnet_serving_latency_ms"))
        fams[pkg] = {s.split("{")[0] for s in samples}
    assert fams["port"] == fams["jax"]
    assert "mxnet_serving_batches_total" in fams["port"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_block_engine_captured_rungs_match_eager_on_the_card(cuda_device):
    net = _mlp("port")
    for p in net.collect_params().values():
        p.data()._data = p.data()._data.cuda()
    eng = tserving.BlockEngine(net, device=cuda_device)
    x = np.random.RandomState(6).randn(4, 8).astype(np.float32)
    with mx.gpu(0), mx.autograd.pause():
        want = net(mx.nd.array(x)).asnumpy()
    for b in (1, 2, 4):
        for _ in range(2):  # the capture, then a replay
            np.testing.assert_allclose(eng.run(x[:b]), want[:b], **TOL)
    assert eng.compile_count == 3 and eng.graph_replays == 6
    srv = tserving.Server(eng, (8,), buckets=[1, 2, 4], max_delay_ms=1.0,
                          name=_uname("card"))
    try:
        srv.warmup()  # captures on this thread; the batcher replays
        futs = [srv.submit(x[i]) for i in range(4)]
        got = np.stack([f.result(timeout=30) for f in futs])
        assert srv.stats()["steady_state_recompiles"] == 0
    finally:
        srv.close()
    np.testing.assert_allclose(got, want, **TOL)
    # a refresh, then the parameter changed in place on the caller's
    # stream at once: the snapshot holds the value at the refresh
    w = net[1].weight.data()._data
    with torch.no_grad():
        w.mul_(2.0)
    with mx.gpu(0), mx.autograd.pause():
        want2 = net(mx.nd.array(x)).asnumpy()
    eng.refresh_params()
    with torch.no_grad():
        w.fill_(float("nan"))
    for b in (1, 4):
        np.testing.assert_allclose(eng.run(x[:b]), want2[:b], **TOL)
    assert eng.compile_count == 3
