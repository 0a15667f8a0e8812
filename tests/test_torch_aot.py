"""``aot``: the exported artifact (a ``torch.export`` program) and its
serving engine, the port against the JAX package (CPU).

The same nets (the JAX ones' weights carried into the port's) are
exported by both packages; the port's ``model.pt2`` is held against the
live block and against the JAX ``predict_stablehlo`` of the same weights
(fp32 2e-5), at a polymorphic and a fixed batch, served through
``serve_stablehlo`` (one capture a rung), and with a ``BlockEngine``
fallback. A JAX artifact directory is refused by its format; the
``save_tf`` errors keep the JAX package's order (artifact and manifest
first).
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import aot as jaot
from mxnet_tpu import serving as jserving

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import aot as taot
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=2e-5, atol=2e-5)


def _pair(build, x, seed=7, tweak=None):
    """``build(pkg)`` in both packages; the JAX net's weights (after
    ``tweak(arrays)``) in both."""
    jmx.random.seed(seed)
    jnet = build(jmx)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    if tweak is not None:
        tweak(arrays)
        for k, p in jnet.collect_params().items():
            p.set_data(jmx.nd.array(arrays[k]))
    with mx.cpu():
        net = build(mx)
        net.initialize()
        net(mx.nd.array(x))
        tgluon.params_from_jax(net, arrays)
    return jnet, net


def _mlp(m):
    nn = m.gluon.nn
    net = nn.Sequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    return net


def _conv_bn(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.Dense(5))
    return net


def _stats(arrays):
    rs = np.random.RandomState(12)
    for k in arrays:
        if k.endswith("running_mean"):
            arrays[k] = rs.randn(*arrays[k].shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            arrays[k] = rs.rand(*arrays[k].shape).astype(np.float32) + 0.5


def _live(net, x):
    with mx.cpu(), mx.autograd.pause():
        return net(mx.nd.array(x)).asnumpy()


@pytest.mark.parametrize("case", ["mlp", "conv_bn"])
def test_poly_artifact_matches_block_and_jax(case, tmp_path):
    if case == "mlp":
        x = np.random.RandomState(2).randn(5, 8).astype(np.float32)
        jnet, net = _pair(_mlp, x)
    else:
        x = np.random.RandomState(3).randn(5, 2, 6, 6).astype(np.float32)
        jnet, net = _pair(_conv_bn, x, tweak=_stats)
    shape = (1,) + x.shape[1:]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jman = jaot.export_model(jnet, shape, jdir, save_tf=False,
                             poly_batch=True)
    with mx.cpu():
        tman = taot.export_model(net, shape, tdir, save_tf=False,
                                 poly_batch=True)
    assert tman["format"] == "mxnet_tpu_torch-aot-v1"
    assert set(tman) == set(jman)
    for key in ("input_shape", "input_dtype", "poly_batch", "outputs",
                "output_shape", "output_dtype"):
        assert tman[key] == jman[key], key
    assert os.path.exists(os.path.join(tdir, "model.pt2"))
    with open(os.path.join(tdir, "manifest.json")) as f:
        assert json.load(f) == tman
    live = _live(net, x)
    for b in (1, 3, 5):
        want = np.asarray(jaot.predict_stablehlo(jdir, x[:b]))
        with mx.cpu():
            got = taot.predict_stablehlo(tdir, x[:b])
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, live[:b], **TOL)


def test_serve_stablehlo_poly_two_buckets(tmp_path):
    x = np.random.RandomState(2).randn(5, 8).astype(np.float32)
    jnet, net = _pair(_mlp, x)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jaot.export_model(jnet, (1, 8), jdir, save_tf=False, poly_batch=True)
    with mx.cpu():
        taot.export_model(net, (1, 8), tdir, save_tf=False, poly_batch=True)
    got, stats = {}, {}
    for pkg, S, d, kw in (("jax", jserving, jdir, {}),
                          ("port", tserving, tdir, {"device": "cpu"})):
        with S.serve_stablehlo(d, buckets=[1, 4], max_delay_ms=5.0,
                               **kw) as srv:
            srv.warmup()
            futs = [srv.submit(x[i]) for i in range(5)]
            got[pkg] = np.stack([f.result(timeout=10) for f in futs])
            stats[pkg] = srv.stats()
    np.testing.assert_allclose(got["port"], _live(net, x), **TOL)
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)
    assert stats["port"]["compile_count"] == stats["jax"]["compile_count"] \
        == 2
    assert stats["port"]["steady_state_recompiles"] == 0


def test_fixed_shape_artifact_defaults_to_its_own_bucket(tmp_path):
    x = np.random.RandomState(3).randn(2, 8).astype(np.float32)
    jnet, net = _pair(_mlp, x)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jman = jaot.export_model(jnet, (2, 8), jdir, save_tf=False)
    with mx.cpu():
        tman = taot.export_model(net, (2, 8), tdir, save_tf=False)
    assert tman["output_shape"] == jman["output_shape"] == [2, 4]
    assert tman["poly_batch"] is False
    got = {}
    for pkg, S, d, kw in (("jax", jserving, jdir, {}),
                          ("port", tserving, tdir, {"device": "cpu"})):
        with S.serve_stablehlo(d, max_delay_ms=20.0, **kw) as srv:
            assert srv._ladder == (2,)
            futs = [srv.submit(x[i]) for i in range(2)]
            got[pkg] = np.stack([f.result(timeout=10) for f in futs])
    np.testing.assert_allclose(got["port"], _live(net, x), **TOL)
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)
    with mx.cpu():  # the fixed program refuses another batch
        with pytest.raises(Exception):
            taot.predict_stablehlo(tdir, np.concatenate([x, x]))


def test_multi_output_artifact(tmp_path):
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

    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    jnet, net = _pair(build, x)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jman = jaot.export_model(jnet, (1, 4), jdir, save_tf=False,
                             poly_batch=True)
    with mx.cpu():
        tman = taot.export_model(net, (1, 4), tdir, save_tf=False,
                                 poly_batch=True)
        got = taot.predict_stablehlo(tdir, x)
    assert tman["outputs"] == jman["outputs"]
    want = jaot.predict_stablehlo(jdir, x)
    assert isinstance(got, list) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    with tserving.serve_stablehlo(tdir, buckets=[4], max_delay_ms=1.0,
                                  device="cpu") as srv:
        out = srv.submit(x[2]).result(timeout=10)
    assert isinstance(out, tuple) and len(out) == 2
    np.testing.assert_allclose(out[1], np.asarray(want[1])[2], **TOL)


def test_fallback_block_serves_when_the_artifact_breaks(tmp_path):
    x = np.random.RandomState(5).randn(3, 8).astype(np.float32)
    jnet, net = _pair(_mlp, x)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jaot.export_model(jnet, (1, 8), jdir, save_tf=False, poly_batch=True)
    with mx.cpu():
        taot.export_model(net, (1, 8), tdir, save_tf=False, poly_batch=True)
    runs = {}
    for pkg, m, S, d, kw in (("jax", jmx, jserving, jdir, {}),
                             ("port", mx, tserving, tdir,
                              {"device": "cpu"})):
        srv = S.serve_stablehlo(
            d, fallback_block=jnet if pkg == "jax" else net, buckets=[1],
            max_delay_ms=1.0, breaker_threshold=1, breaker_reset_s=60.0,
            name="aotfb%d" % np.random.randint(1 << 30),
            retry_policy=m.resilience.RetryPolicy(max_attempts=1), **kw)
        try:
            assert type(srv._slots[1].engine).__name__ == "BlockEngine"
            srv.warmup()
            first = srv.submit(x[0]).result(timeout=10)

            def broken(batch):
                raise ValueError("artifact engine down")

            srv._engine.run = broken
            served = [srv.submit(x[i]).result(timeout=10) for i in range(3)]
            st = srv.stats()
        finally:
            srv.close()
        assert st["breakers"] == {"primary": "open", "fallback": "closed"}
        assert st["fallbacks"] == 3 and st["engine_failures"]["primary"] == 1
        runs[pkg] = (first, np.stack(served))
    np.testing.assert_allclose(runs["port"][1], _live(net, x), **TOL)
    for a, b in zip(runs["jax"], runs["port"]):
        np.testing.assert_allclose(b, a, **TOL)


def test_jax_artifact_directory_is_refused_by_format(tmp_path):
    x = np.random.RandomState(6).randn(1, 8).astype(np.float32)
    jnet, _net = _pair(_mlp, x)
    jdir = str(tmp_path / "jax")
    jaot.export_model(jnet, (1, 8), jdir, save_tf=False, poly_batch=True)
    for call in (lambda: taot.load_stablehlo(jdir),
                 lambda: tserving.serve_stablehlo(jdir, device="cpu"),
                 lambda: tserving.StableHLOEngine(jdir, device="cpu")):
        with pytest.raises(MXNetError, match="mxnet_tpu-aot-v1"):
            call()
    with pytest.raises(MXNetError, match="not an exported artifact"):
        taot.load_stablehlo(str(tmp_path / "nothing"))


def test_save_tf_errors_keep_the_jax_order(tmp_path):
    x = np.random.RandomState(7).randn(1, 8).astype(np.float32)
    jnet, net = _pair(_mlp, x)
    for pkg, a, n in (("jax", jaot, jnet), ("port", taot, net)):
        with pytest.raises(ValueError, match="poly_batch"):
            a.export_model(n, (1, 8), str(tmp_path / ("p" + pkg)),
                           save_tf=True, poly_batch=True)
    # the default save_tf=True: the artifact and manifest land first
    tdir = str(tmp_path / "tf")
    with mx.cpu():
        with pytest.raises(MXNetError, match="C runner is not ported"):
            taot.export_model(net, (1, 8), tdir)
        got = taot.predict_stablehlo(tdir, x)
    with open(os.path.join(tdir, "manifest.json")) as f:
        assert json.load(f)["format"] == "mxnet_tpu_torch-aot-v1"
    np.testing.assert_allclose(got, _live(net, x), **TOL)


def test_load_is_memoized_on_path_and_mtime(tmp_path):
    x = np.random.RandomState(8).randn(1, 8).astype(np.float32)
    _jnet, net = _pair(_mlp, x)
    tdir = str(tmp_path / "port")
    with mx.cpu():
        taot.export_model(net, (1, 8), tdir, save_tf=False)
    first = taot.load_stablehlo(tdir)
    assert taot.load_stablehlo(tdir) is first
    assert isinstance(first, torch.export.ExportedProgram)
    path = os.path.join(tdir, "model.pt2")
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 5))
    assert taot.load_stablehlo(tdir) is not first


def test_predict_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    x = np.random.RandomState(9).randn(1, 8).astype(np.float32)
    _jnet, net = _pair(_mlp, x)
    tdir = str(tmp_path / "port")
    with mx.cpu():
        taot.export_model(net, (1, 8), tdir, save_tf=False)
        on_host = mx.nd.array(x)
    with pytest.raises(MXNetError):
        taot.predict_stablehlo(tdir, x)
    with pytest.raises(MXNetError):
        tserving.serve_stablehlo(tdir)
    # an NDArray's own device decides
    np.testing.assert_allclose(taot.predict_stablehlo(tdir, on_host),
                               _live(net, x), **TOL)
