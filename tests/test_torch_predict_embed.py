"""``_predict_embed``: the Python half of the C predict ABI and its batched
entry, the port against the JAX package (CPU).

Both packages get the same symbol JSON and the same ``.params`` bytes
(written by the JAX package); single and batched predictions agree with
each other and across packages within fp32 2e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import _predict_embed as jpe
from mxnet_tpu import model as jmodel

from mxnet_tpu_torch import _predict_embed as tpe
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=2e-5, atol=2e-5)
PES = {"jax": jpe, "port": tpe}


def _checkpoint(tmp_path, build, in_shape, seed, scale=0.3):
    """A JAX symbol and its parameters saved by the JAX package: (json,
    params bytes)."""
    sym = build(jmx.symbol)
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(data=in_shape)
    args = {n: jmx.nd.array(rs.randn(*s).astype(np.float32) * scale)
            for n, s in zip(sym.list_arguments(), arg_shapes) if n != "data"}
    prefix = str(tmp_path / "m")
    jmodel.save_checkpoint(prefix, 0, sym, args, {})
    with open(prefix + "-0000.params", "rb") as f:
        return sym.tojson(), f.read()


def _mlp(S):
    data = S.var("data")
    hid = S.FullyConnected(data, num_hidden=8, name="fc1")
    act = S.Activation(hid, act_type="relu", name="relu1")
    return S.FullyConnected(act, num_hidden=3, name="fc2")


def _single(pe, hdl, xs):
    out = []
    for i in range(len(xs)):
        pe.set_input(hdl, "data", xs[i:i + 1].tobytes())
        pe.forward(hdl)
        out.append(np.frombuffer(pe.get_output(hdl, 0), np.float32))
    return np.stack(out)


def test_forward_batch_matches_single_and_jax(tmp_path):
    js, pb = _checkpoint(tmp_path, _mlp, (1, 5), 0)
    xs = np.random.RandomState(1).randn(6, 5).astype(np.float32) * 0.1
    seq, bat = {}, {}
    for pkg, pe in PES.items():
        hdl = pe.create(js, pb, 1, ["data"], [[1, 5]])
        try:
            assert pe.num_outputs(hdl) in (0, 1)
            seq[pkg] = _single(pe, hdl, xs)
            assert pe.num_outputs(hdl) == 1
            assert pe.get_output_shape(hdl, 0) == [1, 3]
            got = pe.forward_batch(hdl, [x.tobytes() for x in xs])
            bat[pkg] = np.stack([np.frombuffer(g, np.float32) for g in got])
            assert pe._HANDLES[hdl].server().stats()["compile_count"] >= 1
        finally:
            pe.free(hdl)
        np.testing.assert_allclose(bat[pkg], seq[pkg], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(seq["port"], seq["jax"], **TOL)
    np.testing.assert_allclose(bat["port"], bat["jax"], **TOL)


def test_forward_batch_larger_than_queue(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_QUEUE_DEPTH", "8")

    def build(S):
        return S.FullyConnected(S.var("data"), num_hidden=2, name="fc")

    js, pb = _checkpoint(tmp_path, build, (1, 3), 1, scale=1.0)
    xs = np.random.RandomState(2).randn(40, 3).astype(np.float32)
    outs = {}
    for pkg, pe in PES.items():
        hdl = pe.create(js, pb, 1, ["data"], [[1, 3]])
        try:
            got = pe.forward_batch(hdl, [x.tobytes() for x in xs])
            assert len(got) == 40
            outs[pkg] = np.stack([np.frombuffer(g, np.float32) for g in got])
            ref0 = _single(pe, hdl, xs[:1])[0]
            np.testing.assert_allclose(outs[pkg][0], ref0, rtol=1e-5,
                                       atol=1e-6)
        finally:
            pe.free(hdl)
        with pytest.raises(KeyError):  # freed handles refuse a server
            pe.forward_batch(hdl, [xs[0].tobytes()])
        pe.free(hdl)  # a second free is a no-op
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)


def test_multi_output_graph_and_output_index(tmp_path):
    def build(S):
        data = S.var("data")
        a = S.FullyConnected(data, num_hidden=4, name="fa")
        b = S.FullyConnected(data, num_hidden=2, name="fb")
        return S.Group([a, b])

    js, pb = _checkpoint(tmp_path, build, (1, 3), 3)
    xs = np.random.RandomState(4).randn(5, 3).astype(np.float32)
    outs = {}
    for pkg, pe in PES.items():
        hdl = pe.create(js, pb, 1, ["data"], [[1, 3]])
        try:
            pe.set_input(hdl, "data", xs[:1].tobytes())
            pe.forward(hdl)
            assert pe.num_outputs(hdl) == 2
            assert pe.get_output_shape(hdl, 1) == [1, 2]
            second = np.frombuffer(pe.get_output(hdl, 1), np.float32)
            got = pe.forward_batch(hdl, [x.tobytes() for x in xs],
                                   output_index=1)
            outs[pkg] = np.stack([np.frombuffer(g, np.float32) for g in got])
            np.testing.assert_allclose(outs[pkg][0], second, rtol=1e-5,
                                       atol=1e-6)
        finally:
            pe.free(hdl)
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)


def test_reshape_closes_the_server_and_rebinds(tmp_path):
    js, pb = _checkpoint(tmp_path, _mlp, (1, 5), 5)
    xs = np.random.RandomState(6).randn(2, 5).astype(np.float32)
    got = {}
    for pkg, pe in PES.items():
        hdl = pe.create(js, pb, 1, ["data"], [[1, 5]])
        try:
            p = pe._HANDLES[hdl]
            srv = p.server()
            p.reshape({"data": (2, 5)})
            assert srv.closed and p._server is None
            pe.set_input(hdl, "data", xs.tobytes())
            pe.forward(hdl)
            assert pe.get_output_shape(hdl, 0) == [2, 3]
            got[pkg] = np.frombuffer(pe.get_output(hdl, 0),
                                     np.float32).reshape(2, 3)
        finally:
            pe.free(hdl)
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)


def test_dev_type_2_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: gpu() is valid here")
    js, pb = _checkpoint(tmp_path, _mlp, (1, 5), 7)
    with pytest.raises(MXNetError, match="CUDA device"):
        tpe.create(js, pb, 2, ["data"], [[1, 5]])


def test_batched_server_refuses_several_inputs(tmp_path):
    def build(S):
        return S.elemwise_add(S.var("data"), S.var("other"), name="add")

    sym = build(jmx.symbol)
    js = sym.tojson()
    for pkg, pe in PES.items():
        hdl = pe.create(js, b"", 1, ["data", "other"], [[1, 3], [1, 3]])
        try:
            with pytest.raises(ValueError, match="single-input"):
                pe.forward_batch(hdl, [np.zeros(3, np.float32).tobytes()])
        finally:
            pe.free(hdl)
