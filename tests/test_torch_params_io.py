"""The port's ``.params`` container (``mxnet_tpu_torch/ndarray/io_utils.py``)
against the JAX package's (``mxnet_tpu/ndarray/io_utils.py``), on the CPU.

* ``nd.save`` of the same seeded dict (float32, float16, uint8, int32,
  int8 and a 0-d array) gives identical bytes from both packages, and
  each package loads the other's file to equal arrays and dtypes;
* hand-built files of the older layouts (V1, pre-V1) and sparse entries
  (row_sparse, CSR, made dense) load alike in both;
* a list (no names) and a single NDArray round-trip; bfloat16 is written
  as float32; the port's int64/float64 arrays are written with their own
  type flags (6, 1) and read back by value in the JAX package;
* ``fetch_host``/``device_arrays`` keep order and values on the CPU;
* ``Symbol.save``/``sym.load`` cross the packages, and the commit is
  atomic: a failed attempt leaves the old file and no temporary file,
  and ``mxnet_ckpt_bytes_total{kind="symbol"}`` counts the bytes.
"""
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import io_utils as jio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import elastic, resilience, telemetry
from mxnet_tpu_torch.ndarray import io_utils as tio

DTYPES = (np.float32, np.float16, np.uint8, np.int32, np.int8)


def _seeded(seed):
    """A name -> numpy dict of every dtype both packages write alike, a
    0-d array among them."""
    rs = np.random.RandomState(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = tuple(int(d) for d in rs.randint(1, 5, rs.randint(1, 4)))
        out["arg:p%d_%s" % (i, np.dtype(dt).name)] = (
            rs.rand(*shape) * 100 - (0 if dt == np.uint8 else 50)).astype(dt)
    out["aux:scalar"] = np.asarray(rs.rand(), np.float32)
    return out


def _jax_save(path, arrays):
    jmx.nd.save(path, {k: jmx.nd.array(v, dtype=v.dtype)
                       for k, v in arrays.items()})


def _port_save(path, arrays):
    with mx.cpu():
        mx.nd.save(path, {k: mx.nd.array(v, dtype=v.dtype)
                          for k, v in arrays.items()})


def _port_load(path):
    with mx.cpu():
        out = mx.nd.load(path)
    if isinstance(out, dict):
        return {k: v.asnumpy() for k, v in out.items()}
    return [v.asnumpy() for v in out]


def _jax_load(path):
    out = jmx.nd.load(path)
    if isinstance(out, dict):
        return {k: v.asnumpy() for k, v in out.items()}
    return [v.asnumpy() for v in out]


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        if w.ndim == 0:  # persisted as (1,)
            w = w.reshape(1)
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("seed", range(5))
def test_same_bytes_and_cross_load(tmp_path, seed):
    arrays = _seeded(seed)
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    _jax_save(jpath, arrays)
    _port_save(tpath, arrays)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    _same(_port_load(jpath), arrays)
    _same(_jax_load(tpath), arrays)


def _header(n):
    return struct.pack("<QQQ", jio.kMXAPINDArrayListMagic, 0, n)


def _names(names):
    out = struct.pack("<Q", len(names))
    for n in names:
        out += struct.pack("<Q", len(n)) + n.encode()
    return out


def _legacy_file(kind, rs):
    """A file of the older layouts or with sparse entries, built byte by
    byte as the reference writes them; returns (bytes, expected dict)."""
    a = rs.rand(3, 4).astype(np.float32)
    b = rs.randint(-5, 5, (5,)).astype(np.int32)
    if kind == "v1":
        body = b""
        for arr, flag in ((a, 0), (b, 4)):
            body += struct.pack("<II", jio.NDARRAY_V1_MAGIC, arr.ndim)
            body += struct.pack("<%dq" % arr.ndim, *arr.shape)
            body += struct.pack("<iii", 1, 0, flag) + arr.tobytes()
        return _header(2) + body + _names(["a", "b"]), {"a": a, "b": b}
    if kind == "pre_v1":
        body = b""
        for arr, flag in ((a, 0), (b, 4)):
            body += struct.pack("<I", arr.ndim)
            body += struct.pack("<%dI" % arr.ndim, *arr.shape)
            body += struct.pack("<iii", 1, 0, flag) + arr.tobytes()
        return _header(2) + body + _names(["a", "b"]), {"a": a, "b": b}
    dense = np.zeros((4, 3), np.float32)
    if kind == "row_sparse":
        rows = np.array([0, 2], np.int64)
        data = rs.rand(2, 3).astype(np.float32)
        dense[rows] = data
        body = struct.pack("<Ii", jio.NDARRAY_V2_MAGIC, 1)
        body += struct.pack("<I2q", 2, 2, 3)          # storage shape
        body += struct.pack("<I2q", 2, 4, 3)          # shape
        body += struct.pack("<iii", 1, 0, 0)          # context, float32
        body += struct.pack("<iI1q", 6, 1, 2)         # aux: int64 (2,)
        body += data.tobytes() + rows.tobytes()
    else:  # csr
        indptr = np.array([0, 1, 1, 3, 3], np.int64)
        cols = np.array([2, 0, 1], np.int64)
        data = rs.rand(3).astype(np.float32)
        for r in range(4):
            for j in range(indptr[r], indptr[r + 1]):
                dense[r, cols[j]] = data[j]
        body = struct.pack("<Ii", jio.NDARRAY_V2_MAGIC, 2)
        body += struct.pack("<I1q", 1, 3)
        body += struct.pack("<I2q", 2, 4, 3)
        body += struct.pack("<iii", 1, 0, 0)
        body += struct.pack("<iI1q", 6, 1, 5) + struct.pack("<iI1q", 6, 1, 3)
        body += data.tobytes() + indptr.tobytes() + cols.tobytes()
    return _header(1) + body + _names(["s"]), {"s": dense}


@pytest.mark.parametrize("kind", ["v1", "pre_v1", "row_sparse", "csr"])
def test_older_layouts_and_sparse_load_alike(tmp_path, kind):
    blob, want = _legacy_file(kind, np.random.RandomState(3))
    path = str(tmp_path / (kind + ".params"))
    with open(path, "wb") as f:
        f.write(blob)
    _same(_port_load(path), want)
    _same(_jax_load(path), want)


def test_list_and_single_array_round_trip(tmp_path):
    rs = np.random.RandomState(1)
    xs = [rs.rand(2, 3).astype(np.float32), rs.rand(4).astype(np.float16)]
    path = str(tmp_path / "list.params")
    with mx.cpu():
        mx.nd.save(path, [mx.nd.array(x, dtype=x.dtype) for x in xs])
    for got in (_port_load(path), _jax_load(path)):
        assert isinstance(got, list) and len(got) == 2
        for g, x in zip(got, xs):
            np.testing.assert_array_equal(g, x)
            assert g.dtype == x.dtype
    with mx.cpu():
        mx.nd.save(path, mx.nd.array(xs[0]))
    np.testing.assert_array_equal(_port_load(path)[0], xs[0])


def test_bf16_written_as_float32(tmp_path):
    x = np.random.RandomState(2).rand(3, 5).astype(np.float32)
    path = str(tmp_path / "bf16.params")
    with mx.cpu():
        mx.nd.save(path, {"w": mx.nd.array(x, dtype="bfloat16")})
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    for got in (_port_load(path), _jax_load(path)):
        assert got["w"].dtype == np.float32
        np.testing.assert_array_equal(got["w"], want)


def _type_flags(path):
    """The type flag of each (dense, V2) entry of a ``.params`` file."""
    with open(path, "rb") as f:
        buf = f.read()
    n, pos, flags = struct.unpack_from("<Q", buf, 16)[0], 24, []
    for _ in range(n):
        ndim = struct.unpack_from("<I", buf, pos + 8)[0]
        shape = struct.unpack_from("<%dq" % ndim, buf, pos + 12)
        pos += 12 + 8 * ndim + 8
        flag = struct.unpack_from("<i", buf, pos)[0]
        flags.append(flag)
        pos += 4 + int(np.prod(shape)) * np.dtype(
            jio._TYPE_FLAG_TO_NP[flag]).itemsize
    return flags


def test_64bit_arrays_keep_their_type_flags(tmp_path):
    """The port keeps int64/float64 and writes flags 6/1; the JAX package
    reads them by value (it runs without 64-bit types)."""
    i64 = np.arange(-3, 3, dtype=np.int64).reshape(2, 3)
    f64 = np.linspace(-1, 1, 4)
    path = str(tmp_path / "wide.params")
    with mx.cpu():
        mx.nd.save(path, {"i": mx.nd.array(i64, dtype=np.int64),
                          "f": mx.nd.array(f64, dtype=np.float64)})
    assert _type_flags(path) == [6, 1]
    raw = jio.load_np(path)
    assert raw["i"].dtype == np.int64 and raw["f"].dtype == np.float64
    port = _port_load(path)
    assert port["i"].dtype == np.int64 and port["f"].dtype == np.float64
    jax = _jax_load(path)
    np.testing.assert_array_equal(jax["i"], i64)
    np.testing.assert_allclose(jax["f"], f64, rtol=1e-7)


def test_unserializable_dtype_raises_alike(tmp_path):
    path = str(tmp_path / "bad.params")
    with pytest.raises(mx.MXNetError, match="not serializable"):
        tio.save(path, {"b": np.zeros(3, bool)})
    with pytest.raises(jmx.base.MXNetError, match="not serializable"):
        jio.save(path, {"b": np.zeros(3, bool)})


def test_fetch_host_and_device_arrays_keep_order_on_the_cpu():
    rs = np.random.RandomState(4)
    xs = [rs.rand(3, 2).astype(np.float32),
          rs.randint(0, 9, (4,)).astype(np.int32),
          rs.rand(5).astype(np.float32)]
    tensors = tio.device_arrays(xs, "cpu")
    assert [t.dtype for t in tensors] == [torch.float32, torch.int32,
                                          torch.float32]
    back = mx.fetch_host(tensors + tensors[:1])
    for got, want in zip(back, xs + xs[:1]):
        np.testing.assert_array_equal(got, want)
    bf = mx.fetch_host([tensors[0].to(torch.bfloat16)])[0]
    assert bf.dtype == np.float32


def _mlp(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=8, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    return s.SoftmaxOutput(s.FullyConnected(net, num_hidden=3, name="fc2"),
                           name="softmax")


def test_symbol_files_cross_the_packages(tmp_path):
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    _mlp(mx).save(tpath)
    _mlp(jmx).save(jpath)
    for path in (tpath, jpath):
        for pkg in (mx, jmx):
            sym = pkg.sym.load(path)
            assert sym.list_arguments() == [
                "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
                "softmax_label"]
            assert sym.list_outputs() == ["softmax_output"]


def test_commit_is_atomic_and_counted(tmp_path, monkeypatch):
    path = str(tmp_path / "s.json")
    before = telemetry.CKPT_BYTES.value(kind="symbol")
    _mlp(mx).save(path)
    with open(path, "rb") as f:
        old = f.read()
    assert telemetry.CKPT_BYTES.value(kind="symbol") - before == len(old)

    def fail_always(site):
        if site == "ckpt.commit":
            raise OSError("disk gone")

    monkeypatch.setattr(resilience.chaos, "maybe_fail", fail_always)
    monkeypatch.setattr(resilience, "default_policy",
                        lambda: resilience.RetryPolicy(
                            max_attempts=2, base_delay_ms=0.0, jitter=0.0,
                            sleep=lambda s: None))
    with pytest.raises(OSError):
        elastic.commit_bytes(path, b"new", kind="symbol")
    with open(path, "rb") as f:
        assert f.read() == old
    assert sorted(os.listdir(tmp_path)) == ["s.json"]
