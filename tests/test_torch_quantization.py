"""The port's int8 quantization against the JAX package's (CPU).

* The 7 ops of ``ops/quantization.py`` (``torch_vision_cases``'
  quantization group, through ``torch_op_sweep``): int8/uint8/int32
  outputs exactly, ranges and dequantized values within 2e-5; the int32
  accumulators of ``quantized_conv`` and ``quantized_fully_connected``
  at sizes whose sums pass 2^24 (float32 could not hold them), exactly.
* the KL-optimal threshold of ``calib_mode='entropy'``: the port's
  search (its inner loop vectorized) gives the JAX search's bits;
* the port's ``example/quantization/quantize_model.py`` on the CPU
  against the JAX example's printed errors and agreements (the JAX
  example's threshold search swapped for the port's, which the previous
  test holds equal: the JAX one takes seconds a tensor).

``quantize_model`` itself is in ``test_torch_quantize_model.py``.
"""
import io
import os
import runpy
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.contrib import quantization as tq
from torch_op_sweep import check, same
from torch_vision_cases import VISION_CASES, group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


@pytest.mark.parametrize("case", group("quantization"))
def test_quantization_op_matches_jax(case):
    check(*VISION_CASES[case], "float32")


def _ranges(*pairs):
    return [np.asarray([v], np.float32) for p in pairs for v in p]


@pytest.mark.parametrize("op,shapes,attrs", [
    ("_contrib_quantized_conv", ((2, 512, 5, 5), (8, 512, 3, 3)),
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 8, "no_bias": True}),
    ("_contrib_quantized_fully_connected", ((3, 2048), (10, 2048)),
     {"num_hidden": 10, "no_bias": True})])
def test_int32_accumulators_are_exact_past_float32(op, shapes, attrs):
    rs = np.random.RandomState(0)
    # extreme int8 values, mostly of one sign, so that the sums pass 2^24
    x = rs.choice([-127, 127], shapes[0], p=[0.1, 0.9]).astype(np.int8)
    w = rs.choice([-127, 127], shapes[1], p=[0.1, 0.9]).astype(np.int8)
    ins = [x, w] + _ranges((-1.0, 1.0), (-1.0, 1.0))
    got = mx.nd.invoke(op, *[mx.nd.array(a, dtype=a.dtype) for a in ins],
                       **attrs)
    want = jmx.nd.invoke(op, *[jmx.nd.array(a, dtype=a.dtype) for a in ins],
                         **attrs)
    acc = got[0].asnumpy()
    assert acc.dtype == np.int32
    np.testing.assert_array_equal(acc, want[0].asnumpy())
    assert np.abs(acc).max() > 2 ** 24
    # the float64 product, exactly
    xd, wd = x.astype(np.float64), w.astype(np.float64)
    if op == "_contrib_quantized_fully_connected":
        np.testing.assert_array_equal(acc, (xd @ wd.T).astype(np.int32))
    for g, v in zip(got[1:], want[1:]):
        same(g.asnumpy(), v.asnumpy())


# -- the KL threshold search -----------------------------------------------------


@pytest.mark.parametrize("outliers,num_bins", [(False, 8001), (True, 2001)])
def test_kl_threshold_matches_jax(outliers, num_bins):
    rs = np.random.RandomState(4)
    a = rs.randn(30000).astype(np.float32)
    if outliers:
        a[::97] *= 30.0
    assert tq._get_optimal_threshold(a, num_bins=num_bins) == \
        jq._get_optimal_threshold(a, num_bins=num_bins)


# -- the example ---------------------------------------------------------------


def _run_script(path, argv):
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [path] + argv
    try:
        with redirect_stdout(buf):
            try:
                runpy.run_path(path, run_name="__main__")
                code = 0
            except SystemExit as e:
                code = e.code
    finally:
        sys.argv = old
    return code, buf.getvalue()


def test_example_prints_what_the_jax_example_prints(monkeypatch):
    # the JAX search's bin-by-bin loop takes seconds a tensor; its
    # results are the port's (test_kl_threshold_matches_jax)
    monkeypatch.setattr(jq, "_get_optimal_threshold",
                        tq._get_optimal_threshold)
    j_code, j_out = _run_script(
        os.path.join(ROOT, "example", "quantization", "quantize_model.py"),
        ["--num-calib", "128"])
    p_code, p_out = _run_script(
        os.path.join(ROOT, "mxnet_tpu_torch", "example", "quantization",
                     "quantize_model.py"),
        ["--num-calib", "128", "--device", "cpu"])
    assert p_code == j_code == 0
    assert p_out.splitlines() == j_out.splitlines()
    assert p_out.splitlines()[-1] == "ENTROPY_BEATS_NAIVE"
