"""``contrib.quantization.quantize_model`` on a small conv net (two
convolutions, BatchNorm, a dense layer) against the JAX package's (CPU),
under ``calib_mode`` none, naive and entropy, and with the second
convolution excluded: the checks of ``torch_quant_compare``.
"""
import pytest

import mxnet_tpu_torch as mx
import torch_quant_compare as qc


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant")
    with mx.cpu():
        return {"conv": ((4, 3, 8, 8),) + qc.exported(
            qc.conv_net, (4, 3, 8, 8), d / "conv")}


@pytest.mark.parametrize("mode,exclude", [("none", False), ("naive", False),
                                          ("entropy", False), ("naive", True)])
def test_quantize_model_matches_jax(nets, mode, exclude, monkeypatch):
    qc.check(nets, "conv", mode, exclude, monkeypatch)
