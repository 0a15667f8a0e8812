"""``contrib.quantization.quantize_model`` on the zoo's ``resnet18_v1`` at
32 x 32 against the JAX package's (CPU), under ``calib_mode`` none,
naive and entropy: the checks of ``torch_quant_compare``.
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
        return {"resnet18_v1": ((2, 3, 32, 32),) + qc.exported(
            qc.resnet, (2, 3, 32, 32), d / "resnet18_v1")}


@pytest.mark.parametrize("mode,exclude", [("none", False), ("naive", False),
                                          ("entropy", False)])
def test_quantize_model_matches_jax(nets, mode, exclude, monkeypatch):
    qc.check(nets, "resnet18_v1", mode, exclude, monkeypatch)
