"""``chip_smoke.py``'s node-by-node check of the int8 net
(``_quant_teacher_forced``), run here with both sides on the CPU: it
reproduces the executor's output, finds nothing on an unchanged net, and
fails a net whose device side is one int8 step, one int32 unit or a
BatchNorm scaled by 1 + 1e-4 off. The device side of each node is the
second of the node's two calls of its op.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.contrib import quantization
from mxnet_tpu_torch.ops.registry import OP_REGISTRY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_teacher", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    with mx.cpu():
        mx.random.seed(0)
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Conv2D(8, 3, padding=1, activation="relu"),
                mx.gluon.nn.Conv2D(8, 3, strides=2, use_bias=False),
                mx.gluon.nn.BatchNorm(),
                mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dense(5))
        net.initialize(mx.initializer.Xavier(magnitude=2.0))
        net.hybridize()
        rs = np.random.RandomState(0)
        x = rs.randn(2, 3, 8, 8).astype(np.float32)
        net(mx.nd.array(x))
        prefix = str(tmp_path_factory.mktemp("teacher") / "net")
        net.export(prefix)
        sym = mx.sym.load(prefix + "-symbol.json")
        params = mx.nd.load(prefix + "-0000.params", ctx=mx.cpu())
        arg = {k[4:]: v for k, v in params.items() if k.startswith("arg:")}
        aux = {k[4:]: v for k, v in params.items() if k.startswith("aux:")}
        calib = rs.randn(4, 3, 8, 8).astype(np.float32)
        qsym, qarg, qaux = quantization.quantize_model(
            sym, arg, aux, ctx=mx.cpu(), calib_mode="naive",
            calib_data=mx.io.NDArrayIter(calib, np.zeros(4, np.float32),
                                         batch_size=2),
            num_calib_examples=4)
    return qsym, qarg, qaux, x


def test_unchanged_net_matches_the_executor(quantized):
    qsym, qarg, qaux, x = quantized
    forced, logits = _chip_smoke()._quant_teacher_forced(
        qsym, qarg, qaux, x, torch.device("cpu"))
    ex = qsym.simple_bind(mx.cpu(), data=x.shape, grad_req="null")
    ex.copy_params_from(qarg, qaux, allow_extra_params=True)
    ex.copy_params_from({"data": mx.nd.array(x)})
    want = ex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_array_equal(logits, want)
    assert forced["failed"] == []
    # 3 int8 layers: 3 int32 sums and 6 int8 tensors (quantize, requantize)
    assert (forced["int32"], forced["int8"]) == (3, 6)
    assert forced["float"] > 0


def _skew(out, how):
    outs = list(out)
    t = outs[0].clone()
    flat = t.view(-1)
    if how == "int8":
        flat[0] = flat[0] + (1 if flat[0] < 127 else -1)
    elif how == "int32":
        flat[0] += 1
    else:
        t = t * (1 + 1e-4)
    outs[0] = t
    return tuple(outs)


@pytest.mark.parametrize("op,kind", [("_contrib_requantize", "int8"),
                                     ("_contrib_quantized_conv", "int32"),
                                     ("BatchNorm", "float")])
def test_a_skewed_device_side_fails(quantized, monkeypatch, op, kind):
    qsym, qarg, qaux, x = quantized
    opdef = OP_REGISTRY[op]
    real, calls = opdef.fcompute, []

    def skewed(attrs, *ins):
        out = real(attrs, *ins)
        calls.append(op)
        # the second call of the op's first node is its device side
        return _skew(out, kind) if len(calls) == 2 else out

    monkeypatch.setattr(opdef, "fcompute", skewed)
    forced, _ = _chip_smoke()._quant_teacher_forced(
        qsym, qarg, qaux, x, torch.device("cpu"))
    assert [f[1] for f in forced["failed"]] == [kind]
