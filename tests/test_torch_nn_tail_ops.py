"""The ``nn`` ops of slice 18 against the JAX package's (CPU): the
softmax family's tail and normalisation.

Their cases of ``torch_tail_cases``' nn_tail group run through both
packages (``torch_op_sweep``: forward and the gradient of every float
input, ``rtol=atol=2e-5`` in float32): ``softmin``,
``SoftmaxActivation``, ``softmax_cross_entropy``, ``L2Normalization``,
``LRN``, and the legacy BatchNorm aliases, each under its own name. The
output ops, ``UpSampling`` and the convolution and pooling aliases are
in ``test_torch_output_ops.py``, the CTC cases in
``test_torch_ctc_ops.py``, the layouts and ``lp`` pooling in
``test_torch_channels_last_ops.py``.
"""
import pytest

from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_sweep import check
from torch_tail_cases import ALIASES, TAIL_CASES, canonical, group

_OWN = ("softmin", "SoftmaxActivation", "softmax_cross_entropy",
        "L2Normalization", "LRN", "BatchNorm")
_CASES = [k for k in group("nn_tail") if k.startswith(_OWN)]


@pytest.mark.parametrize("case", _CASES)
def test_nn_tail_op_matches_jax(case):
    check(*TAIL_CASES[case], "float32")


@pytest.mark.parametrize("name", [n for n in ALIASES["nn_tail"]
                                  if "BatchNorm" in n])
def test_nn_alias_runs_its_op(name):
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    assert OP_REGISTRY[name] is OP_REGISTRY[op]
    assert JAX_REGISTRY[name] is JAX_REGISTRY[op]
    check(name, specs, attrs, flags, "float32")
