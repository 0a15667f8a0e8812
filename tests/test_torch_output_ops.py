"""The output ops of slice 18, ``UpSampling`` and the convolution and
pooling aliases against the JAX package's (CPU).

Their cases of ``torch_tail_cases``' nn_tail group run through both
packages (``torch_op_sweep``: forward and the gradient of every float
input, ``rtol=atol=2e-5`` in float32): ``LinearRegressionOutput``,
``LogisticRegressionOutput``, ``MAERegressionOutput`` and ``SVMOutput``
(L1 and L2), whose backward ignores the head gradient and scales as the
JAX ``custom_vjp`` (the sweep's random head shows it), ``UpSampling``
(nearest, bilinear, two inputs concatenated or summed),
``Convolution_v1`` and ``Pooling_v1``.
"""
import pytest

from torch_op_sweep import check
from torch_tail_cases import TAIL_CASES, group

_OWN = ("LinearRegressionOutput", "LogisticRegressionOutput",
        "MAERegressionOutput", "SVMOutput", "UpSampling",
        "Convolution_v1", "Pooling_v1")


@pytest.mark.parametrize("case", [k for k in group("nn_tail")
                                  if k.startswith(_OWN)])
def test_output_op_matches_jax(case):
    check(*TAIL_CASES[case], "float32")
