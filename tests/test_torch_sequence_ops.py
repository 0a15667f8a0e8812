"""The ``Sequence*`` ops (with and without lengths, both time axes) and
``_rnn_param_concat`` against the JAX package's (CPU): forward and every
input's gradient through ``torch_op_sweep`` (``rtol=atol=2e-5``).
"""
import pytest

from torch_op_cases import NN_CASES
from torch_op_sweep import check


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_sequence_ops_match_jax(case):
    check(*NN_CASES[case], "float32")
