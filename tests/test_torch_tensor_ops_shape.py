"""The port's shape ops against the JAX package's (CPU): the
``shape`` cases of ``torch_op_cases`` through ``torch_op_sweep`` (float32
with gradients; int32 where the JAX op takes it)."""
import pytest

from torch_op_cases import group, int_group
from torch_op_sweep import check_case


@pytest.mark.parametrize("case", group("shape"))
def test_op_matches_jax_in_float32(case):
    check_case(case, "float32")


@pytest.mark.parametrize("case", int_group("shape"))
def test_op_matches_jax_in_int32(case):
    check_case(case, "int32")
