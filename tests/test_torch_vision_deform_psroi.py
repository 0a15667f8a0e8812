"""The port's ``DeformablePSROIPooling`` against the JAX package's (CPU):
every case of ``torch_vision_cases``' deform_psroi group through both
packages (``torch_op_sweep``: forward and gradients of every float
input, the ``trans`` included, ``rtol=atol=2e-5``), and the alias under
its own name.
"""
import pytest

from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_sweep import check
from torch_vision_cases import ALIASES, VISION_CASES, canonical, group


@pytest.mark.parametrize("case", group("deform_psroi"))
def test_deformable_op_matches_jax(case):
    check(*VISION_CASES[case], "float32")


@pytest.mark.parametrize("name", ALIASES["deform_psroi"])
def test_deformable_alias_runs_its_op(name):
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    assert OP_REGISTRY[name] is OP_REGISTRY[op]
    assert JAX_REGISTRY[name] is JAX_REGISTRY[op]
    check(name, specs, attrs, flags, "float32")
