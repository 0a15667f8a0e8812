"""The port's sampling ops (``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``_contrib_BilinearResize2D``) and
``Correlation`` against the JAX package's (CPU): every case of
``torch_vision_cases``' sampling group through both packages
(``torch_op_sweep``: forward and the gradients of the maps, grids and
affine parameters, ``rtol=atol=2e-5``; samples outside the map are 0).
"""
import pytest

from torch_op_sweep import check
from torch_vision_cases import VISION_CASES, group


@pytest.mark.parametrize("case", group("sampling"))
def test_sampling_op_matches_jax(case):
    check(*VISION_CASES[case], "float32")
