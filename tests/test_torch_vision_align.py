"""The port's ``ROIAlign`` against the JAX package's (CPU): every case of
``torch_vision_cases``' align group through both packages
(``torch_op_sweep``: forward and the gradients of the feature map and
the RoIs, ``rtol=atol=2e-5``; ``sample_ratio`` 2, 3 and the default,
which is the JAX package's fixed 2 x 2 grid), the alias under its own
name, and more RoIs than one of the port's chunks holds.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops import _common
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_sweep import check, same
from torch_vision_cases import ALIASES, VISION_CASES, _rois, canonical, group


@pytest.mark.parametrize("case", group("align"))
def test_roi_align_matches_jax(case):
    check(*VISION_CASES[case], "float32")


@pytest.mark.parametrize("name", ALIASES["align"])
def test_roi_align_alias_runs_its_op(name):
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    assert OP_REGISTRY[name] is OP_REGISTRY[op]
    assert JAX_REGISTRY[name] is JAX_REGISTRY[op]
    check(name, specs, attrs, flags, "float32")


def test_more_rois_than_a_chunk():
    n = _common.ROI_CHUNK + 5
    data = np.random.RandomState(3).randn(2, 2, 6, 7).astype(np.float32)
    rois = _rois(21, n, 2, 12)
    attrs = {"pooled_size": (2, 2), "spatial_scale": 0.5}
    want = jmx.nd.invoke("ROIAlign", jmx.nd.array(data), jmx.nd.array(rois),
                         **attrs).asnumpy()
    with mx.cpu():
        got = mx.nd.invoke("ROIAlign", mx.nd.array(data), mx.nd.array(rois),
                           **attrs).asnumpy()
    same(got, want)
