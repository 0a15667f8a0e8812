"""The port's RoI pooling ops (``ROIPooling``, ``PSROIPooling``) against
the JAX package's (CPU): every case of ``torch_vision_cases``' roi group
through both packages (``torch_op_sweep``: forward and the gradients,
``rtol=atol=2e-5``), each alias under its own name, and ``ROIPooling``
over more RoIs than one of the port's chunks holds.
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


@pytest.mark.parametrize("case", group("roi"))
def test_roi_op_matches_jax(case):
    check(*VISION_CASES[case], "float32")


@pytest.mark.parametrize("name", ALIASES["roi"])
def test_roi_alias_runs_its_op(name):
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    assert OP_REGISTRY[name] is OP_REGISTRY[op]
    assert JAX_REGISTRY[name] is JAX_REGISTRY[op]
    check(name, specs, attrs, flags, "float32")


@pytest.mark.parametrize("op", ["ROIPooling", "_contrib_PSROIPooling"])
def test_more_rois_than_a_chunk(op):
    n = _common.ROI_CHUNK + 5
    data = np.random.RandomState(3).randn(2, 8, 6, 7).astype(np.float32)
    rois = _rois(20, n, 2, 12)
    attrs = {"spatial_scale": 0.5}
    attrs.update({"pooled_size": (2, 2)} if op == "ROIPooling" else
                 {"pooled_size": 2, "output_dim": 2})
    want = jmx.nd.invoke(op, jmx.nd.array(data), jmx.nd.array(rois),
                         **attrs).asnumpy()
    with mx.cpu():
        got = mx.nd.invoke(op, mx.nd.array(data), mx.nd.array(rois),
                           **attrs).asnumpy()
    same(got, want)
