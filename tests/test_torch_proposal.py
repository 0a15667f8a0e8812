"""The port's ``Proposal`` (and its aliases ``MultiProposal``,
``_contrib_Proposal``, ``_contrib_MultiProposal``) against the JAX
package's on the CPU, where the JAX op runs its NMS through the Pallas
kernel in interpret mode and the port through ``nms_keep_reference``.

The scores and the RoIs' image indices must be equal, which holds only
where the two ops kept the same anchors in the same order; the RoIs'
corners agree within the parity tolerance (2e-5: XLA may fuse the
decode's multiply-adds, so a corner can land one float32 step away).
The sweep cases of ``torch_vision_cases``' proposal group (with
``output_score`` off and on, one image and two), two images again
without scores, a map whose ``rpn_min_size`` filter removes boxes, a map
of tied scores (the stable sorts keep the anchors' order), a map where
fewer than ``rpn_post_nms_top_n`` boxes survive (the rest is the top box
again), ``ROIPooling``/``ROIAlign`` over Proposal's RoIs as
``chip_smoke.py``'s ``rcnn_proposal`` chains them, one NMS call an
image, and symbolic shape inference.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops import vision
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_sweep import check, same
from torch_vision_cases import (ALIASES, VISION_CASES, _softmax_pairs,
                                canonical, group)

# a small RPN: 6 anchors a location (scales 2, 4; ratios 0.5, 1, 2) on a
# 6 x 5 map at stride 4, image 24 x 20
_ATTRS = {"scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0),
          "feature_stride": 4, "rpn_pre_nms_top_n": 120,
          "rpn_post_nms_top_n": 20, "threshold": 0.7, "rpn_min_size": 2}


def _inputs(b=1, seed=0, scale=0.2, info=(24.0, 20.0, 1.0)):
    cls = _softmax_pairs(seed, b, 6, 6, 5)
    bbox = (scale * np.random.RandomState(seed + 1).randn(b, 24, 6, 5)) \
        .astype(np.float32)
    im_info = np.tile(np.asarray(info, np.float32), (b, 1))
    return [cls, bbox, im_info]


def _both(op, inputs, **attrs):
    """``op`` in both packages: (port outputs, JAX outputs) as numpy."""
    want = jmx.nd.invoke(op, *[jmx.nd.array(a) for a in inputs], **attrs)
    with mx.cpu():
        got = mx.nd.invoke(op, *[mx.nd.array(a) for a in inputs], **attrs)
    as_list = (lambda o: [x.asnumpy() for x in o]
               if isinstance(o, (list, tuple)) else [o.asnumpy()])
    return as_list(got), as_list(want)


def _equal(op, inputs, **attrs):
    """The port's outputs, held to JAX's: scores and image indices
    exactly, corners within the parity tolerance."""
    got, want = _both(op, inputs, **attrs)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    same(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("case", group("proposal"))
def test_proposal_matches_jax(case):
    check(*VISION_CASES[case], "float32")


@pytest.mark.parametrize("name", ALIASES["proposal"])
def test_proposal_alias_runs_its_op(name):
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    assert OP_REGISTRY[name] is OP_REGISTRY[op]
    assert JAX_REGISTRY[name] is JAX_REGISTRY[op]
    check(name, specs, attrs, flags, "float32")


def test_two_images_equal_jax():
    (rois,) = _equal("MultiProposal", _inputs(b=2, seed=3), **_ATTRS)
    assert rois.shape == (2 * 20, 5)
    np.testing.assert_array_equal(rois[:, 0], np.repeat([0.0, 1.0], 20))


def test_min_size_filter_removes_boxes():
    inputs = _inputs(seed=5, scale=0.5)
    attrs = dict(_ATTRS, rpn_min_size=6)
    rois, scores = _equal("Proposal", inputs, output_score=True, **attrs)
    # every box returned is at least the minimum size, and the filter
    # had boxes to remove: some anchors' decoded boxes are smaller
    w = rois[:, 3] - rois[:, 1] + 1
    h = rois[:, 4] - rois[:, 2] + 1
    assert (w >= 6).all() and (h >= 6).all()
    assert np.isfinite(scores).all()
    _, loose = _both("Proposal", inputs, output_score=True,
                     **dict(attrs, rpn_min_size=1))
    assert not np.array_equal(loose[0], rois)


def test_tied_scores_keep_the_anchor_order():
    inputs = _inputs(seed=7)
    inputs[0][:] = 0.5  # every anchor's foreground score ties
    rois, scores = _equal("Proposal", inputs, output_score=True, **_ATTRS)
    assert (scores == 0.5).all()


def test_fewer_survivors_than_post_pad_with_the_top_box():
    inputs = _inputs(seed=9, scale=0.05)
    attrs = dict(_ATTRS, threshold=0.05, rpn_post_nms_top_n=30)
    rois, scores = _equal("Proposal", inputs, output_score=True, **attrs)
    distinct = np.unique(rois[:, 1:], axis=0).shape[0]
    assert distinct < 30
    np.testing.assert_array_equal(rois[-1], rois[0])
    assert scores[-1, 0] == scores[0, 0]


@pytest.mark.parametrize("op,attrs", [
    ("ROIPooling", {"pooled_size": (3, 3), "spatial_scale": 0.25}),
    ("_contrib_ROIAlign", {"pooled_size": (3, 3), "spatial_scale": 0.25,
                           "sample_ratio": 2})])
def test_roi_ops_over_proposal_rois(op, attrs):
    inputs = _inputs(b=2, seed=11)
    (rois,) = _equal("MultiProposal", inputs, **_ATTRS)
    feat = np.random.RandomState(12).randn(2, 4, 6, 5).astype(np.float32)
    got, want = _both(op, [feat, rois], **attrs)
    same(got[0], want[0])


def test_one_nms_call_an_image(monkeypatch):
    calls, real = [], vision.nms_keep

    def counting(boxes, *args):
        calls.append(tuple(boxes.shape))
        return real(boxes, *args)

    monkeypatch.setattr(vision, "nms_keep", counting)
    with mx.cpu():
        mx.nd.invoke("MultiProposal",
                     *[mx.nd.array(a) for a in _inputs(b=2)], **_ATTRS)
    assert calls == [(1, 120, 4), (1, 120, 4)]


def test_symbolic_shapes_equal_jax():
    shapes = {"cls_prob": (2, 12, 6, 5), "bbox_pred": (2, 24, 6, 5),
              "im_info": (2, 3)}
    outs = []
    for pkg in (mx, jmx):
        sym = pkg.sym.contrib.MultiProposal(
            pkg.sym.var("cls_prob"), pkg.sym.var("bbox_pred"),
            pkg.sym.var("im_info"), output_score=True, **_ATTRS)
        outs.append(sym.infer_shape(**shapes)[1])
    assert outs[0] == outs[1] == [(40, 5), (40, 1)]
