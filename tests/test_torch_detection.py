"""The port's detection ops against the JAX package (CPU): ``box_iou``,
``MultiBoxPrior`` and ``MultiBoxTarget``, through each package's
``nd.contrib`` on the same numpy inputs.

Tolerances, fp32 on the CPU: IoU and anchors 1e-6 (elementwise
arithmetic in the same order); ``MultiBoxTarget``'s class targets
exactly (matching, thresholds and the hard-negative ranking are
decisions), its location targets and mask within 1e-5 (the encoding's
log and divisions may round differently in the last bit).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _both(op, arrays, **kw):
    """``op`` run by each package on the same numpy inputs."""
    want = getattr(jmx.nd.contrib, op)(*[jmx.nd.array(a) for a in arrays],
                                       **kw)
    with mx.cpu():
        got = getattr(mx.nd.contrib, op)(*[mx.nd.array(a) for a in arrays],
                                         **kw)
    if not isinstance(want, (list, tuple)):
        want, got = [want], [got]
    return [g.asnumpy() for g in got], [w.asnumpy() for w in want]


def _corner(rs, *lead):
    xy = rs.rand(*lead, 2)
    return np.concatenate([xy, xy + rs.rand(*lead, 2) * 0.5],
                          -1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rs = np.random.RandomState(0)
    lhs, rhs = _corner(rs, 2, 30), _corner(rs, 2, 17)
    (got,), (want,) = _both("box_iou", [lhs, rhs], format=fmt)
    assert got.shape == (2, 30, 17)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.25, 0.35), ratios=(1.0, 2.0), clip=True),  # SSD scale 1
    dict(sizes=(0.45, 0.6), ratios=(1.0, 2.0, 0.5)),
    dict(sizes=(0.3,), ratios=(1.0,), steps=(0.1, 0.2), offsets=(0.2, 0.7)),
])
def test_multibox_prior_matches_jax(kw):
    feat = np.zeros((2, 8, 6, 9), np.float32)
    (got,), (want,) = _both("MultiBoxPrior", [feat], **kw)
    n_anchor = len(kw["sizes"]) + len(kw["ratios"]) - 1
    assert got.shape == (1, 6 * 9 * n_anchor, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _target_inputs(rs, b, side, m):
    """Anchors of the SSD example at feature side ``side``, ``b`` images
    of up to ``m`` objects (a -1 row pads the rest), class logits."""
    feat = np.zeros((1, 1, side, side), np.float32)
    with mx.cpu():
        anchors = mx.nd.contrib.MultiBoxPrior(
            mx.nd.array(feat), sizes=(0.25, 0.35), ratios=(1.0, 2.0),
            clip=True).asnumpy()
    n = anchors.shape[1]
    label = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(rs.randint(1, m + 1)):
            x0, y0 = rs.rand(2) * 0.6
            w, h = 0.1 + rs.rand(2) * 0.3
            label[i, j] = [rs.randint(0, 3), x0, y0, x0 + w, y0 + h]
    cls_pred = rs.randn(b, 4, n).astype(np.float32)
    return anchors, label, cls_pred


@pytest.mark.parametrize("kw", [
    dict(overlap_threshold=0.5, ignore_label=-1, negative_mining_ratio=3),
    dict(overlap_threshold=0.3),
    dict(overlap_threshold=0.5, negative_mining_ratio=2,
         minimum_negative_samples=40, negative_mining_thresh=0.4),
])
def test_multibox_target_matches_jax(kw):
    inputs = _target_inputs(np.random.RandomState(3), 3, 8, 3)
    (loc_t, loc_m, cls_t), (j_loc_t, j_loc_m, j_cls_t) = _both(
        "MultiBoxTarget", inputs, **kw)
    n = inputs[0].shape[1]
    assert loc_t.shape == (3, n * 4) and cls_t.shape == (3, n)
    np.testing.assert_array_equal(cls_t, j_cls_t)
    np.testing.assert_allclose(loc_m, j_loc_m, rtol=0, atol=1e-5)
    np.testing.assert_allclose(loc_t, j_loc_t, rtol=0, atol=1e-5)
    assert (cls_t > 0).any()  # some anchors matched an object


def test_multibox_target_has_a_shape_rule_and_no_gradient():
    anchors, label, cls_pred = (torch.from_numpy(a) for a in
                                _target_inputs(np.random.RandomState(5), 2,
                                               4, 2))
    from mxnet_tpu_torch.ops.registry import get_op

    op = get_op("_contrib_MultiBoxTarget")
    attrs = op.parse_attrs({"negative_mining_ratio": 3})
    metas = op.fcompute(attrs, anchors.to("meta"), label.to("meta"),
                        cls_pred.to("meta"))
    real = op.fcompute(attrs, anchors, label,
                       cls_pred.clone().requires_grad_(True))
    assert [tuple(t.shape) for t in metas] == [tuple(t.shape) for t in real]
    assert all(m.device.type == "meta" for m in metas)
    assert not any(t.requires_grad for t in real)
