"""mxnet_tpu_torch.ops.nms and the ops that call it, against the JAX
package (CPU).

* ``nms_keep_reference`` against ``mxnet_tpu.ops.pallas_kernels.nms_keep``
  (the Pallas ``_nms_kernel`` in interpret mode on the CPU, as the JAX
  package's own tests run it): keep masks exactly equal, over N in
  {1, 7, 64, 65, 300, 512}, thresholds {0.3, 0.45, 0.7}, with and without
  ``force_suppress``, on box sets with duplicates and invalid boxes, and
  on integer boxes whose IoU lands exactly on the threshold;
* ``box_nms`` and ``MultiBoxDetection`` through each package's
  ``nd.contrib``: which rows survive (and the -1 rows) exactly, the
  coordinates and scores within 1e-6 (the decode's exp and products may
  round differently in the last bit);
* the dispatcher: a CPU tensor goes to the plain version, a ``meta``
  tensor gets an empty mask, and the kernel wrapper refuses a CPU tensor;
* the CUDA kernel against the plain version, exactly, on the card only
  (``test_cuda_kernel_matches_plain_version`` skips elsewhere).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import pallas_kernels as pk
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import nms


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _boxes(rs, n, ncls=3, frac_valid=0.8):
    """Random corner boxes, a fifth of them exact duplicates of another,
    classes in 0..ncls-1, ``frac_valid`` of them valid."""
    xy = rs.rand(n, 2)
    wh = rs.rand(n, 2) * 0.4 + 0.01
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    dup = rs.rand(n) < 0.2
    boxes[dup] = boxes[rs.randint(0, n, int(dup.sum()))]
    cls = rs.randint(0, ncls, n).astype(np.float32)
    valid = rs.rand(n) < frac_valid
    return boxes, cls, valid


def _exact_boxes(rs, n):
    """Integer boxes: 2x2 boxes shifted by whole units overlap with IoU
    1/3 or 1/7 exactly, ties the threshold then has to break alike."""
    xy = rs.randint(0, 6, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + 2.0], 1), np.zeros(n, np.float32), \
        np.ones(n, bool)


def _port(boxes, cls, valid, thresh, force):
    return nms.nms_keep(torch.from_numpy(boxes)[None],
                        torch.from_numpy(cls)[None],
                        torch.from_numpy(valid)[None], thresh, force)[0]


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("thresh", [0.3, 0.45, 0.7])
@pytest.mark.parametrize("n", [1, 7, 64, 65, 300, 512])
def test_plain_version_matches_pallas_kernel(n, thresh, force):
    boxes, cls, valid = _boxes(np.random.RandomState(n), n)
    want = np.asarray(pk.nms_keep(boxes, cls, valid, thresh, force))
    got = _port(boxes, cls, valid, thresh, force)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("thresh", [1.0 / 7.0, 1.0 / 3.0, 0.3])
def test_threshold_exact_boxes_decide_alike(thresh):
    boxes, cls, valid = _exact_boxes(np.random.RandomState(11), 200)
    for force in (False, True):
        want = np.asarray(pk.nms_keep(boxes, cls, valid, thresh, force))
        np.testing.assert_array_equal(
            _port(boxes, cls, valid, thresh, force).numpy(), want)


def test_dispatcher_devices():
    boxes, cls, valid = (torch.from_numpy(a)[None] for a in
                         _boxes(np.random.RandomState(1), 50))
    want = nms.nms_keep_reference(boxes, cls, valid, 0.5, False)
    nms.nms_keep_cuda.launches = 0
    np.testing.assert_array_equal(
        nms.nms_keep(boxes, cls, valid, 0.5, False).numpy(), want.numpy())
    assert nms.nms_keep_cuda.launches == 0  # the CPU launches nothing
    m = nms.nms_keep(boxes.to("meta"), cls.to("meta"), valid.to("meta"),
                     0.5, False)
    assert m.device.type == "meta" and m.shape == (1, 50)
    assert m.dtype == torch.bool
    with pytest.raises(MXNetError, match="CUDA tensors expected"):
        nms.nms_keep_cuda(boxes, cls, valid, 0.5, False)
    with pytest.raises(MXNetError, match="must be"):
        nms.nms_keep(boxes, cls[:, :10], valid, 0.5, False)


def _table(rs, b, n):
    """(B, N, 6) rows [class, score, x1, y1, x2, y2], some scores at or
    below 0 (invalid), some tied."""
    boxes = np.stack([_boxes(rs, n)[0] for _ in range(b)])
    cls = rs.randint(0, 3, (b, n, 1)).astype(np.float32)
    score = rs.rand(b, n, 1).astype(np.float32) - 0.2
    score[:, ::7] = 0.5  # ties: the stable sort keeps them in order
    return np.concatenate([cls, score, boxes], -1)


def _assert_tables(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -1, want == -1)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.5, id_index=0),
    dict(overlap_thresh=0.3, id_index=0, topk=20, force_suppress=True),
    dict(overlap_thresh=0.45, valid_thresh=0.1, out_format="center"),
])
def test_box_nms_matches_jax(kw):
    data = _table(np.random.RandomState(4), 2, 100)
    want = jmx.nd.contrib.box_nms(jmx.nd.array(data), **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.contrib.box_nms(mx.nd.array(data), **kw).asnumpy()
    _assert_tables(got, want)


def test_box_nms_alias_and_center_input():
    data = _table(np.random.RandomState(6), 2, 40)
    data[..., 4:6] = np.abs(data[..., 4:6])  # center format: w, h >= 0
    kw = dict(overlap_thresh=0.4, id_index=0, in_format="center")
    want = jmx.nd.contrib.box_nms(jmx.nd.array(data), **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.contrib.box_non_maximum_suppression(
            mx.nd.array(data), **kw).asnumpy()
    _assert_tables(got, want)


def _detection_inputs(rs, b, n, c):
    logits = rs.randn(b, c + 1, n).astype(np.float32) * 2.0
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(b, n * 4) * 0.5).astype(np.float32)
    xy = rs.rand(n, 2) * 0.8
    anchors = np.concatenate([xy, xy + 0.05 + rs.rand(n, 2) * 0.3], 1)
    return prob.astype(np.float32), loc, \
        anchors.reshape(1, n, 4).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(nms_threshold=0.45, nms_topk=100),
    dict(nms_threshold=0.5, force_suppress=True, threshold=0.2),
])
def test_multibox_detection_matches_jax(kw):
    inputs = _detection_inputs(np.random.RandomState(9), 2, 200, 3)
    want = jmx.nd.contrib.MultiBoxDetection(
        *[jmx.nd.array(a) for a in inputs], **kw).asnumpy()
    with mx.cpu():
        got = mx.nd.contrib.MultiBoxDetection(
            *[mx.nd.array(a) for a in inputs], **kw).asnumpy()
    _assert_tables(got, want)
    assert (got[..., 0] >= 0).any()  # the case keeps some detections


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,force,frac_valid", [
    (8, 3840, False, 100 / 3840), (8, 3840, False, 1.0), (2, 3840, True, 0.9),
    (1, 1, False, 1.0), (3, 77, False, 0.8), (2, 1000, False, 0.8),
    (1, 6000, False, 0.5)])
def test_cuda_kernel_matches_plain_version(cuda_device, b, n, force,
                                           frac_valid):
    rs = np.random.RandomState(n)
    parts = [_boxes(rs, n, frac_valid=frac_valid) for _ in range(b)]
    boxes, cls, valid = (torch.tensor(np.stack(p), device=cuda_device)
                         for p in zip(*parts))
    nms.nms_keep_cuda.launches = 0
    got = nms.nms_keep(boxes, cls, valid, 0.45, force)
    torch.cuda.synchronize()
    assert nms.nms_keep_cuda.launches == 1
    want = nms.nms_keep_reference(boxes, cls, valid, 0.45, force)
    assert torch.equal(got, want)
