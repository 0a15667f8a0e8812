"""The op cases of the port's last op families: ``ops/vision.py``, the
rest of ``ops/detection.py`` (``ROIAlign``, ``bipartite_matching``) and
``ops/quantization.py``, at small shapes.

numpy only, in ``torch_op_cases``' format (op, input specs, attrs,
flags): ``tests/test_torch_vision_{ops,sampling,roi,align}.py``,
``test_torch_vision_deform_{conv,psroi}.py``, ``test_torch_proposal.py``
and ``test_torch_quantization.py`` (one file a group) run them through
the JAX package and the port on the CPU (``torch_op_sweep``: forward and
gradients in float32, integers exactly), and ``chip_smoke.py``'s
``vision_card`` through the port on the card against the port on the
CPU. RoIs, affine parameters, hashes, score maps and int8/int32 tensors
are fixed arrays drawn from seeded RandomStates here. Compared forward
only: ``Proposal`` (the JAX op cannot be differentiated: its NMS is a
Pallas call), ``bipartite_matching`` (index outputs) and the
quantization ops (integer outputs, ranges that only pass their inputs
on).
"""
import numpy as np

_GROUP = [None]  # the test file a case belongs to, set section by section


def _c(op, specs, attrs=None, grad=True):
    return (op, specs, attrs or {},
            {"int": False, "grad": grad, "group": _GROUP[0]})


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(a):
    return np.asarray(a, np.float32)


def _rois(seed, n, b, side):
    """(n, 5) RoIs [batch, x1, y1, x2, y2] in image pixels on an image of
    ``side`` x ``side`` (feature stride 2), one partly off the image."""
    rs = _rs(seed)
    x1 = rs.uniform(-2.0, side * 0.6, n)
    y1 = rs.uniform(-2.0, side * 0.6, n)
    x2 = x1 + rs.uniform(1.5, side * 0.7, n)
    y2 = y1 + rs.uniform(1.5, side * 0.7, n)
    bi = np.arange(n) % b
    return _f32(np.stack([bi, x1, y1, x2, y2], axis=1))


def _softmax_pairs(seed, b, a, h, w):
    """(B, 2A, H, W) RPN scores: a softmax over each anchor's
    (background, foreground) pair, as the RPN's cls_prob."""
    logits = _rs(seed).randn(b, 2, a, h, w)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    return _f32(p.reshape(b, 2 * a, h, w))


def _i8(seed, *shape):
    return _rs(seed).randint(-127, 128, shape).astype(np.int8)


def _range(lo, hi):
    return _f32([lo]), _f32([hi])


VISION_CASES = {}

# -- sampling, resizing and correlation ---------------------------------------
_GROUP[0] = "sampling"
_LOC = _f32(np.array([1, 0, 0, 0, 1, 0], np.float32)
            + 0.3 * _rs(1).randn(2, 6))
VISION_CASES.update({
    "GridGenerator_affine": _c("GridGenerator", [("any", (2, 6))],
                               {"transform_type": "affine",
                                "target_shape": (4, 5)}),
    "GridGenerator_warp": _c("GridGenerator", [("any", (2, 2, 4, 5))],
                             {"transform_type": "warp"}),
    "BilinearSampler": _c("BilinearSampler", [("any", (2, 3, 5, 6)),
                                              ("any", (2, 2, 4, 4))]),
    "SpatialTransformer": _c("SpatialTransformer", [("any", (2, 3, 5, 6)),
                                                    _LOC],
                             {"target_shape": (4, 3),
                              "transform_type": "affine",
                              "sampler_type": "bilinear"}),
    "Correlation": _c("Correlation", [("any", (1, 3, 7, 7)),
                                      ("any", (1, 3, 7, 7))],
                      {"kernel_size": 3, "max_displacement": 1,
                       "pad_size": 2}),
    "Correlation_absdiff_strided": _c(
        "Correlation", [("any", (2, 2, 8, 6)), ("any", (2, 2, 8, 6))],
        {"kernel_size": 1, "max_displacement": 2, "stride1": 2,
         "stride2": 2, "pad_size": 1, "is_multiply": False}),
    "BilinearResize2D_up": _c("_contrib_BilinearResize2D",
                              [("any", (2, 3, 4, 5))],
                              {"height": 7, "width": 9}),
    "BilinearResize2D_down": _c("_contrib_BilinearResize2D",
                                [("any", (1, 2, 6, 7))],
                                {"height": 3, "width": 2}),
})

# -- crop, adaptive pooling, fft, count sketch, the KL regulariser ------------
_GROUP[0] = "vision"
_HASH = _f32(_rs(2).randint(0, 4, (1, 6)))
_SIGN = _f32(_rs(3).choice([-1.0, 1.0], (1, 6)))
VISION_CASES.update({
    "Crop": _c("Crop", [("any", (2, 3, 6, 7))],
               {"num_args": 1, "h_w": (3, 4), "offset": (1, 2)}),
    "Crop_like_centred": _c("Crop", [("any", (2, 3, 6, 7)),
                                     ("any", (2, 3, 4, 4))],
                            {"num_args": 2, "center_crop": True}),
    "AdaptiveAvgPooling2D": _c("_contrib_AdaptiveAvgPooling2D",
                               [("any", (2, 3, 7, 5))],
                               {"output_size": (3, 2)}),
    "AdaptiveAvgPooling2D_one_size": _c("_contrib_AdaptiveAvgPooling2D",
                                        [("any", (1, 2, 5, 9))],
                                        {"output_size": (4,)}),
    "AdaptiveAvgPooling2D_global": _c("_contrib_AdaptiveAvgPooling2D",
                                      [("any", (2, 2, 3, 4))]),
    "fft": _c("_contrib_fft", [("any", (2, 8))]),
    "ifft": _c("_contrib_ifft", [("any", (3, 2, 12))]),
    "count_sketch": _c("_contrib_count_sketch",
                       [("any", (3, 6)), _HASH, _SIGN], {"out_dim": 4}),
    "IdentityAttachKLSparseReg": _c("IdentityAttachKLSparseReg",
                                    [("any", (3, 4))],
                                    {"sparseness_target": 0.2,
                                     "penalty": 0.01}),
})

# -- Proposal (the NMS kernel's second caller) --------------------------------
_GROUP[0] = "proposal"
VISION_CASES.update({
    "Proposal": _c("Proposal", [_softmax_pairs(4, 1, 6, 4, 4),
                                _f32(0.1 * _rs(5).randn(1, 24, 4, 4)),
                                _f32([[16.0, 16.0, 1.0]])],
                   {"scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0),
                    "feature_stride": 4, "rpn_pre_nms_top_n": 50,
                    "rpn_post_nms_top_n": 10, "threshold": 0.7,
                    "rpn_min_size": 2}, grad=False),
    "MultiProposal_scores": _c(
        "MultiProposal", [_softmax_pairs(6, 2, 3, 5, 4),
                          _f32(0.2 * _rs(7).randn(2, 12, 5, 4)),
                          _f32([[20.0, 16.0, 1.0], [18.0, 14.0, 2.0]])],
        {"scales": (3.0,), "ratios": (0.5, 1.0, 2.0), "feature_stride": 4,
         "rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 12,
         "threshold": 0.6, "rpn_min_size": 3, "output_score": True},
        grad=False),
})

# -- the RoI family -----------------------------------------------------------
_GROUP[0] = "roi"
VISION_CASES.update({
    "ROIPooling": _c("ROIPooling", [("any", (2, 3, 8, 9)),
                                    _rois(10, 5, 2, 18)],
                     {"pooled_size": (3, 2), "spatial_scale": 0.5}),
    "ROIPooling_large_bins": _c("ROIPooling", [("any", (1, 2, 6, 6)),
                                               _rois(11, 3, 1, 6)],
                                {"pooled_size": (4, 4),
                                 "spatial_scale": 1.0}),
    "PSROIPooling": _c("_contrib_PSROIPooling",
                       [("any", (2, 18, 8, 9)), _rois(15, 4, 2, 18)],
                       {"spatial_scale": 0.5, "output_dim": 2,
                        "pooled_size": 3}),
    "PSROIPooling_group_2": _c("_contrib_PSROIPooling",
                               [("any", (1, 12, 7, 7)), _rois(16, 3, 1, 14)],
                               {"spatial_scale": 0.5, "output_dim": 3,
                                "pooled_size": 3, "group_size": 2}),
})

# -- ROIAlign -----------------------------------------------------------------
_GROUP[0] = "align"
VISION_CASES.update({
    "ROIAlign": _c("_contrib_ROIAlign", [("any", (2, 3, 8, 9)),
                                         _rois(12, 5, 2, 18)],
                   {"pooled_size": (3, 2), "spatial_scale": 0.5,
                    "sample_ratio": 2}),
    "ROIAlign_default_ratio": _c("_contrib_ROIAlign",
                                 [("any", (1, 2, 7, 7)),
                                  _rois(13, 3, 1, 14)],
                                 {"pooled_size": (2, 3),
                                  "spatial_scale": 0.5}),
    "ROIAlign_ratio_3": _c("_contrib_ROIAlign", [("any", (2, 2, 6, 8)),
                                                 _rois(14, 4, 2, 12)],
                           {"pooled_size": (2, 2), "spatial_scale": 0.5,
                            "sample_ratio": 3}),
})

# -- the deformable ops -------------------------------------------------------
_GROUP[0] = "deform_psroi"
VISION_CASES.update({
    "DeformablePSROIPooling": _c(
        "_contrib_DeformablePSROIPooling",
        [("any", (2, 8, 8, 9)), _rois(17, 3, 2, 18),
         ("any", (3, 2, 2, 2))],
        {"spatial_scale": 0.5, "output_dim": 2, "group_size": 2,
         "pooled_size": 2, "sample_per_part": 2, "trans_std": 0.1}),
    "DeformablePSROIPooling_class_aware": _c(
        "_contrib_DeformablePSROIPooling",
        [("any", (1, 16, 7, 8)), _rois(18, 3, 1, 16),
         ("any", (3, 4, 1, 1))],
        {"spatial_scale": 0.5, "output_dim": 4, "group_size": 2,
         "pooled_size": 2, "part_size": 1, "sample_per_part": 1,
         "trans_std": 0.2}),
    "DeformablePSROIPooling_no_trans": _c(
        "_contrib_DeformablePSROIPooling",
        [("any", (1, 18, 6, 7)), _rois(19, 2, 1, 12)],
        {"spatial_scale": 0.5, "output_dim": 2, "group_size": 3,
         "pooled_size": 3, "no_trans": True}),
})
_GROUP[0] = "deform_conv"
VISION_CASES.update({
    "DeformableConvolution": _c(
        "_contrib_DeformableConvolution",
        [("any", (2, 4, 6, 6)), ("any", (2, 18, 6, 6)),
         ("any", (6, 2, 3, 3)), ("any", (6,))],
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6, "num_group": 2}),
    "DeformableConvolution_strided_dilated": _c(
        "_contrib_DeformableConvolution",
        [("any", (1, 4, 9, 8)), ("any", (1, 16, 5, 4)),
         ("any", (3, 4, 2, 2))],
        {"kernel": (2, 2), "stride": (2, 2), "dilate": (2, 2),
         "pad": (1, 1), "num_filter": 3, "num_deformable_group": 2,
         "no_bias": True}),
})

# -- detection: bipartite matching --------------------------------------------
_GROUP[0] = "detection"
VISION_CASES.update({
    "bipartite_matching": _c("_contrib_bipartite_matching",
                             [("any", (2, 3, 4))], {"threshold": 0.1},
                             grad=False),
    "bipartite_matching_ascend_topk": _c(
        "_contrib_bipartite_matching", [("any", (5, 3))],
        {"threshold": 0.5, "is_ascend": True, "topk": 2}, grad=False),
})

# -- quantization -------------------------------------------------------------
_GROUP[0] = "quantization"
_ACC = _rs(30).randint(-2 ** 30, 2 ** 30, (3, 5)).astype(np.int32)
VISION_CASES.update({
    "quantize_int8": _c("_contrib_quantize",
                        [("any", (3, 4))] + list(_range(-2.0, 3.0)),
                        {"out_type": "int8"}, grad=False),
    "quantize_uint8": _c("_contrib_quantize",
                         [("any", (3, 4))] + list(_range(-1.5, 2.5)),
                         grad=False),
    "dequantize_int8": _c("_contrib_dequantize",
                          [_i8(31, 3, 4)] + list(_range(-2.0, 3.0)),
                          grad=False),
    "dequantize_uint8": _c("_contrib_dequantize",
                           [_rs(32).randint(0, 256, (3, 4)).astype(np.uint8)]
                           + list(_range(-1.5, 2.5)), grad=False),
    "dequantize_int32": _c("_contrib_dequantize",
                           [_ACC] + list(_range(-40.0, 40.0)), grad=False),
    "requantize": _c("_contrib_requantize",
                     [_ACC] + list(_range(-40.0, 40.0)), grad=False),
    "requantize_calibrated": _c("_contrib_requantize",
                                [_ACC] + list(_range(-40.0, 40.0)),
                                {"min_calib_range": -9.5,
                                 "max_calib_range": 7.25}, grad=False),
    "quantized_fully_connected": _c(
        "_contrib_quantized_fully_connected",
        [_i8(33, 4, 6), _i8(34, 5, 6), _i8(35, 5)]
        + list(_range(-1.0, 1.2)) + list(_range(-0.4, 0.3))
        + list(_range(-0.1, 0.2)), {"num_hidden": 5}, grad=False),
    "quantized_fully_connected_no_bias_flatten": _c(
        "_contrib_quantized_fully_connected",
        [_i8(36, 4, 2, 3), _i8(37, 3, 6)]
        + list(_range(-2.0, 1.0)) + list(_range(-0.5, 0.5)),
        {"num_hidden": 3, "no_bias": True}, grad=False),
    "quantized_conv": _c(
        "_contrib_quantized_conv",
        [_i8(38, 2, 4, 6, 6), _i8(39, 6, 2, 3, 3), _i8(40, 6)]
        + list(_range(-1.0, 1.0)) + list(_range(-0.3, 0.2))
        + list(_range(-0.05, 0.05)),
        {"kernel": (3, 3), "pad": (1, 1), "stride": (2, 2),
         "num_filter": 6, "num_group": 2}, grad=False),
    "quantized_conv_no_bias_dilated": _c(
        "_contrib_quantized_conv",
        [_i8(41, 1, 3, 9, 8), _i8(42, 4, 3, 3, 3)]
        + list(_range(-3.0, 2.0)) + list(_range(-0.2, 0.3)),
        {"kernel": (3, 3), "dilate": (2, 2), "num_filter": 4,
         "no_bias": True}, grad=False),
    # uint8 data (quantize's default out_type) wraps into int8 as in JAX
    "quantized_conv_uint8_data": _c(
        "_contrib_quantized_conv",
        [_rs(46).randint(0, 256, (1, 2, 5, 5)).astype(np.uint8),
         _i8(47, 3, 2, 3, 3)]
        + list(_range(-1.0, 1.0)) + list(_range(-0.2, 0.3)),
        {"kernel": (3, 3), "num_filter": 3, "no_bias": True}, grad=False),
    "quantized_fully_connected_uint8_data": _c(
        "_contrib_quantized_fully_connected",
        [_rs(48).randint(0, 256, (3, 8)).astype(np.uint8), _i8(49, 4, 8)]
        + list(_range(-1.0, 1.0)) + list(_range(-0.4, 0.3)),
        {"num_hidden": 4, "no_bias": True}, grad=False),
    "quantized_pooling_max": _c(
        "_contrib_quantized_pooling",
        [_i8(43, 2, 3, 6, 6)] + list(_range(-1.0, 1.0)),
        {"kernel": (2, 2), "stride": (2, 2)}, grad=False),
    "quantized_pooling_avg": _c(
        "_contrib_quantized_pooling",
        [_i8(44, 1, 2, 7, 7)] + list(_range(-2.0, 2.0)),
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
         "pool_type": "avg"}, grad=False),
    "quantized_flatten": _c("_contrib_quantized_flatten",
                            [_i8(45, 2, 3, 4)] + list(_range(-1.0, 1.0)),
                            grad=False),
})

# the names no case above runs under their own name: each runs its op's
# first case under that name
ALIASES = {
    "vision": ["count_sketch", "fft", "ifft"],
    "proposal": ["_contrib_Proposal", "_contrib_MultiProposal"],
    "roi": ["PSROIPooling"],
    "align": ["ROIAlign"],
    "sampling": [],
    "deform_psroi": ["DeformablePSROIPooling"],
    "deform_conv": ["DeformableConvolution"],
    "detection": [],
    "quantization": [],
}


def group(name):
    return sorted(k for k, v in VISION_CASES.items()
                  if v[3]["group"] == name)


def canonical(name, registry):
    """The first case whose op is ``name``'s OpDef in ``registry``."""
    target = registry[name]
    for key in sorted(VISION_CASES):
        if registry[VISION_CASES[key][0]] is target:
            return VISION_CASES[key]
    raise AssertionError("no case runs the op behind %r" % name)
