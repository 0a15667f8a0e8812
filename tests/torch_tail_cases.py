"""The op cases of the port's last op families: ``ops/linalg.py``,
``ops/misc_tail.py``, the dense forms of ``ops/sparse.py`` and the ``nn``
ops of slice 18 (the softmax family's tail, normalisation, the output
ops, ``UpSampling``, ``CTCLoss``, ``lp`` pooling, the channels-last
layouts and the legacy aliases), at small shapes.

numpy only, in ``torch_op_cases``' format (op, input specs, attrs,
flags): ``tests/test_torch_{linalg,misc_tail,nn_tail}_ops.py`` run them
through the JAX package and the port on the CPU (``torch_op_sweep``), and
``chip_smoke.py``'s ``ops_tail_card`` through the port on the card
against the port on the CPU. Inputs that need a structure (SPD or
triangular matrices, uint8 images, labels) are fixed arrays drawn from
seeded RandomStates here. ``SIGN_CASES`` are the two linalg ops whose
vectors have no fixed sign (``syevd``, ``gelqf``): they are compared
through sign-invariant forms (``sign_invariant``).
"""
import numpy as np

_GROUP = [None]  # the test file a case belongs to, set section by section


def _c(op, specs, attrs=None, int_ok=False, grad=True):
    return (op, specs, attrs or {},
            {"int": int_ok, "grad": grad, "group": _GROUP[0]})


def _rs(seed):
    return np.random.RandomState(seed)


def _spd(n, b=2, seed=0):
    m = _rs(seed).randn(b, n, n)
    return (m @ m.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _lower(n, b=2, seed=1):
    m = np.tril(_rs(seed).randn(b, n, n) * 0.3)
    idx = np.arange(n)
    m[:, idx, idx] = _rs(seed + 50).uniform(1.0, 2.0, (b, n))
    return m.astype(np.float32)


def _well(n, b=2, seed=2):
    return (_rs(seed).randn(b, n, n) * 0.3 + 2 * np.eye(n)) \
        .astype(np.float32)


def _f32(seed, *shape):
    return _rs(seed).randn(*shape).astype(np.float32)


def _u8(seed, *shape):
    return _rs(seed).randint(0, 256, shape).astype(np.uint8)


TAIL_CASES = {}

# -- linalg -----------------------------------------------------------------
_GROUP[0] = "linalg"
TAIL_CASES.update({
    "gemm": _c("_linalg_gemm", [("any", (2, 3, 4)), ("any", (2, 4, 5)),
                                ("any", (2, 3, 5))],
               {"alpha": 0.5, "beta": 2.0}),
    "gemm_transposed": _c("_linalg_gemm", [("any", (2, 4, 3)),
                                           ("any", (2, 5, 4)),
                                           ("any", (2, 3, 5))],
                          {"transpose_a": True, "transpose_b": True}),
    "gemm2": _c("_linalg_gemm2", [("any", (2, 3, 4)), ("any", (2, 4, 5))],
                {"alpha": 1.5}),
    "gemm2_transpose_a": _c("_linalg_gemm2", [("any", (2, 4, 3)),
                                              ("any", (2, 4, 5))],
                            {"transpose_a": True}),
    "potrf": _c("_linalg_potrf", [_spd(3)]),
    "potri": _c("_linalg_potri", [_lower(3)]),
    "trmm": _c("_linalg_trmm", [_lower(3), _f32(3, 2, 3, 4)],
               {"alpha": 2.0}),
    "trmm_right_transposed": _c("_linalg_trmm", [_lower(3), _f32(4, 2, 4, 3)],
                                {"rightside": True, "transpose": True}),
    "trsm": _c("_linalg_trsm", [_lower(3), _f32(5, 2, 3, 4)],
               {"alpha": 0.5}),
    "trsm_transposed": _c("_linalg_trsm", [_lower(3), _f32(6, 2, 3, 4)],
                          {"transpose": True}),
    "trsm_right": _c("_linalg_trsm", [_lower(3), _f32(7, 2, 4, 3)],
                     {"rightside": True}),
    "trsm_upper_right_transposed": _c(
        "_linalg_trsm", [np.ascontiguousarray(
            _lower(3).transpose(0, 2, 1)), _f32(8, 2, 4, 3)],
        {"rightside": True, "transpose": True, "lower": False}),
    "sumlogdiag": _c("_linalg_sumlogdiag", [_lower(4)]),
    "syrk": _c("_linalg_syrk", [("any", (2, 3, 4))], {"alpha": 0.5}),
    "syrk_transposed": _c("_linalg_syrk", [("any", (2, 3, 4))],
                          {"transpose": True}),
    "makediag": _c("_linalg_makediag", [("any", (2, 3))]),
    "makediag_offset_1": _c("_linalg_makediag", [("any", (2, 3))],
                            {"offset": 1}),
    "makediag_offset_-2": _c("_linalg_makediag", [("any", (2, 3))],
                             {"offset": -2}),
    "extractdiag": _c("_linalg_extractdiag", [("any", (2, 4, 4))]),
    "extractdiag_offset_1": _c("_linalg_extractdiag", [("any", (2, 4, 4))],
                               {"offset": 1}),
    "extractdiag_offset_-2": _c("_linalg_extractdiag",
                                [("any", (2, 4, 4))], {"offset": -2}),
    "inverse": _c("_linalg_inverse", [_well(3)]),
    "det": _c("_linalg_det", [_well(3)]),
    "slogdet": _c("_linalg_slogdet",
                  [np.concatenate([_well(3), -_well(3, b=1, seed=9)])]),
})

SIGN_CASES = {
    "syevd": ("_linalg_syevd", [_spd(4, b=2, seed=11)]),
    "syevd_asymmetric_input": ("_linalg_syevd", [_f32(12, 2, 3, 3)]),
    "gelqf": ("_linalg_gelqf", [_f32(13, 2, 3, 5)]),
    "gelqf_square": ("_linalg_gelqf", [_well(4, seed=14)]),
}


def sign_invariant(op, outs):
    """The parts of ``op``'s outputs that do not depend on the solver's
    choice of signs: for syevd the eigenvalues, |U| and U^T diag(w) U;
    for gelqf |L|, |Q| and L Q."""
    a, b = outs
    if op == "_linalg_syevd":
        u, w = a, b
        return [w, np.abs(u),
                np.einsum("bki,bk,bkj->bij", u, w, u)]
    low, q = a, b
    return [np.abs(low), np.abs(q), low @ q]


# -- misc_tail ----------------------------------------------------------------
_GROUP[0] = "misc_tail"
TAIL_CASES.update({
    "div_sqrt_dim": _c("_contrib_div_sqrt_dim", [("any", (3, 4))]),
    "quadratic": _c("_contrib_quadratic", [("any", (3, 4))],
                    {"a": 0.5, "b": -1.0, "c": 2.0}),
    "slice_assign": _c("_slice_assign", [("any", (4, 5)), ("any", (2, 3))],
                       {"begin": (1, 1), "end": (3, 4)}),
    "slice_assign_step": _c("_slice_assign",
                            [("any", (4, 5)), ("any", (2, 3))],
                            {"begin": (0, 0), "end": (4, 5),
                             "step": (2, 2)}),
    "slice_assign_scalar": _c("_slice_assign_scalar", [("any", (4, 5))],
                              {"scalar": 7.0, "begin": (1,), "end": (3,)}),
    "scatter_plus_scalar": _c("_scatter_plus_scalar", [("any", (3, 4))],
                              {"scalar": 1.5}),
    "scatter_minus_scalar": _c("_scatter_minus_scalar", [("any", (3, 4))],
                               {"scalar": 1.5}),
    "scatter_elemwise_div": _c("_scatter_elemwise_div",
                               [("any", (3, 4)), ("pos", (3, 4))]),
    "image_to_tensor": _c("_image_to_tensor", [("any", (4, 5, 3))]),
    "image_to_tensor_uint8": _c("_image_to_tensor", [_u8(20, 4, 5, 3)],
                                grad=False),
    "image_normalize": _c("_image_normalize", [("any", (3, 4, 5))],
                          {"mean": (0.1, 0.2, 0.3), "std": (1.0, 2.0, 3.0)}),
    "image_normalize_one_value": _c("_image_normalize",
                                    [("any", (2, 3, 4, 5))],
                                    {"mean": 0.5, "std": 2.0}),
    "cvimresize_bilinear_down": _c("_cvimresize", [("any", (6, 8, 3))],
                                   {"w": 5, "h": 4, "interp": 1}),
    "cvimresize_cubic_up": _c("_cvimresize", [("any", (3, 4, 2))],
                              {"w": 7, "h": 5, "interp": 2}),
    "cvimresize_nearest": _c("_cvimresize", [("any", (5, 6, 3))],
                             {"w": 4, "h": 9, "interp": 0}),
    "cvimresize_lanczos_uint8": _c("_cvimresize", [_u8(21, 6, 7, 3)],
                                   {"w": 5, "h": 9, "interp": 4},
                                   grad=False),
    "cvimresize_uint8_area": _c("_cvimresize", [_u8(22, 8, 8, 1)],
                                {"w": 4, "h": 4, "interp": 3},
                                grad=False),
})
for _t in range(5):
    TAIL_CASES["cvcopyMakeBorder_type_%d" % _t] = _c(
        "_cvcopyMakeBorder", [("any", (4, 5, 3))],
        {"top": 1, "bot": 2, "left": 3, "right": 1, "type": _t,
         "value": 0.5})
TAIL_CASES["cvcopyMakeBorder_uint8"] = _c(
    "_cvcopyMakeBorder", [_u8(23, 3, 4, 3)],
    {"top": 2, "bot": 0, "left": 1, "right": 2, "value": 9.0},
    grad=False)

# -- sparse (the dense forms) -------------------------------------------------
_GROUP[0] = "sparse"
TAIL_CASES.update({
    # the ex path, not differentiable (as in the JAX package)
    "cast_storage_default": _c("cast_storage", [("any", (3, 4))],
                               {"stype": "default"}, grad=False),
    "SparseEmbedding": _c("_contrib_SparseEmbedding",
                          [("fidx", (2, 3), 0, 6), ("any", (6, 4))],
                          {"input_dim": 6, "output_dim": 4}),
})

# -- nn tail ------------------------------------------------------------------
_GROUP[0] = "nn_tail"
_CTC_LABEL = np.array([[1, 2, 0], [3, 3, 1], [4, 0, 0]], np.float32)
_CTC_LABEL_LAST = np.array([[0, 1, -1], [2, 2, 0], [3, -1, -1]], np.float32)
TAIL_CASES.update({
    "softmin": _c("softmin", [("any", (3, 4))]),
    "softmin_axis0_temperature": _c("softmin", [("any", (3, 4))],
                                    {"axis": 0, "temperature": 2.0}),
    "SoftmaxActivation": _c("SoftmaxActivation", [("any", (2, 3, 4))]),
    "SoftmaxActivation_channel": _c("SoftmaxActivation",
                                    [("any", (2, 3, 4))],
                                    {"mode": "channel"}),
    "softmax_cross_entropy": _c("softmax_cross_entropy",
                                [("any", (4, 5)), ("fidx", (4,), 0, 5)]),
    "L2Normalization": _c("L2Normalization", [("any", (2, 3, 4))]),
    "L2Normalization_channel": _c("L2Normalization", [("any", (2, 3, 4))],
                                  {"mode": "channel"}),
    "L2Normalization_spatial": _c("L2Normalization",
                                  [("any", (2, 3, 4, 2))],
                                  {"mode": "spatial", "eps": 1e-3}),
    "LRN": _c("LRN", [("any", (2, 5, 3, 3))], {"nsize": 3}),
    "LRN_5": _c("LRN", [("any", (2, 6, 2, 2))],
                {"nsize": 5, "alpha": 0.01, "beta": 0.5, "knorm": 1.0}),
    "LinearRegressionOutput": _c("LinearRegressionOutput",
                                 [("any", (4, 3)), ("any", (4, 3))],
                                 {"grad_scale": 2.0}),
    "LogisticRegressionOutput": _c("LogisticRegressionOutput",
                                   [("any", (4, 3)), ("unit", (4, 3))]),
    "MAERegressionOutput": _c("MAERegressionOutput",
                              [("any", (4, 3, 2)), ("any", (4, 6))],
                              {"grad_scale": 0.5}),
    "SVMOutput": _c("SVMOutput", [("any", (4, 5)), ("fidx", (4,), 0, 5)]),
    "SVMOutput_linear": _c("SVMOutput",
                           [("any", (4, 5)), ("fidx", (4,), 0, 5)],
                           {"use_linear": True, "margin": 0.5,
                            "regularization_coefficient": 2.0}),
    "UpSampling_nearest": _c("UpSampling", [("any", (2, 3, 4, 5))],
                             {"scale": 2}),
    "UpSampling_bilinear": _c("UpSampling", [("any", (2, 3, 4, 5))],
                              {"scale": 3, "sample_type": "bilinear"}),
    "UpSampling_concat": _c("UpSampling", [("any", (1, 2, 3, 3)),
                                           ("any", (1, 3, 3, 3))],
                            {"scale": 2, "num_args": 2}),
    "UpSampling_sum": _c("UpSampling", [("any", (1, 2, 3, 3)),
                                        ("any", (1, 2, 3, 3))],
                         {"scale": 2, "num_args": 2,
                          "multi_input_mode": "sum"}),
    "CTCLoss": _c("CTCLoss", [("any", (3, 7, 5)), _CTC_LABEL]),
    "CTCLoss_lengths": _c("CTCLoss", [("any", (3, 7, 5)), _CTC_LABEL,
                                      np.array([7, 5, 6], np.int32),
                                      np.array([2, 3, 1], np.int32)],
                          {"use_data_lengths": True,
                           "use_label_lengths": True}),
    "CTCLoss_blank_last": _c("CTCLoss", [("any", (3, 7, 5)),
                                         _CTC_LABEL_LAST],
                             {"blank_label": "last"}),
    "CTCLoss_blank_last_data_lengths": _c(
        "CTCLoss", [("any", (3, 7, 5)), _CTC_LABEL_LAST,
                    np.array([4, 7, 3], np.int32)],
        {"blank_label": "last", "use_data_lengths": True}),
    # three repeated labels need 5 frames: 3 frames are infeasible, the
    # loss about 1e30 and the gradients finite
    "CTCLoss_infeasible": _c("CTCLoss", [("any", (2, 3, 4)),
                                         np.array([[1, 1, 1], [2, 0, 0]],
                                                  np.float32)]),
    "Pooling_lp": _c("Pooling", [("any", (2, 3, 5, 5))],
                     {"kernel": (2, 2), "stride": (2, 2), "pool_type": "lp",
                      "pad": (1, 1)}),
    "Pooling_lp3_full": _c("Pooling", [("pos", (1, 2, 6))],
                           {"kernel": (3,), "stride": (2,), "pool_type": "lp",
                            "p_value": 3, "pooling_convention": "full"}),
    "BatchNorm_alias": _c("BatchNorm", [("any", (4, 3)), ("pos", (3,)),
                                        ("any", (3,)), ("any", (3,)),
                                        ("pos", (3,))],
                          {"fix_gamma": False}),
    "Convolution_v1": _c("Convolution_v1", [("any", (1, 2, 5, 5)),
                                            ("any", (3, 2, 3, 3)),
                                            ("any", (3,))],
                         {"kernel": (3, 3), "num_filter": 3}),
    "Pooling_v1": _c("Pooling_v1", [("any", (1, 2, 5, 5))],
                     {"kernel": (2, 2), "pool_type": "avg"}),
})

# channels-last: 1-, 2- and 3-d, the weight OI + spatial
_NWC = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
for _nd in (1, 2, 3):
    _sp = (5, 6, 4)[:_nd]
    _k = (3, 2, 2)[:_nd]
    TAIL_CASES["Convolution_%s" % _NWC[_nd]] = _c(
        "Convolution", [("any", (2,) + _sp + (4,)),
                        ("any", (6, 2) + _k), ("any", (6,))],
        {"kernel": _k, "num_filter": 6, "num_group": 2,
         "stride": (2,) * _nd, "pad": (1,) * _nd, "layout": _NWC[_nd]})
    TAIL_CASES["Deconvolution_%s" % _NWC[_nd]] = _c(
        "Deconvolution", [("any", (2,) + _sp + (4,)),
                          ("any", (4, 3) + _k)],
        {"kernel": _k, "num_filter": 3, "stride": (2,) * _nd,
         "pad": (1,) * _nd, "adj": (1,) * _nd, "layout": _NWC[_nd]})
    for _pt in ("max", "avg", "lp"):
        TAIL_CASES["Pooling_%s_%s" % (_pt, _NWC[_nd])] = _c(
            "Pooling", [("any", (2,) + _sp + (3,))],
            {"kernel": (2,) * _nd, "stride": (2,) * _nd, "pool_type": _pt,
             "pad": (1,) * _nd, "count_include_pad": False,
             "layout": _NWC[_nd]})
    TAIL_CASES["Pooling_global_%s" % _NWC[_nd]] = _c(
        "Pooling", [("any", (2,) + _sp + (3,))],
        {"global_pool": True, "pool_type": "avg", "layout": _NWC[_nd]})

# the names no case above runs under their own name: each runs its op's
# first case under that name
ALIASES = {
    "linalg": [p + n for p in ("linalg_",) for n in (
        "det", "extractdiag", "gelqf", "gemm", "gemm2", "inverse",
        "makediag", "potrf", "potri", "slogdet", "sumlogdiag", "syevd",
        "syrk", "trmm", "trsm")],
    "misc_tail": ["_contrib_quadratic_function", "_crop_assign",
                  "_crop_assign_scalar", "copyMakeBorder", "image_normalize",
                  "imresize", "to_tensor"],
    "nn_tail": ["SyncBatchNorm", "_contrib_SyncBatchNorm", "BatchNorm_v1",
                "_contrib_CTCLoss", "ctc_loss", "_contrib_ctc_loss"],
}

# the nn names slice 18 registers (ops/nn.py's others are earlier slices')
NN_NAMES = ["softmin", "SoftmaxActivation", "softmax_cross_entropy",
            "L2Normalization", "LRN", "LinearRegressionOutput",
            "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
            "UpSampling", "CTCLoss", "_contrib_CTCLoss", "ctc_loss",
            "_contrib_ctc_loss", "SyncBatchNorm", "_contrib_SyncBatchNorm",
            "BatchNorm_v1", "Convolution_v1", "Pooling_v1"]

# names whose parity cases are tests of their own (not the sweep):
# decoding takes bytes, reading takes a file, the sparse ops sparse input
OWN_TESTS = {"_cvimdecode", "imdecode_op", "_cvimread", "_sparse_retain",
             "_linalg_syevd", "_linalg_gelqf"}


def group(name):
    return sorted(k for k, v in TAIL_CASES.items() if v[3]["group"] == name)


def canonical(name, registry):
    """The first case whose op is ``name``'s OpDef in ``registry``."""
    target = registry[name]
    for key in sorted(TAIL_CASES):
        if registry[TAIL_CASES[key][0]] is target:
            return TAIL_CASES[key]
    for key, (op, inputs) in sorted(SIGN_CASES.items()):
        if registry[op] is target:
            return op, inputs, {}, {"int": False, "grad": True,
                                    "group": "linalg"}
    raise AssertionError("no case runs the op behind %r" % name)
