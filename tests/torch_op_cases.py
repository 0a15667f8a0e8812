"""The op sweep's cases: every name ``mxnet_tpu/ops/tensor.py`` registers,
and the word language model's ``nn`` ops, at small shapes, with a case
for each parameter that changes the result.

numpy only: ``tests/test_torch_tensor_ops.py`` runs these cases through
the JAX package and the port on the CPU, and ``chip_smoke.py``'s
``nd_ops_card`` runs them through the port on the card against the port
on the CPU. A case is (op, input specs, attrs, flags):

* an input spec is (kind, shape) or a fixed numpy array; the kinds say
  which values to draw (``pos``: away from 0 and positive, ``unit``:
  inside (-1, 1), ``ge1``: at least 1, ``near1``: around 1, ``nan``: with
  NaNs, ``perm``: distinct values, ``idx``/``fidx``: int32/float32
  indices in [lo, hi)); each spec has a float32 and an int32 form;
* ``int``: the JAX op takes the int32 form too (checked by the sweep);
* ``grad``: the op is differentiable in its float inputs.
"""
import numpy as np

# kind -> (float32 draw, int32 draw) from a RandomState and a shape
_KINDS = {
    "any": (lambda rs, s: rs.randn(*s), lambda rs, s: rs.randint(-5, 6, s)),
    "pos": (lambda rs, s: rs.uniform(0.5, 2.0, s),
            lambda rs, s: rs.randint(1, 6, s)),
    "unit": (lambda rs, s: rs.uniform(-0.9, 0.9, s),
             lambda rs, s: rs.randint(-1, 2, s)),
    "ge1": (lambda rs, s: rs.uniform(1.1, 3.0, s),
            lambda rs, s: rs.randint(1, 5, s)),
    "near1": (lambda rs, s: rs.uniform(0.6, 1.4, s),
              lambda rs, s: rs.randint(1, 3, s)),
    "nan": (lambda rs, s: np.where(rs.rand(*s) < 0.2, np.nan, rs.randn(*s)),
            lambda rs, s: rs.randint(-5, 6, s)),
    "perm": (lambda rs, s: rs.permutation(int(np.prod(s))).reshape(s) * 0.5
             + rs.uniform(0, 0.1, s),
             lambda rs, s: rs.permutation(int(np.prod(s))).reshape(s)
             - int(np.prod(s)) // 2),
}


def make_inputs(specs, dtype, seed):
    """The numpy inputs of a case in ``dtype`` ('float32' or 'int32')."""
    rs = np.random.RandomState(seed)
    out = []
    for spec in specs:
        if isinstance(spec, np.ndarray):
            out.append(spec)
            continue
        kind, shape = spec[0], spec[1]
        if kind in ("idx", "fidx"):
            lo, hi = spec[2], spec[3]
            a = rs.randint(lo, hi, shape)
            out.append(a.astype(np.int32 if kind == "idx" else np.float32))
            continue
        f, i = _KINDS[kind]
        out.append(f(rs, shape).astype(np.float32) if dtype == "float32"
                   else i(rs, shape).astype(np.int32))
    return out


_GROUP = ["unary"]  # the sweep file a case belongs to, set section by section


def _c(op, specs, attrs=None, int_ok=True, grad=True):
    return (op, specs, attrs or {},
            {"int": int_ok, "grad": grad, "group": _GROUP[0]})


A34 = [("any", (3, 4))]
A34x2 = [("any", (3, 4)), ("any", (3, 4))]
CASES = {}

# -- unary math -------------------------------------------------------------
_UNARY_DOMAIN = {
    "sqrt": "pos", "rsqrt": "pos", "log": "pos", "log10": "pos",
    "log2": "pos", "log1p": "pos", "gammaln": "pos", "gamma": "pos",
    "reciprocal": "pos", "rcbrt": "pos", "arcsin": "unit",
    "arccos": "unit", "arctanh": "unit", "erfinv": "unit",
    "arccosh": "ge1", "cbrt": "pos",
}
_NO_GRAD = {"floor", "ceil", "round", "rint", "fix", "trunc", "sign",
            "logical_not", "ones_like", "zeros_like", "BlockGrad",
            "stop_gradient"}
for _n in ("abs", "sign", "negative", "reciprocal", "square", "sqrt",
           "rsqrt", "cbrt", "rcbrt", "exp", "expm1", "log", "log10",
           "log2", "log1p", "sin", "cos", "tan", "sinh", "cosh", "tanh",
           "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh",
           "degrees", "radians", "floor", "ceil", "round", "rint", "fix",
           "trunc", "gamma", "gammaln", "erf", "erfinv", "relu", "sigmoid",
           "hard_sigmoid", "softsign", "logical_not", "_copy", "ones_like",
           "zeros_like", "BlockGrad"):
    # JAX refuses integer rsqrt and sigmoid (lax.rsqrt, lax.logistic)
    CASES[_n] = _c(_n, [(_UNARY_DOMAIN.get(_n, "any"), (3, 4))],
                   int_ok=_n not in ("rsqrt", "sigmoid"),
                   grad=_n not in _NO_GRAD)
CASES["gamma_negative"] = _c("gamma", [np.array(
    [[-0.5, -1.5, -2.5], [0.5, 3.0, 4.25]], np.float32)], int_ok=False)
CASES["round_halves"] = _c("round", [np.array(
    [[0.5, 1.5, 2.5, -0.5], [-1.5, 2.4, -2.6, 3.5]], np.float32)],
    int_ok=False, grad=False)
CASES["make_loss"] = _c("make_loss", A34, {"grad_scale": 0.5,
                                           "normalization": "batch"})
CASES["make_loss_valid"] = _c("make_loss", A34,
                              {"normalization": "valid",
                               "valid_thresh": 0.1})
CASES["smooth_l1"] = _c("smooth_l1", A34, {"scalar": 1.5})
CASES["clip"] = _c("clip", A34, {"a_min": -0.5, "a_max": 0.7})
CASES["Cast_int32"] = _c("Cast", A34, {"dtype": "int32"}, grad=False)
CASES["Cast_float32"] = _c("Cast", A34, {"dtype": "float32"})

# -- binary -------------------------------------------------------------------
_GROUP[0] = "binary"
_B_SPECS = {"div": "pos", "mod": "pos", "power": "pos"}
_B_NO_GRAD = {"equal", "not_equal", "greater", "greater_equal", "lesser",
              "lesser_equal", "logical_and", "logical_or", "logical_xor"}
for _n, _b in (("elemwise_add", "add"), ("elemwise_sub", "sub"),
               ("elemwise_mul", "mul"), ("elemwise_div", "div"),
               ("_grad_add", "add"), ("_mod", "mod"), ("_power", "power"),
               ("_hypot", "hypot"), ("_maximum", "maximum"),
               ("_minimum", "minimum"), ("_equal", "equal"),
               ("_not_equal", "not_equal"), ("_greater", "greater"),
               ("_greater_equal", "greater_equal"), ("_lesser", "lesser"),
               ("_lesser_equal", "lesser_equal"),
               ("_logical_and", "logical_and"), ("_logical_or", "logical_or"),
               ("_logical_xor", "logical_xor")):
    kind = _B_SPECS.get(_b, "any")
    lhs = "pos" if _b == "power" else "any"
    CASES[_n] = _c(_n, [(lhs, (3, 4)), (kind, (3, 4))],
                   grad=_b not in _B_NO_GRAD)
    CASES["broadcast_" + _b] = _c(
        "broadcast_" + _b, [(lhs, (2, 3, 4)), (kind, (1, 3, 1))],
        grad=_b not in _B_NO_GRAD)
CASES["broadcast_equal_ties"] = _c(
    "broadcast_equal", [np.array([[1, 2], [3, 4]], np.float32),
                        np.array([[1, 0]], np.float32)], grad=False)

for _n, _s in (("_plus_scalar", 1.5), ("_minus_scalar", 1.5),
               ("_rminus_scalar", 1.5), ("_mul_scalar", -2.5),
               ("_div_scalar", 2.0), ("_rdiv_scalar", 2.0),
               ("_mod_scalar", 1.5), ("_rmod_scalar", 3.0),
               ("_power_scalar", 2.0), ("_rpower_scalar", 1.5),
               ("_maximum_scalar", 0.3), ("_minimum_scalar", 0.3),
               ("_hypot_scalar", 2.0), ("_equal_scalar", 1.0),
               ("_not_equal_scalar", 1.0), ("_greater_scalar", 0.5),
               ("_greater_equal_scalar", 1.0), ("_lesser_scalar", 0.5),
               ("_lesser_equal_scalar", 1.0), ("_logical_and_scalar", 1.0),
               ("_logical_or_scalar", 0.0), ("_logical_xor_scalar", 1.0)):
    nograd = any(k in _n for k in ("equal", "greater", "lesser", "logical"))
    spec = "pos" if _n in ("_rdiv_scalar", "_rmod_scalar") else "any"
    CASES[_n] = _c(_n, [(spec, (3, 4))], {"scalar": _s}, grad=not nograd)
CASES["add_n"] = _c("add_n", [("any", (3, 4))] * 3, {"num_args": 3})

# -- reductions ---------------------------------------------------------------
_GROUP[0] = "reduce"
for _n in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min"):
    kind = {"prod": "near1", "nanprod": "nan", "nansum": "nan"}.get(_n, "perm")
    grad = _n not in ("nansum", "nanprod")
    CASES[_n + "_all"] = _c(_n, [(kind, (2, 3, 4))], {}, grad=grad)
    CASES[_n + "_axis1"] = _c(_n, [(kind, (2, 3, 4))], {"axis": 1},
                              grad=grad)
    CASES[_n + "_axes_keepdims"] = _c(_n, [(kind, (2, 3, 4))],
                                      {"axis": (0, 2), "keepdims": True},
                                      grad=grad)
    CASES[_n + "_exclude"] = _c(_n, [(kind, (2, 3, 4))],
                                {"axis": 1, "exclude": True}, grad=grad)
CASES["sum_axis"] = _c("sum_axis", [("any", (2, 3, 4))], {"axis": 2})
CASES["max_axis"] = _c("max_axis", [("perm", (2, 3, 4))], {"axis": 0})
CASES["min_axis"] = _c("min_axis", [("perm", (2, 3, 4))], {"axis": -1})
CASES["norm_2"] = _c("norm", [("any", (2, 3, 4))])
CASES["norm_1_axis"] = _c("norm", [("any", (2, 3, 4))],
                          {"ord": 1, "axis": 1})
CASES["norm_2_axes_keepdims"] = _c("norm", [("any", (2, 3, 4))],
                                   {"axis": (0, 2), "keepdims": True})
CASES["_square_sum"] = _c("_square_sum", [("any", (2, 3, 4))], {"axis": 1})
CASES["_square_sum_exclude"] = _c("_square_sum", [("any", (2, 3, 4))],
                                  {"axis": 1, "exclude": True,
                                   "keepdims": True})
for _n in ("argmax", "argmin"):
    CASES[_n] = _c(_n, [("perm", (3, 4, 5))], grad=False)
    CASES[_n + "_axis_keepdims"] = _c(_n, [("perm", (3, 4, 5))],
                                      {"axis": 1, "keepdims": True},
                                      grad=False)
CASES["argmax_channel"] = _c("argmax_channel", [("perm", (3, 5))],
                             grad=False)

# -- shape --------------------------------------------------------------------
_GROUP[0] = "shape"
CASES["Reshape"] = _c("Reshape", [("any", (2, 3, 4))], {"shape": (0, -1)})
CASES["Reshape_reverse"] = _c("Reshape", [("any", (2, 3, 4))],
                              {"shape": (-1, 0), "reverse": True})
CASES["Flatten"] = _c("Flatten", [("any", (2, 3, 4))])
CASES["transpose"] = _c("transpose", [("any", (2, 3, 4))],
                        {"axes": (1, 0, 2)})
CASES["expand_dims"] = _c("expand_dims", A34, {"axis": 1})
CASES["expand_dims_last"] = _c("expand_dims", A34, {"axis": -1})
CASES["squeeze"] = _c("squeeze", [("any", (2, 1, 3, 1))])
CASES["squeeze_axis"] = _c("squeeze", [("any", (2, 1, 3, 1))],
                           {"axis": (1,)})
CASES["slice"] = _c("slice", [("any", (4, 5, 3))],
                    {"begin": (1, 0), "end": (3, 4)})
CASES["slice_step"] = _c("slice", [("any", (4, 5, 3))],
                         {"begin": (0, 1, 0), "end": (4, 5, 3),
                          "step": (2, 2, 1)})
CASES["slice_negative_step"] = _c("slice", [("any", (4, 5))],
                                  {"begin": (3, 4), "end": (0, 0),
                                   "step": (-1, -2)})
CASES["crop"] = _c("crop", [("any", (4, 5))], {"begin": (1, 1),
                                               "end": (3, 5)})
CASES["slice_axis"] = _c("slice_axis", [("any", (4, 5))],
                         {"axis": 1, "begin": 1, "end": 3})
CASES["slice_axis_negative"] = _c("slice_axis", [("any", (4, 5))],
                                  {"axis": 0, "begin": -3, "end": None})
CASES["slice_like"] = _c("slice_like", [("any", (4, 5)), ("any", (2, 3))])
CASES["slice_like_axes"] = _c("slice_like",
                              [("any", (4, 5)), ("any", (2, 3))],
                              {"axes": (1,)})
CASES["Concat"] = _c("Concat", [("any", (2, 3)), ("any", (2, 2))],
                     {"num_args": 2, "dim": 1})
CASES["stack"] = _c("stack", A34x2, {"num_args": 2, "axis": 1})
CASES["SliceChannel"] = _c("SliceChannel", [("any", (2, 6))],
                           {"num_outputs": 3, "axis": 1})
CASES["SwapAxis"] = _c("SwapAxis", [("any", (2, 3, 4))],
                       {"dim1": 0, "dim2": 2})
CASES["tile"] = _c("tile", A34, {"reps": (2, 1)})
CASES["tile_more_axes"] = _c("tile", A34, {"reps": (2, 1, 3)})
CASES["repeat"] = _c("repeat", A34, {"repeats": 2})
CASES["repeat_axis"] = _c("repeat", A34, {"repeats": 3, "axis": 1})
CASES["reverse"] = _c("reverse", [("any", (2, 3, 4))], {"axis": (0, 2)})
CASES["flip"] = _c("flip", [("any", (2, 3, 4))], {"axis": (1,)})
CASES["broadcast_to"] = _c("broadcast_to", [("any", (1, 3, 1))],
                           {"shape": (2, 0, 4)})
CASES["broadcast_axis"] = _c("broadcast_axis", [("any", (1, 3, 1))],
                             {"axis": (0, 2), "size": (2, 4)})
CASES["broadcast_axes"] = _c("broadcast_axes", [("any", (3, 1))],
                             {"axis": (1,), "size": (5,)})
CASES["broadcast_like"] = _c("broadcast_like",
                             [("any", (1, 3)), ("any", (4, 3))])
CASES["reshape_like"] = _c("reshape_like",
                           [("any", (2, 6)), ("any", (3, 4))])
CASES["shape_array"] = _c("shape_array", [("any", (2, 3, 4))], grad=False)
CASES["size_array"] = _c("size_array", [("any", (2, 3, 4))], grad=False)
CASES["Pad"] = _c("Pad", [("any", (1, 2, 3, 3))],
                  {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                   "constant_value": 0.5})
CASES["Pad_edge"] = _c("Pad", [("any", (1, 2, 3, 3))],
                       {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 1, 2, 0)})
CASES["Pad_reflect"] = _c("Pad", [("any", (1, 2, 3, 3))],
                          {"mode": "reflect",
                           "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)})
CASES["depth_to_space"] = _c("depth_to_space", [("any", (1, 8, 2, 3))],
                             {"block_size": 2})
CASES["space_to_depth"] = _c("space_to_depth", [("any", (1, 2, 4, 6))],
                             {"block_size": 2})
CASES["diag_vector"] = _c("diag", [("any", (4,))], {"k": 1})
CASES["diag_matrix"] = _c("diag", [("any", (4, 5))], {"k": -1})
CASES["diag_3d"] = _c("diag", [("any", (2, 3, 4))],
                      {"k": 1, "axis1": 1, "axis2": 2})
CASES["where"] = _c("where", [("idx", (3, 4), 0, 2), ("any", (3, 4)),
                              ("any", (3, 4))])
CASES["where_row_condition"] = _c(
    "where", [("fidx", (3,), 0, 2), ("any", (3, 4)), ("any", (3, 4))])

# -- dot ----------------------------------------------------------------------
_GROUP[0] = "index"
CASES["dot"] = _c("dot", [("any", (3, 4)), ("any", (4, 5))])
CASES["dot_vectors"] = _c("dot", [("any", (4,)), ("any", (4,))])
CASES["dot_transpose_a"] = _c("dot", [("any", (4, 3)), ("any", (4, 5))],
                              {"transpose_a": True})
CASES["dot_transpose_b"] = _c("dot", [("any", (3, 4)), ("any", (5, 4))],
                              {"transpose_b": True})
CASES["dot_3d_2d"] = _c("dot", [("any", (2, 3, 4)), ("any", (4, 5))])
CASES["dot_2d_3d"] = _c("dot", [("any", (3, 4)), ("any", (4, 2, 5))])
CASES["batch_dot"] = _c("batch_dot", [("any", (2, 3, 4)),
                                      ("any", (2, 4, 5))])
CASES["batch_dot_transposed"] = _c(
    "batch_dot", [("any", (2, 4, 3)), ("any", (2, 5, 4))],
    {"transpose_a": True, "transpose_b": True})
CASES["khatri_rao"] = _c("khatri_rao", [("any", (2, 3)), ("any", (4, 3))],
                         {"num_args": 2})

# -- indexing -----------------------------------------------------------------
_GROUP[0] = "index"
CASES["take"] = _c("take", [("any", (5, 3)), ("idx", (2, 4), 0, 5)])
CASES["take_clip"] = _c("take", [("any", (5, 3)), ("idx", (2, 4), -3, 8)])
CASES["take_wrap_axis1"] = _c("take", [("any", (2, 5)),
                                       ("fidx", (4,), -7, 9)],
                              {"axis": 1, "mode": "wrap"})
CASES["batch_take"] = _c("batch_take", [("any", (4, 5)),
                                        ("idx", (4,), 0, 5)])
CASES["batch_take_negative"] = _c("batch_take", [("any", (4, 5)),
                                                 np.array([-1, -5, 2, 0],
                                                          np.int32)])
CASES["pick"] = _c("pick", [("any", (3, 5)), ("idx", (3,), 0, 5)])
CASES["pick_keepdims_axis0"] = _c("pick", [("any", (3, 5)),
                                           ("fidx", (5,), 0, 3)],
                                  {"axis": 0, "keepdims": True})
CASES["Embedding"] = _c("Embedding", [("idx", (2, 3), 0, 6),
                                      ("any", (6, 4))],
                        {"input_dim": 6, "output_dim": 4})
CASES["one_hot"] = _c("one_hot", [("idx", (2, 3), -2, 7)], {"depth": 5},
                      grad=False)
CASES["one_hot_values_dtype"] = _c(
    "one_hot", [("fidx", (4,), 0, 5)],
    {"depth": 5, "on_value": 3.0, "off_value": -1.0, "dtype": "int32"},
    grad=False)
CASES["gather_nd"] = _c("gather_nd", [("any", (3, 4, 2)),
                                      ("idx", (2, 5), -3, 3)])
CASES["scatter_nd"] = _c("scatter_nd", [("any", (5,)),
                                        np.array([[0, 2, 0, 1, 2],
                                                  [1, 3, 1, 0, 2]],
                                                 np.int32)],
                         {"shape": (3, 4)})
CASES["_scatter_set_nd"] = _c("_scatter_set_nd",
                              [("any", (3, 4)), ("any", (4,)),
                               np.array([[0, 2, 1, 2], [1, 3, 0, 0]],
                                        np.int32)])
CASES["_ravel_multi_index"] = _c("_ravel_multi_index",
                                 [np.array([[0, 2, 1], [3, 1, 0]],
                                           np.float32)],
                                 {"shape": (3, 4)}, grad=False)
CASES["_ravel_multi_index_int"] = _c("_ravel_multi_index",
                                     [np.array([[0, 2, 1], [3, 1, 0]],
                                               np.int32)],
                                     {"shape": (3, 4)}, grad=False)
CASES["_unravel_index"] = _c("_unravel_index",
                             [np.array([0, 5, 11, 7], np.int32)],
                             {"shape": (3, 4)}, grad=False)

# -- creation -----------------------------------------------------------------
_GROUP[0] = "index"
CASES["_zeros"] = _c("_zeros", [], {"shape": (2, 3)}, grad=False)
CASES["_ones_int32"] = _c("_ones", [], {"shape": (2, 3), "dtype": "int32"},
                          grad=False)
CASES["_full"] = _c("_full", [], {"shape": (2, 3), "value": 2.5},
                    grad=False)
CASES["_arange"] = _c("_arange", [], {"start": 1.0, "stop": 4.0,
                                      "step": 0.5}, grad=False)
CASES["_arange_repeat_int"] = _c("_arange", [], {"start": 5.0,
                                                 "repeat": 2,
                                                 "dtype": "int32"},
                                 grad=False)
CASES["_eye"] = _c("_eye", [], {"N": 3, "M": 4, "k": 1}, grad=False)
CASES["_eye_square"] = _c("_eye", [], {"N": 3, "k": -1}, grad=False)
CASES["_identity_with_attr_like_rhs"] = _c("_identity_with_attr_like_rhs",
                                           A34x2)
CASES["_NoGradient"] = _c("_NoGradient", [], grad=False)

# -- ordering -----------------------------------------------------------------
_GROUP[0] = "reduce"
for _rt in ("value", "indices", "mask", "both"):
    CASES["topk_" + _rt] = _c("topk", [("perm", (3, 5))],
                              {"k": 2, "ret_typ": _rt},
                              grad=_rt == "value")
CASES["topk_ascend_axis0"] = _c("topk", [("perm", (4, 3))],
                                {"k": 3, "axis": 0, "is_ascend": True,
                                 "ret_typ": "value"})
CASES["topk_ties"] = _c("topk", [np.array([[1, 3, 3, 0, 3]], np.float32)],
                        {"k": 3, "ret_typ": "both"}, grad=False)
CASES["sort"] = _c("sort", [("perm", (3, 5))])
CASES["sort_descend_axis0"] = _c("sort", [("perm", (3, 5))],
                                 {"axis": 0, "is_ascend": False})
CASES["argsort"] = _c("argsort", [("perm", (3, 5))], grad=False)
CASES["argsort_descend_int32"] = _c("argsort", [("perm", (3, 5))],
                                    {"is_ascend": False, "axis": 0,
                                     "dtype": "int32"}, grad=False)
CASES["argsort_ties"] = _c("argsort",
                           [np.array([[2, 1, 2, 1, 0]], np.float32)],
                           {"is_ascend": False}, grad=False)
CASES["_histogram_bins"] = _c("_histogram",
                              [("any", (20,)),
                               np.array([-1.0, -0.2, 0.0, 0.5, 1.0],
                                        np.float32)], grad=False)
CASES["_histogram_range"] = _c("_histogram", [("any", (20,))],
                               {"bin_cnt": 4, "range": (-2, 2)},
                               grad=False)

# -- the word language model's nn ops ---------------------------------------
_GROUP[0] = "nn"
NN_CASES = {
    "SequenceMask": _c("SequenceMask", [("any", (4, 3, 2)),
                                        np.array([2, 4, 1], np.float32)],
                       {"use_sequence_length": True, "value": -1.0}),
    "SequenceMask_axis1": _c("SequenceMask",
                             [("any", (3, 4, 2)),
                              np.array([2, 4, 0], np.float32)],
                             {"use_sequence_length": True, "axis": 1}),
    "SequenceMask_no_lengths": _c("SequenceMask", [("any", (4, 3))]),
    "SequenceLast": _c("SequenceLast", [("any", (4, 3, 2)),
                                        np.array([2, 4, 1], np.float32)],
                       {"use_sequence_length": True}),
    "SequenceLast_axis1": _c("SequenceLast",
                             [("any", (3, 4, 2)),
                              np.array([2, 4, 1], np.float32)],
                             {"use_sequence_length": True, "axis": 1}),
    "SequenceLast_no_lengths": _c("SequenceLast", [("any", (4, 3, 2))]),
    "SequenceReverse": _c("SequenceReverse",
                          [("any", (4, 3, 2)),
                           np.array([2, 4, 1], np.float32)],
                          {"use_sequence_length": True}),
    "SequenceReverse_no_lengths": _c("SequenceReverse", [("any", (4, 3))]),
    "_rnn_param_concat": _c("_rnn_param_concat",
                            [("any", (3, 4)), ("any", (5,))],
                            {"num_args": 2, "dim": 0}),
}


def rnn_case(mode, bidirectional, t=5, n=3, c=4, h=6, layers=2, seed=0):
    """Float32 inputs of the RNN op: data (T, N, C), the flat parameters
    (uniform within 1/sqrt(h)), state (and state_cell for lstm)."""
    from_size = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(layers):
        size += d * from_size * h * ((c if layer == 0 else h * d) + h)
    size += layers * d * 2 * from_size * h
    rs = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)
    ins = [rs.randn(t, n, c), rs.uniform(-k, k, size),
           0.5 * rs.randn(layers * d, n, h)]
    if mode == "lstm":
        ins.append(0.5 * rs.randn(layers * d, n, h))
    attrs = {"mode": mode, "state_size": h, "num_layers": layers,
             "bidirectional": bidirectional, "state_outputs": True}
    return [a.astype(np.float32) for a in ins], attrs


def group(name):
    """The sorted case ids of one sweep file's group."""
    return sorted(k for k, v in CASES.items() if v[3]["group"] == name)


def int_group(name):
    """The cases of a group that also run in int32: the JAX op takes
    int32, and some input has an int32 form."""
    return [k for k in group(name) if CASES[k][3]["int"] and any(
        not isinstance(s, np.ndarray) and s[0] not in ("idx", "fidx")
        for s in CASES[k][1])]


def _nb(k, p):
    return k * (1 - p) / p, k * (1 - p) / p ** 2


def _zipf_moments(rng):
    k = np.arange(rng)
    pk = np.log((k + 2.0) / (k + 1.0)) / np.log(rng + 1.0)
    pk[-1] += 1.0 - pk.sum()  # the clip puts the tail on the last id
    mean = (k * pk).sum()
    return mean, ((k - mean) ** 2 * pk).sum()


# sampler op -> (array inputs, attrs, [(mean, variance) of each row],
# support: "real", "positive", "count" or (lo, hi) for integers); the
# scalar-parameter ops draw N values, the _sample_* ops N for each of
# two parameter rows
RANDOM_N = 10000
RANDOM_CASES = {
    "_random_uniform": ([], {"low": -1.0, "high": 3.0}, [(1.0, 16 / 12)],
                        (-1.0, 3.0)),
    "_random_normal": ([], {"loc": 1.0, "scale": 2.0}, [(1.0, 4.0)],
                       "real"),
    "_random_exponential": ([], {"lam": 2.0}, [(0.5, 0.25)], "positive"),
    "_random_gamma": ([], {"alpha": 2.0, "beta": 1.5}, [(3.0, 4.5)],
                      "positive"),
    "_random_poisson": ([], {"lam": 3.0}, [(3.0, 3.0)], "count"),
    "_random_negative_binomial": ([], {"k": 3, "p": 0.4}, [_nb(3, 0.4)],
                                  "count"),
    "_random_generalized_negative_binomial": (
        [], {"mu": 2.0, "alpha": 0.5}, [(2.0, 2.0 + 0.5 * 4.0)], "count"),
    "_random_randint": ([], {"low": -2, "high": 5}, [(1.0, 4.0)], (-2, 4)),
    "_sample_uniform": ([np.array([0.0, 2.0], np.float32),
                         np.array([1.0, 6.0], np.float32)], {},
                        [(0.5, 1 / 12), (4.0, 16 / 12)], (0.0, 6.0)),
    "_sample_normal": ([np.array([0.0, 3.0], np.float32),
                        np.array([1.0, 0.5], np.float32)], {},
                       [(0.0, 1.0), (3.0, 0.25)], "real"),
    "_sample_exponential": ([np.array([1.0, 4.0], np.float32)], {},
                            [(1.0, 1.0), (0.25, 1 / 16)], "positive"),
    "_sample_gamma": ([np.array([1.0, 3.0], np.float32),
                       np.array([1.0, 0.5], np.float32)], {},
                      [(1.0, 1.0), (1.5, 0.75)], "positive"),
    "_sample_poisson": ([np.array([1.0, 5.0], np.float32)], {},
                        [(1.0, 1.0), (5.0, 5.0)], "count"),
    "_sample_negative_binomial": ([np.array([2.0, 5.0], np.float32),
                                   np.array([0.5, 0.3], np.float32)], {},
                                  [_nb(2, 0.5), _nb(5, 0.3)], "count"),
    "_sample_generalized_negative_binomial": (
        [np.array([1.0, 3.0], np.float32),
         np.array([0.5, 0.2], np.float32)], {},
        [(1.0, 1.5), (3.0, 3.0 + 0.2 * 9.0)], "count"),
    "_sample_unique_zipfian": ([], {"range_max": 1000},
                               [_zipf_moments(1000)], (0, 999)),
}
MULTINOMIAL_P = np.array([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]], np.float32)


def check_moments(name, rows, n=RANDOM_N):
    """Each row's sample mean within 5 standard errors of the
    distribution's, and its sample variance within 12 % (the kurtosis of
    these distributions keeps the variance's standard error under 2.5 %
    at 10,000 draws)."""
    for row, (mean, var) in zip(rows, RANDOM_CASES[name][2]):
        row = np.asarray(row, np.float64)
        assert abs(row.mean() - mean) < 5 * np.sqrt(var / n), \
            (name, row.mean(), mean)
        assert abs(row.var() - var) < 0.12 * var, (name, row.var(), var)


def check_support(name, values):
    sup = RANDOM_CASES[name][3]
    v = np.asarray(values)
    assert np.isfinite(v).all(), name
    if sup == "positive":
        assert (v > 0).all(), name
    elif sup == "count":
        assert (v >= 0).all() and (v == np.round(v)).all(), name
    elif isinstance(sup, tuple):
        assert (v >= sup[0]).all() and (v <= sup[1]).all(), name
