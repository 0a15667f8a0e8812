"""``Convolution``, ``Deconvolution`` and ``Pooling`` in the
channels-last layouts (NWC, NHWC, NDHWC) and ``lp`` pooling against the
JAX package's (CPU).

Their cases of ``torch_tail_cases`` run through both packages
(``torch_op_sweep``: forward and gradients, ``rtol=atol=2e-5`` in
float32); the weight is OI + spatial in both packages. Then shape
inference of a channels-last symbol (parameter shapes back-filled from
the channels on the last axis) against the JAX package's.
"""
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from torch_op_sweep import check
from torch_tail_cases import TAIL_CASES, group


@pytest.mark.parametrize("case", [k for k in group("nn_tail")
                                  if "WC" in k or "_lp" in k])
def test_layout_and_lp_op_matches_jax(case):
    check(*TAIL_CASES[case], "float32")


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_channels_last_symbol_infers_the_jax_shapes(nd):
    layout = {1: "NWC", 2: "NHWC", 3: "NDHWC"}[nd]
    shape = (2,) + (8, 6, 4)[:nd] + (3,)

    def build(pkg):
        x = pkg.sym.var("data")
        y = pkg.sym.Convolution(x, kernel=(3,) * nd, num_filter=4,
                                pad=(1,) * nd, layout=layout, name="c")
        y = pkg.sym.Pooling(y, kernel=(2,) * nd, stride=(2,) * nd,
                            pool_type="max", layout=layout, name="p")
        y = pkg.sym.Deconvolution(y, kernel=(2,) * nd, stride=(2,) * nd,
                                  num_filter=5, layout=layout, name="d")
        return pkg.sym.LinearRegressionOutput(y, name="out")

    want = build(jmx).infer_shape(data=shape)
    got = build(mx).infer_shape(data=shape)
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in want[0]]
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]
