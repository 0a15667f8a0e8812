"""The ``RNN`` op, for all four modes, uni- and bidirectional, against
the JAX package's (CPU): forward and every input's gradient through
``torch_op_sweep`` (``rtol=atol=2e-5``); and ``state_outputs`` off.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from torch_op_cases import rnn_case
from torch_op_sweep import check


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidir", [False, True])
def test_rnn_op_matches_jax(mode, bidir):
    ins, attrs = rnn_case(mode, bidir)
    check("RNN", ins, attrs, {"grad": True}, "float32")


def test_rnn_op_without_state_outputs_gives_the_output_only():
    ins, attrs = rnn_case("lstm", True)
    with mx.cpu():
        arrs = [mx.nd.array(a) for a in ins]
        full = mx.nd.invoke("RNN", *arrs, **attrs)
        out = mx.nd.invoke("RNN", *arrs, **dict(attrs, state_outputs=False))
    assert len(full) == 3 and isinstance(out, mx.nd.NDArray)
    np.testing.assert_array_equal(out.asnumpy(), full[0].asnumpy())
    assert full[1].shape == full[2].shape == (4, 3, 6)
