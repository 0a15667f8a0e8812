"""The 1-d and 2-d conv-RNN cells of ``gluon.contrib.rnn`` (``Conv1D``/
``2D`` x ``RNN``/``LSTM``/``GRU``; the 3-d ones are in
``test_torch_gluon_contrib_conv3d.py``) against the JAX package (CPU),
unrolled over 3 steps with the JAX cell's weights
(``torch_cell_compare.py``): outputs and states within 2e-5, the
input's and every weight's gradient within 5e-5 (fp32; a gradient sums
over the steps and the convolution windows in another order); the
state shapes and the odd-kernel rule as in the JAX package."""
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from torch_cell_compare import T_STEPS, compare


CONV = [(dims, kind) for dims in (1, 2) for kind in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("dims,kind", CONV,
                         ids=["conv%dd_%s" % c for c in CONV])
def test_conv_rnn_cells_equal_the_jax_package(dims, kind):
    spatial = {1: (6,), 2: (5, 4)}[dims]
    name = "Conv%dD%sCell" % (dims, kind)

    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, name)(
            input_shape=(2,) + spatial, hidden_channels=3, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1)

    got = compare(make, (2, T_STEPS, 2) + spatial)
    assert got[0][0].shape == (2, T_STEPS, 3) + spatial


def test_conv_cell_state_info_and_odd_kernel_rule():
    for pkg in (jmx, mx):
        cell = pkg.gluon.contrib.rnn.Conv2DLSTMCell(
            (3, 8, 6), 4, i2h_kernel=(3, 1), h2h_kernel=(5, 3),
            i2h_dilate=(2, 1))
        assert cell.state_info(2) == [
            {"shape": (2, 4, 4, 6), "__layout__": "NCHW"}] * 2
        with pytest.raises(Exception, match="odd"):
            pkg.gluon.contrib.rnn.Conv1DRNNCell((2, 5), 3, 3, 2)
