"""The 3-d conv-RNN cells of ``gluon.contrib.rnn`` (``Conv3D`` x
``RNN``/``LSTM``/``GRU``) against the JAX package (CPU),
unrolled over 3 steps with the JAX cell's weights
(``torch_cell_compare.py``): outputs and states within 2e-5, the
input's and every weight's gradient within 5e-5 (fp32; a gradient sums
over the steps and the convolution windows in another order)."""
import pytest

from torch_cell_compare import T_STEPS, compare


@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_conv3d_rnn_cells_equal_the_jax_package(kind):
    spatial = (3, 4, 3)
    name = "Conv3D%sCell" % kind

    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, name)(
            input_shape=(2,) + spatial, hidden_channels=3, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1)

    got = compare(make, (2, T_STEPS, 2) + spatial)
    assert got[0][0].shape == (2, T_STEPS, 3) + spatial
