"""The port's ``gluon.rnn`` cells against the JAX package's (CPU): the
cell cases of ``tests/test_gluon_rnn.py`` at small widths (hidden 3-8,
T 5, N 3) through ``torch_gluon_compare`` (the JAX net's weights carried
over, outputs, states and every gradient within ``rtol=atol=2e-5``): a
step of each cell, ``unroll`` in ``NTC`` and ``TNC`` with merging on and
off, stacked and modifier cells, zoneout where it is deterministic
(rates 0 and 1); then the LSTM layer against its cell unrolled, and the
layer's own checks (``valid_length`` and bidirectional cells:
``test_torch_rnn_lengths.py``).
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from torch_gluon_compare import TOL, compare, randn

T, N, C = 5, 3, 4


@pytest.mark.parametrize("cell", ["RNNCell", "LSTMCell", "GRUCell"])
def test_cell_step_matches_jax(cell):
    def fwd(pkg, net, x):
        out, states = net(x, net.begin_state(N))
        assert len(states) == (2 if cell == "LSTMCell" else 1)
        return [out] + states

    got = compare(lambda pkg: getattr(pkg.gluon.rnn, cell)(8),
                   fwd, [randn(N, C)])
    assert got[0][0].shape == (N, 8)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("merge", [True, False])
def test_unroll_matches_jax(layout, merge):
    shape = (N, T, C) if layout == "NTC" else (T, N, C)

    def fwd(pkg, net, x):
        outs, states = net.unroll(T, x, layout=layout, merge_outputs=merge)
        assert isinstance(outs, list) != merge
        return [outs, states]

    compare(lambda pkg: pkg.gluon.rnn.GRUCell(5), fwd, [randn(*shape)])


@pytest.mark.parametrize("hybrid", [False, True])
def test_stacked_and_modifier_cells_match_jax(hybrid):
    def build(pkg):
        r = pkg.gluon.rnn
        stack = r.HybridSequentialRNNCell() if hybrid \
            else r.SequentialRNNCell()
        stack.add(r.LSTMCell(C))
        stack.add(r.ResidualCell(r.LSTMCell(C)))
        stack.add(r.DropoutCell(0.3))  # identity in predict mode
        stack.add(r.GRUCell(5))
        return stack

    def fwd(pkg, net, x):
        outs, states = net.unroll(T, x, layout="NTC", merge_outputs=True)
        assert len(states) == 5 and len(net) == 4
        return [outs, states]

    got = compare(build, fwd, [randn(N, T, C)], train=False)
    assert got[0][0].shape == (N, T, 5)


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_zoneout_matches_jax_where_deterministic(rate):
    # rate 0 keeps every new value, rate 1 keeps every old one: both
    # draw nothing that differs between the packages
    def build(pkg):
        return pkg.gluon.rnn.ZoneoutCell(pkg.gluon.rnn.RNNCell(C),
                                         zoneout_outputs=rate,
                                         zoneout_states=rate)

    def fwd(pkg, net, x):
        return net.unroll(T, x, layout="NTC", merge_outputs=True)

    got = compare(build, fwd, [randn(N, T, C)])
    if rate == 1.0:
        np.testing.assert_array_equal(got[0][0], 0.0)


def test_lstm_layer_equals_its_cell_unrolled():
    with mx.cpu():
        layer = mx.gluon.rnn.LSTM(5, layout="TNC", input_size=C)
        layer.initialize()
        x = mx.nd.array(randn(T, N, C))
        out_fused = layer(x).asnumpy()
        cell = mx.gluon.rnn.LSTMCell(5, input_size=C)
        cell.initialize()
        for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            getattr(cell, name).set_data(
                getattr(layer, "l0_" + name).data())
        outs, _ = cell.unroll(T, x, layout="TNC", merge_outputs=False)
    out_cell = np.stack([o.asnumpy() for o in outs])
    np.testing.assert_allclose(out_fused, out_cell, **TOL)


def test_layer_checks_its_states():
    with mx.cpu():
        layer = mx.gluon.rnn.GRU(4, num_layers=2)
        layer.initialize()
        with pytest.raises(ValueError, match="Invalid recurrent state"):
            layer(mx.nd.ones((T, N, C)), mx.nd.zeros((1, N, 4)))
        out, states = layer(mx.nd.ones((T, N, C)), mx.nd.zeros((2, N, 4)))
    assert out.shape == (T, N, 4) and states[0].shape == (2, N, 4)
    assert layer.l0_i2h_weight.shape == (12, C)  # back-filled
    assert sorted(layer.collect_params()) == sorted(
        layer.prefix + "%s%d_%s_%s" % (d, i, g, w) for d in "l"
        for i in range(2) for g in ("i2h", "h2h")
        for w in ("weight", "bias"))


