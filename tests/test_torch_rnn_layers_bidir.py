"""The port's fused ``gluon.rnn`` layers (``RNN``, ``LSTM``, ``GRU``)
against the JAX package's (CPU), through ``torch_gluon_compare``: 2
layers, uni- and bidirectional, ``TNC`` and ``NTC``, the input size
deferred to the first call; outputs, states and the gradients of the
input and every parameter within ``rtol=atol=2e-5``.
"""
import pytest

from torch_gluon_compare import compare, randn

T, N, C = 5, 3, 4


@pytest.mark.parametrize("layer,bidir,layout", [
    ("RNN_tanh", True, "NTC"), ("LSTM", True, "NTC"), ("LSTM", True, "TNC"),
    ("GRU", True, "TNC")])
def test_fused_layer_matches_jax(layer, bidir, layout):
    shape = (T, N, C) if layout == "TNC" else (N, T, C)

    def build(pkg):
        r = pkg.gluon.rnn
        kw = dict(num_layers=2, bidirectional=bidir, layout=layout)
        if layer == "RNN_tanh":
            return r.RNN(6, activation="tanh", **kw)
        return getattr(r, layer)(6, **kw)  # input_size deferred

    def fwd(pkg, net, x):
        out, states = net(x, net.begin_state(N))
        d = 2 if bidir else 1
        assert states[0].shape == (2 * d, N, 6)
        assert out.shape == shape[:2] + (6 * d,)
        return [out, states]

    compare(build, fwd, [randn(*shape)])
