"""The port's ``unroll(valid_length=...)`` and ``BidirectionalCell``
against the JAX package's (CPU), through ``torch_gluon_compare``: an
LSTM cell unrolled with per-sample lengths (merging on and off), and a
bidirectional LSTM/GRU pair in ``NTC`` and ``TNC``, with and without
lengths; outputs, states and every gradient within ``rtol=atol=2e-5``.
"""
import numpy as np
import pytest

from torch_gluon_compare import compare, jax_sequence_last  # noqa: F401
from torch_gluon_compare import randn

T, N, C = 5, 3, 4


@pytest.mark.parametrize("merge", [True, False])
def test_unroll_with_valid_length_matches_jax(merge, jax_sequence_last):
    lengths = np.array([2, 5, 3], np.float32)

    def fwd(pkg, net, x):
        vl = pkg.nd.array(lengths, ctx=pkg.cpu())
        return net.unroll(T, x, layout="NTC", merge_outputs=merge,
                          valid_length=vl)

    compare(lambda pkg: pkg.gluon.rnn.LSTMCell(6), fwd, [randn(N, T, C)])


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_bidirectional_cell_matches_jax(layout, with_lengths,
                                        jax_sequence_last):
    shape = (N, T, C) if layout == "NTC" else (T, N, C)

    def build(pkg):
        r = pkg.gluon.rnn
        return r.BidirectionalCell(r.LSTMCell(3), r.GRUCell(3))

    def fwd(pkg, net, x):
        vl = pkg.nd.array([4, 5, 2], ctx=pkg.cpu()) if with_lengths \
            else None
        outs, states = net.unroll(T, x, layout=layout, merge_outputs=True,
                                  valid_length=vl)
        assert outs.shape[2] == 6 and len(states) == 3
        return [outs, states]

    compare(build, fwd, [randn(*shape)])
