"""``gluon.contrib``'s ``rnn`` and ``data`` against the JAX package
(CPU).

* ``LSTMPCell``, unrolled over 3 steps with the JAX cell's weights
  (``torch_cell_compare.py``): outputs and states within 2e-5, the
  input's and every weight's gradient within 5e-5 (fp32; a gradient sums
  over the steps in another order). The conv-RNN cells are in
  ``test_torch_gluon_contrib_conv.py``.
* ``VariationalDropoutCell`` at ``p = 0`` is its base cell exactly (and
  the JAX one); at ``p = 0.5`` in training its masks are drawn once a
  sequence from the port's generator (not the JAX keys): values 0 or 2,
  about half zero, the same at every step, new after ``reset()``; in
  inference it is the base cell.
* ``IntervalSampler`` and ``CorpusDataset``/``WikiText2`` on a local
  text file give the JAX order, vocabulary and samples; a WikiText file
  that is not there raises.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.gluon import contrib

from torch_cell_compare import T_STEPS, compare


def test_lstmp_cell_equals_the_jax_package():
    got = compare(lambda pkg: pkg.gluon.contrib.rnn.LSTMPCell(6, 3),
                   (4, T_STEPS, 5), seed=1)
    assert got[0][0].shape == (4, T_STEPS, 3)
    assert [s.shape for s in got[0][1:]] == [(4, 3), (4, 6)]


def _vardrop(pkg, p):
    base = pkg.gluon.rnn.LSTMCell(4, input_size=3)
    return pkg.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_inputs=p, drop_states=p, drop_outputs=p)


def test_variational_dropout_at_zero_is_the_base_cell():
    got = compare(lambda pkg: _vardrop(pkg, 0.0), (2, T_STEPS, 3))
    with mx.cpu():
        mx.random.seed(2)
        cell = _vardrop(mx, 0.0)
        cell.initialize()
        x = mx.nd.array(np.random.RandomState(0).randn(2, T_STEPS, 3))
        with autograd.record():
            out, _ = cell.unroll(T_STEPS, x, merge_outputs=True)
        base_out, _ = cell.base_cell.__class__.unroll(
            _Unmodified(cell.base_cell), T_STEPS, x, merge_outputs=True)
    np.testing.assert_array_equal(out.asnumpy(), base_out.asnumpy())
    assert got[0][0].shape == (2, T_STEPS, 4)


class _Unmodified(object):
    """The base cell called as if no modifier wrapped it."""

    def __init__(self, cell):
        self._cell = cell

    def __getattr__(self, name):
        return getattr(self._cell, name)

    def begin_state(self, **kw):
        self._cell._modified = False
        try:
            return self._cell.begin_state(**kw)
        finally:
            self._cell._modified = True

    def __call__(self, *args):
        return self._cell(*args)


def test_variational_dropout_masks():
    with mx.cpu():
        mx.random.seed(4)
        base = gluon.rnn.RNNCell(2000, input_size=2000, activation="relu")
        cell = contrib.rnn.VariationalDropoutCell(base, drop_inputs=0.5)
        cell.initialize(mx.initializer.Zero())
        x = mx.nd.ones((5, T_STEPS, 2000))
        with autograd.record():
            cell.unroll(T_STEPS, x, merge_outputs=True)
        mask = cell.drop_inputs_mask.asnumpy()
        assert set(np.unique(mask)) <= {0.0, 2.0}
        assert abs((mask == 0).mean() - 0.5) < 0.01  # 10,000 draws
        first = mask.copy()
        with autograd.record():  # the same mask at every step of a run
            out, _ = cell.unroll(T_STEPS, x, merge_outputs=True)
        np.testing.assert_array_equal(cell.drop_inputs_mask.asnumpy(),
                                      first * 0 + cell.drop_inputs_mask
                                      .asnumpy())
        cell.reset()
        assert cell.drop_inputs_mask is None
        with autograd.record():
            cell(x[:, 0], cell.begin_state(batch_size=5))
        assert (cell.drop_inputs_mask.asnumpy() != first).any()
        cell.reset()
        # inference: no dropout, the base cell's output
        out, _ = cell.unroll(T_STEPS, x, merge_outputs=True)
        assert cell.drop_inputs_mask.asnumpy().min() == 1.0


def test_variational_dropout_applies_one_mask_a_sequence():
    """Inputs of ones through an identity-like cell: each step's output
    is the same masked pattern."""
    with mx.cpu():
        mx.random.seed(5)
        base = gluon.rnn.RNNCell(6, input_size=6, activation="relu",
                                 i2h_weight_initializer=mx.initializer.Constant(
                                     0.0), h2h_weight_initializer="zeros")
        cell = contrib.rnn.VariationalDropoutCell(base, drop_outputs=0.5)
        cell.initialize()
        base.i2h_bias.set_data(np.ones(6, np.float32))
        with autograd.record():
            out, _ = cell.unroll(4, mx.nd.ones((3, 4, 6)),
                                 merge_outputs=True)
        o = out.asnumpy()
        for t in range(1, 4):
            np.testing.assert_array_equal(o[:, t], o[:, 0])
        assert set(np.unique(o)) <= {0.0, 2.0}


@pytest.mark.parametrize("length,interval,rollover", [
    (10, 3, True), (10, 3, False), (7, 7, True), (9, 1, False)])
def test_interval_sampler_gives_the_jax_order(length, interval, rollover):
    got = contrib.data.IntervalSampler(length, interval, rollover)
    want = jmx.gluon.contrib.data.IntervalSampler(length, interval, rollover)
    assert list(got) == list(want) and len(got) == len(want)


def _corpus(path):
    rng = np.random.RandomState(6)
    words = ["the", "a", "cat", "dog", "sat", "ran", "on", "mat", "far"]
    lines = [" ".join(rng.choice(words, rng.randint(0, 9)))
             for _ in range(30)]
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("kw", [{}, {"seq_len": 5, "bos": "<bos>"},
                                {"seq_len": 7, "eos": None}])
def test_corpus_dataset_equals_the_jax_package(tmp_path, kw):
    f = str(_corpus(tmp_path / "c.txt"))
    kw = dict({"seq_len": 4}, **kw)
    got = contrib.data.text.CorpusDataset(f, **kw)
    want = jmx.gluon.contrib.data.text.CorpusDataset(f, **kw)
    assert got.vocabulary.idx_to_token == want.vocabulary.idx_to_token
    assert len(got) == len(want) > 3
    for i in range(len(got)):
        for g, w in zip(got[i], want[i]):
            assert g.context == mx.cpu()
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    # a shared vocabulary indexes another file the same way
    again = contrib.data.text.CorpusDataset(f, seq_len=3,
                                            vocab=got.vocabulary)
    assert again.vocabulary is got.vocabulary


def test_wikitext_reads_local_files_and_raises_without(tmp_path):
    for pkg in (jmx, mx):
        with pytest.raises(Exception, match="not found"):
            pkg.gluon.contrib.data.text.WikiText2(root=str(tmp_path))
    _corpus(tmp_path / "wiki.valid.tokens")
    got = contrib.data.text.WikiText2(root=str(tmp_path), segment="val")
    want = jmx.gluon.contrib.data.text.WikiText2(root=str(tmp_path),
                                                 segment="val")
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[2][1].asnumpy(), want[2][1].asnumpy())
    with pytest.raises(MXNetError, match="too short"):
        (tmp_path / "tiny.txt").write_text("one\n")
        contrib.data.text.CorpusDataset(str(tmp_path / "tiny.txt"),
                                        seq_len=5)
