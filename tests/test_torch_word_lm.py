"""The port's word language model example against the JAX example
(``example/gluon/word_language_model/train.py``), and ``gluon.utils``
(CPU).

The same corpus (``load_corpus``'s synthetic Zipf ids) and the same
weights (the JAX model's, through ``params_from_jax``); then 3 truncated
BPTT steps of the port's ``train_step`` against the JAX example's loop
body (record, backward, ``clip_global_norm`` to ``clip * batch * bptt``,
SGD over the batch's tokens), at vocab 50, emsize = nhid = 16, 2 layers,
bptt 5, batch 4, dropout 0, tied and untied: each step's loss, the
gradient norm ``clip_global_norm`` returns (the clip binds at these
sizes) and every weight after the last step within ``rtol=atol=2e-5``
(fp32). The port's ``main`` runs at a tiny size on the CPU and exits 0.
Then the block rule tied weights need (a block given ``params=`` takes
their prefix: one shared tensor, gradients from both uses summed), and
``gluon.utils``.
"""
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.example.gluon.word_language_model import train as port

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB, WIDTH, LAYERS, BPTT, BATCH, CLIP = 50, 16, 2, 5, 4, 0.25


def _jax_example():
    path = REPO / "example" / "gluon" / "word_language_model" / "train.py"
    spec = importlib.util.spec_from_file_location("jax_word_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_LM = _jax_example()


def _jax_steps(model, data, steps):
    """The JAX example's training loop body (its ``main``), verbatim."""
    trainer = jmx.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 1.0, "momentum": 0,
                                 "wd": 0})
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = model.begin_state(func=jmx.nd.zeros, batch_size=BATCH)
    losses, norms = [], []
    for step in range(steps):
        i = step * BPTT
        seq_len = min(BPTT, data.shape[0] - 1 - i)
        x = data[i:i + seq_len]
        y = data[i + 1:i + 1 + seq_len].reshape((-1,))
        hidden = JAX_LM.detach(hidden)
        with jmx.autograd.record():
            output, hidden = model(x, hidden)
            loss = loss_fn(output, y)
        loss.backward()
        grads = [p.grad() for p in model.collect_params().values()
                 if p.grad_req != "null"]
        norms.append(JAX_LM.clip_global_norm(grads, CLIP * BATCH * BPTT))
        trainer.step(x.shape[0] * x.shape[1])
        losses.append(loss.asnumpy())
    return losses, norms


def _port_steps(model, data, steps):
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": 1.0, "momentum": 0, "wd": 0})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = model.begin_state(func=mx.nd.zeros, batch_size=BATCH)
    losses, norms = [], []
    for step in range(steps):
        x, y = port.get_batch(data, step * BPTT, BPTT)
        loss, hidden, norm = port.train_step(model, trainer, loss_fn, x, y,
                                             hidden, CLIP, BATCH, BPTT)
        losses.append(loss.asnumpy())
        norms.append(norm)
    return losses, norms


@pytest.mark.parametrize("tied", [False, True])
def test_three_steps_match_the_jax_example(tied):
    ids, vocab = port.load_corpus(None, synth_tokens=400, synth_vocab=VOCAB)
    jids, jvocab = JAX_LM.load_corpus(None, synth_tokens=400,
                                      synth_vocab=VOCAB)
    np.testing.assert_array_equal(ids, jids)
    assert vocab == jvocab == VOCAB
    jmodel = JAX_LM.RNNModel(VOCAB, WIDTH, WIDTH, LAYERS, 0.0, tied)
    jmodel.initialize(jmx.initializer.Xavier())
    arrays = {k: p.data().asnumpy()
              for k, p in jmodel.collect_params().items()}
    want_loss, want_norm = _jax_steps(jmodel, JAX_LM.batchify(ids, BATCH), 3)
    with mx.cpu():
        model = port.RNNModel(VOCAB, WIDTH, WIDTH, LAYERS, 0.0, tied)
        model.initialize(mx.initializer.Xavier())
        gluon.params_from_jax(model, arrays)
        got_loss, got_norm = _port_steps(model, port.batchify(ids, BATCH),
                                         3)
    for g, w in zip(got_loss, want_loss):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got_norm, want_norm, **TOL)
    assert max(want_norm) > CLIP * BATCH * BPTT  # the clip scaled one
    want_w = [p.data().asnumpy() for p in jmodel.collect_params().values()]
    got_w = [p.data().asnumpy() for p in model.collect_params().values()]
    assert len(got_w) == len(want_w) == (10 if tied else 11)
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g, w, **TOL)


def test_main_runs_on_the_cpu(capsys):
    rc = port.main(["--device", "cpu", "--epochs", "2", "--nhid", "16",
                    "--emsize", "16", "--synth-tokens", "4000", "--bptt",
                    "10", "--batch-size", "8", "--tied"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "final val ppl" in out and "[epoch 1]" in out


def _tied(pkg):
    class Tied(pkg.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.encoder = pkg.gluon.nn.Embedding(6, 4)
                self.decoder = pkg.gluon.nn.Dense(
                    6, in_units=4, flatten=False,
                    params=self.encoder.params)

        def forward(self, x):
            return self.decoder(self.encoder(x))

    return Tied()


def _tied_grads(pkg, net, ctx):
    x = pkg.nd.array([[1, 4], [0, 5]], ctx=ctx)
    w = pkg.nd.array(np.random.RandomState(3).randn(2, 2, 6), ctx=ctx)
    with pkg.autograd.record():
        loss = (net(x) * w).sum()
    loss.backward()
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()}


def test_tied_weights_share_one_tensor_and_sum_gradients():
    jnet = _tied(jmx)
    jnet.initialize()
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    want = _tied_grads(jmx, jnet, jmx.cpu())
    with mx.cpu():
        net = _tied(mx)
        net.initialize()
        gluon.params_from_jax(net, arrays)
        got = _tied_grads(mx, net, mx.cpu())
    enc, dec = net.encoder, net.decoder
    assert dec.weight is enc.weight  # MXNet's _BlockScope.create
    assert dec.params.prefix == enc.params.prefix
    assert dec.weight.name.endswith("embedding0_weight")
    assert dec.bias.name.endswith("embedding0_bias")
    assert dec.weight.data()._data.data_ptr() == \
        enc.weight.data()._data.data_ptr()
    assert len(got) == len(want) == 2
    for g, w in zip(got.values(), want.values()):
        np.testing.assert_allclose(g, w, **TOL)
    # both uses reach the one gradient: the embedding rows it looked up
    # and the decoder's product, summed
    with mx.cpu():
        x = mx.nd.array([[1, 4], [0, 5]])
        w = mx.nd.array(np.random.RandomState(3).randn(2, 2, 6))
        with mx.autograd.record():
            (net.decoder(net.encoder(x).detach()) * w).sum().backward()
        dec_only = net.encoder.weight.grad().asnumpy()
    weight = enc.weight.data().asnumpy()
    emb_part = np.zeros_like(weight)
    for i, tok in enumerate([1, 4, 0, 5]):
        emb_part[tok] += w.asnumpy().reshape(4, 6)[i] @ weight
    np.testing.assert_allclose(got[enc.weight.name], dec_only + emb_part,
                               rtol=1e-5, atol=1e-5)


def test_clip_global_norm_scales_in_place_as_jax():
    rs = np.random.RandomState(0)
    arrays = [rs.randn(3, 4).astype(np.float32) * 3,
              rs.randn(5).astype(np.float32)]
    with mx.cpu():
        nds = [mx.nd.array(a) for a in arrays]
        ptrs = [a._data.data_ptr() for a in nds]
        norm = gluon.utils.clip_global_norm(nds, 1.0)
    jnds = [jmx.nd.array(a) for a in arrays]
    want = jmx.gluon.utils.clip_global_norm(jnds, 1.0)
    assert isinstance(norm, float)
    np.testing.assert_allclose(norm, want, rtol=1e-6)
    assert [a._data.data_ptr() for a in nds] == ptrs  # the same tensors
    for g, w in zip(nds, jnds):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)
    total = np.sqrt(sum((g.asnumpy() ** 2).sum() for g in nds))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)
    with mx.cpu():  # under the bound nothing changes
        small = [mx.nd.array(np.full((2,), 0.1, np.float32))]
        gluon.utils.clip_global_norm(small, 1.0)
        np.testing.assert_array_equal(small[0].asnumpy(),
                                      np.full((2,), 0.1, np.float32))
        with pytest.warns(UserWarning, match="nan or inf"):
            gluon.utils.clip_global_norm(
                [mx.nd.array(np.array([np.inf], np.float32))], 1.0)
        lazy = gluon.utils.clip_global_norm(
            [mx.nd.array(np.full((4,), 2.0, np.float32))], 1.0,
            check_isfinite=False)
    assert isinstance(lazy, mx.nd.NDArray)
    np.testing.assert_allclose(lazy.asnumpy(), 4.0)


def test_split_and_load_and_split_data_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    with mx.cpu():
        parts = gluon.utils.split_data(mx.nd.array(x), 3)
        uneven = gluon.utils.split_data(mx.nd.array(x), 4, even_split=False)
        loaded = gluon.utils.split_and_load(x, [mx.cpu(), mx.cpu()],
                                            batch_axis=1)
    jparts = jmx.gluon.utils.split_data(jmx.nd.array(x), 3)
    juneven = jmx.gluon.utils.split_data(jmx.nd.array(x), 4,
                                         even_split=False)
    for g, w in zip(parts + uneven, jparts + juneven):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    assert [p.shape for p in loaded] == [(6, 2), (6, 2)]
    assert all(p.context == mx.cpu() for p in loaded)
    with pytest.raises(ValueError, match="evenly split"):
        gluon.utils.split_data(mx.nd.array(x, ctx=mx.cpu()), 4)


def test_check_sha1_and_download_fetch_nothing(tmp_path):
    f = tmp_path / "corpus.txt"
    f.write_bytes(b"the cat sat")
    sha = hashlib.sha1(b"the cat sat").hexdigest()
    assert gluon.utils.check_sha1(str(f), sha)
    assert not gluon.utils.check_sha1(str(f), "0" * 40)
    assert gluon.utils.download("http://host/corpus.txt",
                                path=str(tmp_path), sha1_hash=sha) == str(f)
    with pytest.raises(MXNetError, match="fetches nothing"):
        gluon.utils.download("http://host/ptb.train.txt",
                             path=str(tmp_path))
