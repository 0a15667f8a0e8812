"""The example GPT trained by both packages (CPU).

The JAX classes come from ``example/transformer/train_gpt.py`` (loaded
by file), the port's from ``mxnet_tpu_torch/example/transformer/``; the
model runs at the example's full width (dim 64, 4 heads, SEQ 64, VOCAB
128) at a test depth and batch (1 layer, batch 4), with the JAX weights
carried into the port by ``params_from_jax``. Tolerances, fp32 on the
CPU, where the two packages sum in different orders:

* logits and loss: ``2e-5`` (the port's parity tolerance);
* every parameter's gradient: ``1e-4`` absolute (the backward sums over
  the batch and sequence, 256 rows, so the orders differ more);
* the optimizer alone, fed the same numpy gradient in both packages:
  ``1e-6``, since only its elementwise arithmetic is compared;
* three Adam steps of the whole loop: Adam's first update is about
  ``lr * sign(g)``, so an element whose gradient is within float noise
  of 0 may move by ``2 * lr = 6e-3`` in one package and not the other.
  The post-step weights are compared only where every step's ``|g|`` is
  above ``1e-3`` (ten times the gradient tolerance), at ``1e-4``.
"""
import importlib.util
from pathlib import Path

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.example.transformer import train_gpt as port_gpt

REPO = Path(__file__).resolve().parent.parent
LAYERS, BATCH = 1, 4


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_gpt", REPO / "example" / "transformer" / "train_gpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(n):
    rs = np.random.RandomState(29)
    x, y = port_gpt.make_corpus(BATCH * n, rs)
    pos = np.broadcast_to(np.arange(port_gpt.SEQ, dtype=np.int32),
                          (BATCH, port_gpt.SEQ)).copy()
    return [(x[i::n], y[i::n], pos) for i in range(n)]


def _nets():
    jg = _jax_example()
    jmx.random.seed(7)
    jnet = jg.GPT(layers=LAYERS)
    jnet.initialize(jmx.initializer.Xavier())
    x, _y, pos = _batches(1)[0]
    jnet(jmx.nd.array(x), jmx.nd.array(pos))
    mx.random.seed(7)
    tnet = port_gpt.GPT(layers=LAYERS)
    tnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    gluon.params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()})
    return jnet, tnet


def _step(pkg, net, lossfn, ctx, batch):
    x, y, pos = batch
    with pkg.autograd.record():
        logits = net(pkg.nd.array(x, ctx=ctx), pkg.nd.array(pos, ctx=ctx))
        loss = lossfn(logits, pkg.nd.array(y, ctx=ctx))
    loss.backward()
    grads = [p.grad().asnumpy() for p in net.collect_params().values()]
    return logits.asnumpy(), loss.asnumpy(), grads


def test_make_corpus_is_equal():
    jg = _jax_example()
    for n, seed in ((64, 29), (7, 3)):
        a = jg.make_corpus(n, np.random.RandomState(seed))
        b = port_gpt.make_corpus(n, np.random.RandomState(seed))
        for u, v in zip(a, b):
            assert u.dtype == v.dtype == np.int32
            np.testing.assert_array_equal(u, v)


def test_forward_and_gradients_match_jax():
    jnet, tnet = _nets()
    batch = _batches(1)[0]
    jl, jloss, jg = _step(jmx, jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(
        axis=2), jmx.cpu(), batch)
    tl, tloss, tg = _step(mx, tnet, gluon.loss.SoftmaxCrossEntropyLoss(
        axis=2), mx.cpu(), batch)
    assert tl.shape == (BATCH, port_gpt.SEQ, port_gpt.VOCAB)
    np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tloss, jloss, rtol=2e-5, atol=2e-5)
    assert len(tg) == len(jg) == 2 + 11 * LAYERS + 4
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_three_adam_steps_match_jax():
    jnet, tnet = _nets()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 3e-3})
    ttr = gluon.Trainer(tnet.collect_params(), "adam",
                        {"learning_rate": 3e-3})
    jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss(axis=2)
    tloss = gluon.loss.SoftmaxCrossEntropyLoss(axis=2)
    smallest = None
    for batch in _batches(3):
        _l, jl, jg = _step(jmx, jnet, jloss, jmx.cpu(), batch)
        jtr.step(1)
        _l, tl, _g = _step(mx, tnet, tloss, mx.cpu(), batch)
        ttr.step(1)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        mags = [np.abs(g) for g in jg]
        smallest = mags if smallest is None else \
            [np.minimum(a, b) for a, b in zip(smallest, mags)]
    compared = 0
    for jp, tp, m in zip(jnet.collect_params().values(),
                         tnet.collect_params().values(), smallest):
        keep = m > 1e-3
        compared += int(keep.sum())
        np.testing.assert_allclose(tp.data().asnumpy()[keep],
                                   jp.data().asnumpy()[keep], rtol=0,
                                   atol=1e-4, err_msg=tp.name)
    assert compared > 10000  # most of the 66k weights are compared


def test_adam_update_alone_matches_jax():
    rs = np.random.RandomState(4)
    w0 = rs.randn(8, 16).astype(np.float32)
    jopt = jmx.optimizer.create("adam", learning_rate=3e-3, wd=1e-4)
    topt = mx.optimizer.create("adam", learning_rate=3e-3, wd=1e-4)
    jw, tw = jmx.nd.array(w0), nd.array(w0, ctx=mx.cpu())
    jst, tst = jopt.create_state(0, jw), topt.create_state(0, tw)
    for _ in range(3):
        g = rs.randn(8, 16).astype(np.float32)
        jst = jopt.update(0, jw, jmx.nd.array(g), jst)
        tst = topt.update(0, tw, nd.array(g, ctx=mx.cpu()), tst)
        np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=0,
                                   atol=1e-6)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
