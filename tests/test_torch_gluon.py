"""The port's gluon stack against the JAX package (CPU).

* Initialization: after ``mx.random.seed(7)``, ``net.initialize(Xavier())``
  and one forward, the example GPT's weights are bit-identical in both
  packages with nothing carried over: both draw every weight from the
  same host ``RandomState`` in the same order (the embeddings at
  ``initialize``, the deferred Dense weights at the first forward, in call
  order).
* ``params_from_jax`` carries weights over, and raises on a missing name,
  an extra name or a wrong shape.
* ``Trainer`` raises on a stale gradient, as the JAX package does, and
  ``ignore_stale_grad`` skips that parameter instead.
* Block naming, deferred shapes, ``hybridize()`` keeping the output's
  bits, and what is not ported yet raising.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch.example.transformer import train_gpt as port_gpt

REPO = Path(__file__).resolve().parent.parent


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_gpt", REPO / "example" / "transformer" / "train_gpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tokens(batch):
    rs = np.random.RandomState(3)
    x = rs.randint(0, port_gpt.VOCAB, (batch, port_gpt.SEQ)).astype(np.int32)
    pos = np.broadcast_to(np.arange(port_gpt.SEQ, dtype=np.int32),
                          (batch, port_gpt.SEQ)).copy()
    return x, pos


def _init_jax(layers, batch=2):
    jg = _jax_example()
    jmx.random.seed(7)
    net = jg.GPT(layers=layers)
    net.initialize(jmx.initializer.Xavier())
    x, pos = _tokens(batch)
    net(jmx.nd.array(x), jmx.nd.array(pos))
    return net


def _init_port(layers, batch=2):
    mx.random.seed(7)
    net = port_gpt.GPT(layers=layers)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    x, pos = _tokens(batch)
    net(nd.array(x, ctx=mx.cpu()), nd.array(pos, ctx=mx.cpu()))
    return net


def test_xavier_init_is_bit_identical_to_jax():
    jp = _init_jax(layers=2).collect_params()
    tp = _init_port(layers=2).collect_params()
    assert gluon._canonical_names(list(jp.keys())) == \
        gluon._canonical_names(list(tp.keys()))
    assert len(tp) == 2 + 2 * 11 + 2 + 2
    for (jn, jv), (tn, tv) in zip(jp.items(), tp.items()):
        a, b = jv.data().asnumpy(), tv.data().asnumpy()
        assert a.dtype == b.dtype == np.float32, (jn, tn)
        np.testing.assert_array_equal(b, a, err_msg="%s vs %s" % (tn, jn))


def test_params_from_jax_round_trips_and_checks_names():
    jnet = _init_jax(layers=1)
    arrays = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    # a fresh port net, deferred shapes still unknown, takes them all
    mx.random.seed(11)
    net = port_gpt.GPT(layers=1)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    gluon.params_from_jax(net, arrays)
    x, pos = _tokens(2)
    net(nd.array(x, ctx=mx.cpu()), nd.array(pos, ctx=mx.cpu()))
    back = [p.data().asnumpy() for p in net.collect_params().values()]
    for got, want in zip(back, arrays.values()):
        np.testing.assert_array_equal(got, want)

    names = list(arrays)
    with pytest.raises(MXNetError, match="missing"):
        gluon.params_from_jax(net, {k: arrays[k] for k in names[1:]})
    with pytest.raises(MXNetError, match="extra"):
        gluon.params_from_jax(net, dict(arrays, dense99_weight=arrays[
            names[0]]))
    bad = dict(arrays)
    bad[names[0]] = np.zeros((3, 3), np.float32)
    with pytest.raises(MXNetError, match="shape"):
        gluon.params_from_jax(net, bad)


def _one_layer(pkg, ctx):
    pkg.random.seed(5)
    net = pkg.gluon.nn.Dense(4, in_units=3)
    net.initialize(pkg.initializer.Xavier(), ctx=ctx)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    x = pkg.nd.array(np.ones((2, 3), np.float32), ctx=ctx)
    return net, trainer, x


@pytest.mark.parametrize("pkg,ctx", [(jmx, jmx.cpu()), (mx, mx.cpu())],
                         ids=["jax", "port"])
def test_trainer_raises_on_stale_gradient(pkg, ctx):
    net, trainer, x = _one_layer(pkg, ctx)
    with pytest.raises(UserWarning, match="has not been updated"):
        trainer.step(1)  # no backward yet: every gradient is stale
    with pkg.autograd.record():
        y = net(x).sum()
    y.backward()
    trainer.step(1)
    with pytest.raises(UserWarning, match="has not been updated"):
        trainer.step(1)  # the same gradient again
    before = net.weight.data().asnumpy().copy()
    trainer.step(1, ignore_stale_grad=True)  # skips, changes nothing
    np.testing.assert_array_equal(net.weight.data().asnumpy(), before)


def test_sgd_step_matches_jax():
    got = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        net, trainer, x = _one_layer(pkg, ctx)
        for _ in range(2):
            with pkg.autograd.record():
                y = (net(x) * net(x)).sum()
            y.backward()
            trainer.step(2)
        got.append([p.data().asnumpy() for p in
                    net.collect_params().values()])
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_block_names_deferred_shapes_and_not_ported():
    with mx.cpu():
        seq = gluon.nn.HybridSequential(prefix="stack_")
        with seq.name_scope():
            seq.add(gluon.nn.Dense(5, activation="relu"),
                    gluon.nn.Dense(2, use_bias=False))
        assert list(seq.collect_params().keys()) == [
            "stack_dense0_weight", "stack_dense0_bias",
            "stack_dense1_weight"]
        seq.initialize(mx.initializer.Uniform())
        w = seq.collect_params()["stack_dense0_weight"]
        with pytest.raises(gluon.DeferredInitializationError):
            w.data()
        out = seq(nd.array(np.ones((4, 7), np.float32)))
        assert out.shape == (4, 2) and w.shape == (5, 7)
        with autograd.record():
            loss = gluon.loss.L2Loss()(out, nd.zeros((4, 2)))
        assert loss.shape == (4,)
        # hybridize() runs the same eager calls (a whole step is what the
        # port captures), so the output keeps its bits
        seq.hybridize()
        again = seq(nd.array(np.ones((4, 7), np.float32)))
        np.testing.assert_array_equal(again.asnumpy(), out.asnumpy())
        with pytest.raises(MXNetError, match="Cannot find optimizer"):
            gluon.Trainer(seq.collect_params(), "no_such_optimizer")
        with pytest.raises(MXNetError, match="not ported"):
            gluon.Trainer(seq.collect_params(), "sgd", kvstore="dist_sync")


@pytest.mark.parametrize("cls", ["L2Loss", "L1Loss",
                                 "SoftmaxCrossEntropyLoss"])
def test_losses_match_jax(cls):
    rs = np.random.RandomState(9)
    pred = rs.randn(4, 5).astype(np.float32)
    label = rs.randn(4, 5).astype(np.float32) if cls != \
        "SoftmaxCrossEntropyLoss" else rs.randint(0, 5, 4).astype(np.int32)
    outs = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        p = pkg.nd.array(pred, ctx=ctx)
        p.attach_grad()
        with pkg.autograd.record():
            loss = getattr(pkg.gluon.loss, cls)()(p,
                                                  pkg.nd.array(label, ctx=ctx))
        loss.backward()
        outs.append((loss.asnumpy(), p.grad.asnumpy()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-6)
