"""bfloat16 training and the block API of the ResNet slice against the JAX
package (CPU).

The net is a small conv-BN-dense stack, (4, 3, 16, 16) in: its first
BatchNorm reduces 1024 values a channel and its second 256 (a reduction
of 4 values is ill-conditioned between the two packages in fp32 already,
``test_torch_resnet.py``). Weights come from the JAX net
(``params_from_jax``), then both nets are cast to bfloat16.

* ``Block.cast`` makes every parameter bfloat16 with the same bits as the
  JAX cast, BatchNorm's moving statistics included.
* A bfloat16 forward (train and predict mode) and the moving statistics a
  train-mode forward leaves equal the JAX net's within ``BF16_TOL``, in
  bfloat16.
* A bfloat16 ``TrainStep`` step (SGD 0.05 with momentum 0.9) against the
  JAX step from the same weights: the loss (bfloat16) within
  ``NET_TOL``; the weights bfloat16 and the momenta float32 in both; the
  momenta as close to the float32 step as JAX's (see that test for why
  not closer); the weights within one bfloat16 step plus that
  difference. ``InferStep`` in bfloat16 within ``NET_TOL``.
* The float32 promotion where JAX promotes ``lr * g`` is pinned: the
  port's step equals a hand-written float32 update of the same gradient.
* ``hybridize()`` gives the same bits as no ``hybridize()``, ``remat=True``
  equals ``remat=False`` (``tests/test_remat.py:55-89``), and
  ``memory_analysis()`` raises before the first call and reports a
  positive temp after it.
* On a card (``cuda``-marked, skipped here): the captured bfloat16 step
  equals the same step run eagerly within ``BF16_TOL``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd, parallel
from mxnet_tpu_torch.gluon import _canonical_names, nn

# one bfloat16 rounding step (2^-7 relative, as chip_smoke's flash cases)
BF16_TOL = 2.0 ** -7
# through the net: the port's BatchNorm normalises in one cuDNN-style pass
# and rounds once, where XLA rounds after each of its four bfloat16 ops
# (test_bf16_batchnorm_op_against_jax), so the outputs of the layers after
# it differ by a few bfloat16 steps of their largest value: rtol 2^-6 and
# atol 2^-6 of the reference's largest magnitude (4 steps of 2^-8)
NET_TOL = 2.0 ** -6
SGD = {"learning_rate": 0.05, "momentum": 0.9}
BATCH, SIDE, CLASSES = 4, 16, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layers(m):
    return [m.Conv2D(8, 3, padding=1), m.BatchNorm(), m.Activation("relu"),
            m.MaxPool2D(2), m.Conv2D(8, 3, padding=1), m.BatchNorm(),
            m.Activation("relu"), m.Flatten(), m.Dense(CLASSES)]


def _data(k=2, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.rand(k, BATCH, 3, SIDE, SIDE).astype(np.float32)
    ys = rng.randint(0, CLASSES, (k, BATCH))
    return xs, ys


def _jax_net(x, cast=True):
    jmx.random.seed(0)
    net = jnn.HybridSequential()
    with net.name_scope():
        net.add(*_layers(jnn))
    net.initialize()
    net(jmx.nd.array(x))
    if cast:
        net.cast("bfloat16")
    return net


def _port_net(jnet, cast=True):
    with mx.cpu():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(*_layers(nn))
        net.initialize()
        gluon.params_from_jax(net, {k: np.asarray(p.data()._data)
                                    for k, p in jnet.collect_params().items()})
        net(nd.array(np.zeros((1, 3, SIDE, SIDE), np.float32)))
        if cast:
            net.cast("bfloat16")
    return net


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v).astype(np.float32)


def _jbf16(x):
    return jmx.nd.NDArray(jnp.asarray(x, jnp.bfloat16), jmx.cpu())


def _pbf16(x):
    return nd.array(x, ctx=mx.cpu()).astype("bfloat16")


def _by_canonical(names):
    return dict(zip(_canonical_names(list(names)), names))


def _mesh():
    return parallel.device_mesh(1, devices=[mx.cpu()])


def _close(got, want, tol, what, scaled=False):
    """Within ``tol`` relative, and ``tol`` absolute (of ``want``'s largest
    magnitude where ``scaled``)."""
    want = _f32(want)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=atol,
                               err_msg=what)


def test_cast_matches_jax_bits():
    xs, _ = _data(1)
    jnet = _jax_net(xs[0])
    pnet = _port_net(jnet)
    jp, pp = jnet.collect_params(), pnet.collect_params()
    jc, pc = _by_canonical(jp.keys()), _by_canonical(pp.keys())
    assert any(c.endswith("running_var") for c in jc)
    for c in jc:
        assert jp[jc[c]].data()._data.dtype == jnp.bfloat16
        t = pp[pc[c]].data()._data
        assert t.dtype == torch.bfloat16, c
        np.testing.assert_array_equal(_f32(t), _f32(jp[jc[c]].data()._data),
                                      err_msg=c)
    # a trainable parameter's gradient buffer follows its data
    assert pp[pc["hybridsequential0_conv0_weight"]].grad()._data.dtype == \
        torch.bfloat16


@pytest.mark.parametrize("train", [True, False], ids=["train", "predict"])
def test_bf16_forward_matches_jax(train):
    xs, _ = _data(1)
    jnet = _jax_net(xs[0])
    pnet = _port_net(jnet)
    with jmx.autograd.train_mode() if train else jmx.autograd.predict_mode():
        want = jnet(_jbf16(xs[0]))._data
    with mx.cpu(), (autograd.train_mode() if train
                    else autograd.predict_mode()):
        got = pnet(_pbf16(xs[0]))._data
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _close(got, want, NET_TOL, "logits", scaled=True)
    jp, pp = jnet.collect_params(), pnet.collect_params()
    jc, pc = _by_canonical(jp.keys()), _by_canonical(pp.keys())
    for c in jc:
        if c.endswith(("running_mean", "running_var")):
            t = pp[pc[c]].data()._data
            assert t.dtype == torch.bfloat16
            _close(t, jp[jc[c]].data()._data, BF16_TOL, c)


def test_bf16_batchnorm_op_against_jax():
    """The BatchNorm op in bfloat16, train mode: the batch mean and biased
    variance are bfloat16 and equal JAX's bit for bit (``torch.var_mean``
    accumulates in float32 and rounds once, as XLA's reduction does); the
    output is bfloat16 and within two bfloat16 steps of JAX's, which
    rounds after each of its four ops where the port rounds once."""
    from mxnet_tpu import _global
    from mxnet_tpu.ops.registry import get_op as jget_op
    from mxnet_tpu_torch.ops.registry import get_op

    rng = np.random.RandomState(6)
    x = (rng.randn(4, 8, 16, 16) * 2 + 0.5).astype(np.float32)
    g = (rng.rand(8) + 0.5).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    raw = {"fix_gamma": False, "eps": 1e-5}
    stats = (np.zeros(8, np.float32), np.ones(8, np.float32))
    jop = jget_op("BatchNorm")
    prev = _global.set_train(True)
    try:
        want = jop.fcompute(jop.parse_attrs(raw), *[
            jnp.asarray(a, jnp.bfloat16) for a in (x, g, b) + stats])
    finally:
        _global.set_train(prev)
    op = get_op("BatchNorm")
    with autograd.train_mode():
        got = op.fcompute(op.parse_attrs(raw), *[
            torch.from_numpy(a).bfloat16() for a in (x, g, b) + stats])
    for w, t, what in zip(want, got, ("out", "mean", "var")):
        assert w.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16, what
    np.testing.assert_array_equal(_f32(got[1]), _f32(want[1]))
    np.testing.assert_array_equal(_f32(got[2]), _f32(want[2]))
    _close(got[0], want[0], 2 * 2.0 ** -8, "out", scaled=True)


def test_bf16_loss_is_bf16_and_matches_jax():
    rng = np.random.RandomState(4)
    pred = rng.randn(BATCH, CLASSES).astype(np.float32)
    lab = rng.randint(0, CLASSES, (BATCH,))
    want = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
        _jbf16(pred), jmx.nd.array(lab))._data
    with mx.cpu():
        got = gluon.loss.SoftmaxCrossEntropyLoss()(
            _pbf16(pred), nd.array(lab))._data
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL, "loss")


@pytest.fixture(scope="module")
def bf16_step():
    """One bfloat16 step of both packages' TrainStep from the same weights
    and batch, and the JAX package's float32 step from those bfloat16
    values (upcast): by canonical name, each one's loss, weights and
    momenta (numpy copies: the JAX step donates its arrays)."""
    xs, ys = _data(1)
    jnet = _jax_net(xs[0])
    pnet = _port_net(jnet)
    fnet = _jax_net(xs[0], cast=False)
    jc = _by_canonical(jnet.collect_params().keys())
    fc = _by_canonical(fnet.collect_params().keys())
    jp, fp = jnet.collect_params(), fnet.collect_params()
    for c in jc:
        fp[fc[c]].set_data(jmx.nd.array(_f32(jp[jc[c]].data()._data)))
    x16 = jnp.asarray(xs[0], jnp.bfloat16)
    out = {}
    for name, net, x in (("jax", jnet, jmx.nd.NDArray(x16, jmx.cpu())),
                         ("f32", fnet, jmx.nd.array(_f32(x16)))):
        step = jparallel.TrainStep(
            net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            jparallel.device_mesh(1), optimizer_params=dict(SGD))
        loss = np.asarray(step(x, jmx.nd.array(ys[0]))._data)
        names = _by_canonical(net.collect_params().keys())
        out[name] = (loss, {c: np.asarray(step.params[n])
                            for c, n in names.items()},
                     {c: np.asarray(step._opt_states[n])
                      for c, n in names.items()
                      if step._opt_states.get(n) is not None})
    step = parallel.TrainStep(pnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", _mesh(), optimizer_params=dict(SGD))
    with mx.cpu():
        loss = step(_pbf16(xs[0]), nd.array(ys[0]))._data
    names = _by_canonical(step.params.keys())
    states = dict(zip(step._diff, step._states))
    out["port"] = (loss, {c: step.params[n] for c, n in names.items()},
                   {c: states[n] for c, n in names.items() if n in states})
    return out


def test_bf16_trainstep_dtypes_and_loss_match_jax(bf16_step):
    (jl, jw, jm), (pl, pw, pm) = bf16_step["jax"], bf16_step["port"]
    assert jl.dtype == jnp.bfloat16 and pl.dtype == torch.bfloat16
    _close(pl, jl, NET_TOL, "loss")
    assert set(jw) == set(pw) and set(jm) == set(pm)
    assert len(pm) == 10  # weight and bias of 3 layers, gamma and beta of 2
    for c in jw:
        assert jw[c].dtype == jnp.bfloat16 and pw[c].dtype == torch.bfloat16
    for c in jm:
        assert jm[c].dtype == np.float32 and pm[c].dtype == torch.float32


def test_bf16_trainstep_is_as_close_to_float32_as_jax(bf16_step):
    """A bfloat16 gradient through two BatchNorms is noisy in both
    packages, each its own way (a conv bias ahead of a BatchNorm has a
    float32 gradient of 0 and is all noise). So the
    momenta (lr x the gradient) are held to the float32 step: the port's
    at most twice as far from it as the JAX package's, parameter by
    parameter."""
    (_, _, jm), (_, _, pm), (_, _, fm) = (
        bf16_step["jax"], bf16_step["port"], bf16_step["f32"])
    for c in fm:
        ref = fm[c]
        jerr = np.abs(_f32(jm[c]) - ref).max()
        perr = np.abs(_f32(pm[c]) - ref).max()
        assert perr <= 2 * jerr + 1e-7, (c, perr, jerr)


def test_bf16_trainstep_weights_match_jax(bf16_step):
    """The stored bfloat16 weights agree within one bfloat16 step plus the
    two packages' difference in the update (the momentum) itself; the
    moving statistics, outputs of the layers before them, within
    ``NET_TOL``."""
    (_, jw, jm), (_, pw, pm) = bf16_step["jax"], bf16_step["port"]
    for c in jw:
        if c.endswith(("running_mean", "running_var")):
            _close(pw[c], jw[c], NET_TOL, c, scaled=True)
            continue
        slack = float(np.abs(_f32(jm[c]) - _f32(pm[c])).max()) \
            if c in jm else 0.0
        np.testing.assert_allclose(_f32(pw[c]), _f32(jw[c]), rtol=BF16_TOL,
                                   atol=slack + 1e-7, err_msg=c)


def test_bf16_sgd_update_promotes_to_float32():
    """Where JAX computes ``lr * g`` in float32 (lr a float32 array), the
    port's kernel does too: the bfloat16 weight becomes bf16(w + m) with
    m = momentum * m - lr * float32(g), not a bfloat16 product."""
    from mxnet_tpu_torch import optimizer as opt

    rng = np.random.RandomState(2)
    w = torch.from_numpy(rng.randn(64).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(64).astype(np.float32) * 1e-3).bfloat16()
    m = torch.from_numpy(rng.randn(64).astype(np.float32) * 1e-3)
    lr = torch.tensor(0.05)
    want_m = 0.9 * m - lr * g.float()
    want_w = (w.float() + want_m).bfloat16()
    sgd = opt.create("sgd", momentum=0.9)
    ws, ms = [w.clone()], [m.clone()]
    sgd.pure_step(ws, [g], ms, torch.tensor(1.0), lr, [1.0], [0.0])
    assert ws[0].dtype == torch.bfloat16 and ms[0].dtype == torch.float32
    torch.testing.assert_close(ms[0], want_m, rtol=0, atol=0)
    torch.testing.assert_close(ws[0], want_w, rtol=0, atol=0)
    # and JAX's own step gives the same bits on these inputs
    jw, jm = jmx.optimizer.create("sgd", momentum=0.9).pure_step(
        jnp.asarray(_f32(w), jnp.bfloat16), jnp.asarray(_f32(g), jnp.bfloat16),
        jnp.asarray(m.numpy()), jnp.float32(1.0), jnp.float32(0.05), 0.0)
    np.testing.assert_array_equal(_f32(ms[0]), np.asarray(jm))
    np.testing.assert_array_equal(_f32(ws[0]),
                                  _f32(jnp.asarray(jw, jnp.bfloat16)))


def test_bf16_inferstep_matches_jax():
    xs, _ = _data()
    jnet = _jax_net(xs[0])
    pnet = _port_net(jnet)
    want = jparallel.InferStep(jnet, jparallel.device_mesh(1)).multi_call(
        jmx.nd.NDArray(jnp.asarray(xs, jnp.bfloat16), jmx.cpu()))._data
    with mx.cpu():
        got = parallel.InferStep(pnet, _mesh()).multi_call(
            nd.array(xs).astype("bfloat16"))._data
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _close(got, want, NET_TOL, "outputs", scaled=True)


def _trained(hybridize=False, remat=None, steps=2, dtype=None):
    """A net from the JAX weights, trained ``steps`` steps by the eager
    Trainer loop (``remat`` None) or by a TrainStep; its arrays and the
    last loss."""
    xs, ys = _data(steps)
    pnet = _port_net(_jax_net(xs[0], cast=False), cast=False)
    if dtype:
        pnet.cast(dtype)
    if hybridize:
        pnet.hybridize(static_alloc=True, static_shape=True)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.cpu():
        if remat is None:
            tr = gluon.Trainer(pnet.collect_params(), "sgd", dict(SGD))
            for i in range(steps):
                with autograd.record():
                    loss = lossfn(pnet(nd.array(xs[i]).astype(
                        dtype or "float32")), nd.array(ys[i]))
                loss.backward()
                tr.step(BATCH)
            params = {k: p.data()._data.clone()
                      for k, p in pnet.collect_params().items()}
        else:
            step = parallel.TrainStep(pnet, lossfn, "sgd", _mesh(),
                                      optimizer_params=dict(SGD),
                                      remat=remat)
            for i in range(steps):
                loss = step(nd.array(xs[i]), nd.array(ys[i]))
            params = {k: v.detach().clone() for k, v in step.params.items()}
    names = _canonical_names(list(params))
    return dict(zip(names, params.values())), loss._data.detach().clone()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_hybridize_gives_the_same_bits(dtype):
    p0, l0 = _trained(hybridize=False, dtype=dtype)
    p1, l1 = _trained(hybridize=True, dtype=dtype)
    assert torch.equal(l0, l1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_hybridize_records_flags():
    with mx.cpu():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(3))
    net.hybridize(static_alloc=True)
    assert net._active and net._flags["static_alloc"]
    assert net[0]._active
    net.hybridize(False)
    assert not net._active and not net[0]._active


def test_remat_equals_no_remat():
    """``tests/test_remat.py:55-89`` on the conv-BN net: two steps with
    and without remat give the same loss and weights; the moving
    statistics move once a step in both."""
    p0, l0 = _trained(remat=False)
    p1, l1 = _trained(remat=True)
    assert abs(float(l0) - float(l1)) < 1e-6
    for k in p0:
        np.testing.assert_allclose(_f32(p1[k]), _f32(p0[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_memory_analysis():
    xs, ys = _data(2)
    pnet = _port_net(_jax_net(xs[0], cast=False), cast=False)
    with mx.cpu():
        temps = {}
        for remat in (False, True):
            step = parallel.TrainStep(pnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                                      "sgd", _mesh(),
                                      optimizer_params=dict(SGD), remat=remat)
            with pytest.raises(MXNetError, match="run the step once"):
                step.memory_analysis()
            step.multi_call(nd.array(xs), nd.array(ys))
            with pytest.raises(MXNetError, match="run the step once"):
                step.memory_analysis()  # as the JAX step: __call__ only
            step(nd.array(xs[0]), nd.array(ys[0]))
            stats = step.memory_analysis()
            temps[remat] = stats.temp_size_in_bytes
            held = sum(t.numel() * 4 for t in step.params.values())
            assert stats.alias_size_in_bytes >= held
            assert stats.argument_size_in_bytes > stats.alias_size_in_bytes
            assert stats.output_size_in_bytes == \
                stats.alias_size_in_bytes + 4
            assert stats.generated_code_size_in_bytes == 0
    # the activations the backward keeps: the conv and BN outputs at least
    assert temps[False] >= BATCH * 8 * SIDE * SIDE * 4 * 2
    # remat keeps only the step's inputs, which are resident
    assert temps[True] < temps[False]


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_captured_step_matches_eager(cuda_device):
    xs, ys = _data(1)
    jnet = _jax_net(xs[0], cast=False)
    steps = []
    for capture in (True, False):
        net = _port_net(jnet, cast=False)
        for p in net.collect_params().values():
            p.data()._data = p.data()._data.cuda()
        net.cast("bfloat16")
        steps.append(parallel.TrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            parallel.device_mesh(1), optimizer_params=dict(SGD),
            capture=capture))
    x = nd.array(xs[0]).astype("bfloat16")
    losses = [s(x, nd.array(ys[0]))._data for s in steps]
    assert steps[0].compile_count == 1 and steps[0].graph_replays == 1
    _close(losses[0].cpu(), losses[1].cpu(), BF16_TOL, "loss")
    for a, b in zip(steps[0].params.values(), steps[1].params.values()):
        _close(a.cpu(), b.cpu(), BF16_TOL, "weights")
