"""The port's ResNet zoo and step executors against the JAX package (CPU).

* Parameter names (after ``params_from_jax``'s canonical renumbering) and
  shapes equal the JAX package's for resnet{18,50}_v{1,2}.
* resnet18_v1's forward equals the JAX net's in predict mode at
  (2, 3, 32, 32), and in train mode (where the BatchNorm moving statistics
  move) at (2, 3, 64, 64): at 32 x 32 the last stage's maps are 1 x 1, so
  a train-mode BatchNorm there normalises 2 values, x -> +-sqrt(var /
  (var + eps)), which turns fp32 rounding into differences of 0.05 in the
  logits between the two packages (measured on this CPU); at 64 x 64 it
  normalises 8 values and the packages agree within 2e-5.
* Two ``parallel.TrainStep`` steps at ``bench.py``'s quick shapes
  (resnet18_v1, batch 4, 32x32, 10 classes, SGD 0.05 with momentum 0.9)
  against ``mxnet_tpu.parallel.TrainStep``: each step from the same state
  (the JAX state carried into the port before step 2). The losses and the
  moving statistics (the biased variance of a 4-value reduction at the
  last stage included) agree within 2e-5; the weights and momentum
  within 2e-4, see ``WEIGHT_TOL``.
* ``multi_call`` at K = 2 equals two ``__call__``s, ``copy_to_net``
  round-trips (and leaves the net alone before it), ``InferStep`` equals
  the net's predict-mode forward, a TrainStep step equals the eager
  ``autograd`` + ``Trainer`` step, ``compile_count`` stays flat on
  repeated calls of one shape, ``pretrained=True`` raises, and without a
  card a mesh, step or net that names no device raises.
* On a card (``cuda``-marked, skipped here): a captured step equals the
  same step run eagerly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd, parallel
from mxnet_tpu_torch.gluon import _canonical_names
from mxnet_tpu_torch.gluon.model_zoo import vision

TOL = 2e-5
# The weights and momentum after one SGD step at lr 0.05 hold lr x the
# gradient, and these gradients reach the convolutions through BatchNorm
# reductions of 4 values (batch 4 at the last stage's 1 x 1 maps), which
# amplify fp32 summation-order differences: perturbing the JAX net's own
# initial weights by 1e-6 (relative) moves its weights by 0.05 after two
# steps. From the same state, one step of the two packages differs by at
# most 1.2e-4 in a weight (measured on this CPU); the losses and moving
# statistics stay within TOL.
WEIGHT_TOL = 2e-4
SGD = {"learning_rate": 0.05, "momentum": 0.9}
BATCH, SIDE, CLASSES = 4, 32, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # these small CPU shapes gain nothing from torch's thread pool, and
    # under a parallel test run its spinning threads slow every worker
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(k=2, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.rand(k, BATCH, 3, SIDE, SIDE).astype(np.float32)
    ys = rng.randint(0, CLASSES, (k, BATCH))
    return xs, ys


def _jax_net(x):
    jmx.random.seed(0)
    net = jvision.resnet18_v1(classes=CLASSES)
    net.initialize()
    net(jmx.nd.array(x))  # finishes deferred init; predict mode
    return net


def _port_net(arrays=None):
    with mx.cpu():
        mx.random.seed(0)
        net = vision.resnet18_v1(classes=CLASSES)
        net.initialize()
        if arrays is not None:
            gluon.params_from_jax(net, arrays)
        net(nd.array(np.zeros((1, 3, SIDE, SIDE), np.float32)))
    return net


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _mesh():
    return parallel.device_mesh(1, devices=[mx.cpu()])


def _step(net, **kw):
    return parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", _mesh(), optimizer_params=dict(SGD),
                              **kw)


def _by_canonical(names):
    return dict(zip(_canonical_names(list(names)), names))


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1",
                                  "resnet18_v2", "resnet50_v2"])
def test_param_names_and_shapes_match_jax(name):
    jnet = jvision.get_model(name, classes=CLASSES)
    with mx.cpu():
        pnet = vision.get_model(name, classes=CLASSES)
        pnet.initialize()
    jp, pp = jnet.collect_params(), pnet.collect_params()
    jc, pc = _by_canonical(jp.keys()), _by_canonical(pp.keys())
    assert list(jc) == list(pc)
    # the declared shapes (0 where a dim waits for the first forward)
    for c in jc:
        assert tuple(jp[jc[c]].shape) == tuple(pp[pc[c]].shape), c
    # every deferred dim resolves to a JAX-compatible size
    with mx.cpu():
        pnet(nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    for c in jc:
        want, got = tuple(jp[jc[c]].shape), tuple(pp[pc[c]].shape)
        assert len(want) == len(got)
        assert all(w in (0, g) for w, g in zip(want, got)), (c, want, got)


@pytest.mark.parametrize("train,side", [(True, 64), (False, SIDE)],
                         ids=["train", "predict"])
def test_resnet18_v1_forward_matches_jax(train, side):
    x = np.random.RandomState(3).rand(2, 3, side, side).astype(np.float32)
    jnet = _jax_net(x)
    pnet = _port_net(_arrays(jnet))
    with jmx.autograd.train_mode() if train else jmx.autograd.predict_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu(), (autograd.train_mode() if train
                    else autograd.predict_mode()):
        got = pnet(nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    jstats, pstats = _arrays(jnet), _arrays(pnet)
    jc, pc = _by_canonical(jstats), _by_canonical(pstats)
    moved = 0
    for c in jc:
        np.testing.assert_allclose(pstats[pc[c]], jstats[jc[c]], rtol=TOL,
                                   atol=TOL, err_msg=c)
        if c.endswith("running_var"):
            moved += not np.allclose(pstats[pc[c]], 1.0)
    assert (moved > 0) == train


@pytest.fixture(scope="module")
def two_steps():
    """Two steps of both packages' TrainStep, each from the same state:
    per step the losses and every parameter, momentum state and moving
    statistic of both, by canonical name."""
    xs, ys = _data()
    jnet = _jax_net(xs[0])
    pnet = _port_net(_arrays(jnet))
    jstep = jparallel.TrainStep(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                "sgd", jparallel.device_mesh(1),
                                optimizer_params=dict(SGD))
    pstep = _step(pnet)
    jc = _by_canonical(jnet.collect_params().keys())
    pc = _by_canonical(pnet.collect_params().keys())
    out = []
    for i in range(2):
        jl = float(jstep(jmx.nd.array(xs[i]), jmx.nd.array(ys[i])).asnumpy())
        with mx.cpu():
            pl = float(pstep(nd.array(xs[i]), nd.array(ys[i])).asnumpy())
        pstates = dict(zip(pstep._diff, pstep._states))
        rows = []
        for c in jc:
            jv = np.asarray(jstep.params[jc[c]])
            pv = pstep.params[pc[c]].detach().numpy().copy()
            rows.append((c, jv, pv))
            if pc[c] in pstates:
                rows.append(("momentum:" + c,
                             np.asarray(jstep._opt_states[jc[c]]),
                             pstates[pc[c]].numpy().copy()))
            # the next step starts from the JAX package's state
            with torch.no_grad():
                pstep.params[pc[c]].copy_(torch.from_numpy(jv.copy()))
                if pc[c] in pstates:
                    pstates[pc[c]].copy_(torch.from_numpy(np.array(
                        jstep._opt_states[jc[c]])))
        out.append((jl, pl, rows))
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_trainstep_matches_jax_trainstep(two_steps, i):
    jl, pl, rows = two_steps[i]
    assert abs(jl - pl) <= TOL
    stats = 0
    for name, want, got in rows:
        if name.endswith(("running_mean", "running_var")):
            stats += 1
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_TOL,
                                       err_msg=name)
    assert stats == 2 * 20  # resnet18_v1 has 20 BatchNorm layers
    assert sum(n.startswith("momentum:") for n, _, _ in rows) == 62


def test_running_variance_is_the_biased_one(two_steps):
    # the last stage's BatchNorms reduce over batch x 1 x 1 = 4 values:
    # after step 1 the moving variance is 0.9 + 0.1 * var, and the
    # unbiased variance would put 4/3 of the batch term there
    _jl, _pl, rows = two_steps[0]
    last = [(w, g) for n, w, g in rows
            if "stage3" in n and n.endswith("running_var")]
    assert last
    for want, got in last:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        biased = (got - 0.9) / 0.1
        assert not np.allclose(0.9 + 0.1 * biased * 4 / 3, want,
                               rtol=1e-4, atol=1e-6)


def test_multi_call_equals_two_calls():
    xs, ys = _data()
    a = _step(_port_net())
    b = _step(_port_net())
    with mx.cpu():
        la = [float(a(nd.array(xs[i]), nd.array(ys[i])).asnumpy())
              for i in range(2)]
        lb = b.multi_call(nd.array(xs), nd.array(ys)).asnumpy()
    assert lb.shape == (2,)
    np.testing.assert_array_equal(lb, np.float32(la))
    assert a._t == b._t == 2
    for va, vb in zip(a.params.values(), b.params.values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


def test_copy_to_net_roundtrip():
    xs, ys = _data(1)
    net = _port_net()
    before = _arrays(net)
    step = _step(net)
    with mx.cpu():
        step(nd.array(xs[0]), nd.array(ys[0]))
    for k, v in _arrays(net).items():  # the step trains its own copy
        np.testing.assert_array_equal(v, before[k])
    assert any(not np.array_equal(step.params[k].detach().numpy(), v)
               for k, v in before.items())
    step.copy_to_net()
    for k, v in _arrays(net).items():
        np.testing.assert_array_equal(v, step.params[k].detach().numpy())


def test_trainstep_equals_eager_trainer_step():
    # the same step through autograd.record + backward + Trainer's fused
    # apply, from the same weights
    xs, ys = _data(1)
    net = _port_net()
    step = _step(net)
    with mx.cpu():
        loss = float(step(nd.array(xs[0]), nd.array(ys[0])).asnumpy())
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
        with autograd.record():
            eager = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(nd.array(xs[0])), nd.array(ys[0])).mean()
        eager.backward()
        trainer.step(1)
    assert abs(float(eager.asnumpy()) - loss) <= 1e-6
    for k, p in net.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   step.params[k].detach().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_inferstep_equals_net_forward():
    xs, _ = _data(3)
    net = _port_net()
    with mx.cpu():
        want = np.stack([net(nd.array(x)).asnumpy() for x in xs])
        infer = parallel.InferStep(net, _mesh())
        np.testing.assert_array_equal(infer(nd.array(xs[0])).asnumpy(),
                                      want[0])
        got = infer.multi_call(nd.array(xs)).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert infer.compile_count == 1 and infer.steady_state_recompiles == 0


def test_compile_count_flat_on_repeat_calls():
    xs, ys = _data()
    step = _step(_port_net())
    with mx.cpu():
        for _ in range(3):
            step.multi_call(nd.array(xs), nd.array(ys))
            step(nd.array(xs[0]), nd.array(ys[0]))
        assert step.compile_count == 1
        assert step.steady_state_recompiles == 0
        step(nd.array(xs[0, :2]), nd.array(ys[0, :2]))  # a new shape
    assert step.compile_count == 2
    assert step.steady_state_recompiles == 1


def test_pretrained_and_other_families_raise():
    with pytest.raises(MXNetError, match="pretrained"):
        vision.resnet50_v1(pretrained=True)
    # the other families are ported now: they build, and refuse
    # pretrained weights as the ResNets do
    assert isinstance(vision.get_model("vgg16"), vision.VGG)
    with pytest.raises(MXNetError, match="pretrained"):
        vision.get_model("vgg16", pretrained=True)
    with pytest.raises(MXNetError, match="not supported"):
        vision.get_model("resnet19_v1")
    with pytest.raises(MXNetError, match="not ported"):
        parallel.device_mesh(2, devices=["cpu", "cpu"])
    # remat is ported now: the step is built and keeps its flag
    assert _step(_port_net(), remat=True)._remat
    assert isinstance(vision.get_model("ResNet18_V2"), vision.ResNetV2)


def test_step_executors_need_a_card_unless_asked():
    # no fallback: without a card, a mesh or a step that names no device
    # raises instead of running on the CPU
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is valid")
    with pytest.raises(MXNetError, match="CUDA"):
        parallel.device_mesh()
    net = _port_net()
    with pytest.raises(MXNetError, match="CUDA"):
        parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd")
    with pytest.raises(MXNetError, match="CUDA"):
        parallel.InferStep(net)
    with pytest.raises(MXNetError, match="CUDA"):
        vision.resnet18_v1().initialize()


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_step_equals_eager_step_on_card(cuda_device):
    xs, ys = _data()
    steps = []
    for capture in (True, False):
        with mx.gpu():
            mx.random.seed(0)
            net = vision.resnet18_v1(classes=CLASSES)
            net.initialize()
        steps.append(parallel.TrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            parallel.device_mesh(1), optimizer_params=dict(SGD),
            capture=capture))
    losses = [s.multi_call(nd.array(xs, ctx=mx.gpu()),
                           nd.array(ys, ctx=mx.gpu())).asnumpy()
              for s in steps]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-4)
    assert steps[0].compile_count == 1 and steps[0].graph_replays == 2
    for va, vb in zip(steps[0].params.values(), steps[1].params.values()):
        torch.testing.assert_close(va, vb, rtol=1e-4, atol=1e-4)
