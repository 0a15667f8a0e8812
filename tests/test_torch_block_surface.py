"""The port's Block/Parameter surface against the JAX package (CPU):
forward hooks and pre-hooks fire in the same order with the same shapes
and stop after ``detach()``; ``apply`` visits the same blocks;
``summary`` prints the same table (parameter totals included);
``Constant`` and ``ParameterDict.get_constant`` hold a fixed value
without a gradient and raise as the JAX ones do; ``reset_ctx`` moves a
parameter's contexts (keeping the value and the NDArray object),
``setattr`` sets an attribute of every parameter, ``Parameter.var``
gives the JAX variable's attributes; ``HybridBlock.infer_shape``
finishes deferred initialization with the JAX shapes and values.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon

TOL = dict(rtol=2e-5, atol=2e-5)


def _mlp(pkg, deferred=True):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu",
                         in_units=0 if deferred else 5),
                nn.BatchNorm(), nn.Dense(3))
    return net


def _x(pkg, seed=0, shape=(4, 5)):
    return pkg.nd.array(np.random.RandomState(seed).randn(*shape).astype(
        np.float32), ctx=pkg.cpu())


def _built(pkg, seed=4):
    pkg.random.seed(seed)
    net = _mlp(pkg)
    net.initialize(pkg.initializer.Xavier(), ctx=pkg.cpu())
    net(_x(pkg))
    return net


def test_hooks_fire_in_the_jax_order_and_detach():
    logs = []
    for pkg in (jmx, mx):
        net = _built(pkg)
        log = []
        handles = []
        for i, blk in enumerate([net] + list(net._children.values())):
            handles.append(blk.register_forward_pre_hook(
                lambda b, inp, i=i: log.append(("pre", i, inp[0].shape))))
            handles.append(blk.register_forward_hook(
                lambda b, inp, out, i=i: log.append(("post", i,
                                                     out.shape))))
        net(_x(pkg, 1))
        for h in handles[::2]:  # the pre-hooks go
            h.detach()
        handles[0].detach()  # detaching twice is a no-op
        net(_x(pkg, 2))
        for h in handles:
            h.detach()
        net(_x(pkg, 3))
        logs.append(log)
    assert logs[1] == logs[0]
    assert len(logs[1]) == 8 + 4


def test_apply_visits_children_first():
    names = []
    for pkg in (jmx, mx):
        seen = []
        net = _mlp(pkg)
        assert net.apply(lambda b: seen.append(type(b).__name__)) is net
        names.append(seen)
    assert names[1] == names[0] == ["Activation", "Dense", "BatchNorm",
                                    "Dense", "HybridSequential"]


def test_summary_prints_the_jax_table(capsys):
    out = []
    for pkg in (jmx, mx):
        net = _built(pkg)
        capsys.readouterr()
        net.summary(_x(pkg))
        out.append(capsys.readouterr().out)
    assert out[1] == out[0]
    total = 5 * 8 + 8 + 4 * 8 + 8 * 3 + 3
    assert "Total params (leaf blocks): %d" % total in out[1]


class _Scaled(object):
    """A block with a Constant scale, in either package."""

    @staticmethod
    def build(pkg, value):
        class Scaled(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.dense = pkg.gluon.nn.Dense(3, in_units=4)
                    self.scale = self.params.get_constant("scale", value)

            def hybrid_forward(self, F, x, scale):
                return F.broadcast_mul(self.dense(x), scale)

        return Scaled()


def test_constant_is_fixed_and_gets_no_gradient():
    value = np.array([[1.0, -2.0, 0.5]], np.float32)
    outs = []
    for pkg in (jmx, mx):
        pkg.random.seed(6)
        net = _Scaled.build(pkg, value)
        net.initialize(ctx=pkg.cpu())
        c = net.scale
        assert isinstance(c, pkg.gluon.Constant)
        assert c.grad_req == "null" and c.shape == (1, 3)
        x = _x(pkg, 0, (2, 4))
        x.attach_grad()
        with pkg.autograd.record():
            y = net(x)
        y.backward()
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        tr.step(1)
        outs.append((y.asnumpy(), x.grad.asnumpy(), c.data().asnumpy()))
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(outs[1][2], value)


def test_get_constant_finds_checks_and_raises():
    for pkg in (jmx, mx):
        pd = pkg.gluon.ParameterDict("blk_")
        c = pd.get_constant("k", [1.0, 2.0])
        assert pd.get_constant("k") is c
        assert pd.get_constant("k", [1.0, 2.0]) is c
        assert list(pd.keys()) == ["blk_k"]
        with pytest.raises(Exception, match="not equal"):
            pd.get_constant("k", [1.0, 3.0])
        with pytest.raises(Exception, match="No constant named"):
            pd.get_constant("nope")
    c = gluon.Constant("c", mx.nd.array([3.0, 4.0], ctx=mx.cpu()))
    c.initialize(ctx=mx.cpu())
    np.testing.assert_array_equal(c.data().asnumpy(), [3.0, 4.0])
    assert c.var().name == "c"


def test_reset_ctx_keeps_value_and_object_and_moves_contexts():
    lists = []
    for pkg in (jmx, mx):
        net = _built(pkg)
        params = net.collect_params()
        before = {k: p.data().asnumpy() for k, p in params.items()}
        params.reset_ctx(pkg.cpu(1))
        lists.append([p.list_ctx() for p in params.values()])
        for k, p in params.items():
            np.testing.assert_array_equal(p.data().asnumpy(), before[k])
            if p.grad_req != "null":
                np.testing.assert_array_equal(p.grad().asnumpy(), 0)
    assert lists[1] == [[mx.cpu(1)]] * len(lists[1])
    # the NDArray object stays; a move to where it is keeps the tensor
    net = _built(mx)
    p = net.collect_params()[list(net.collect_params())[0]]
    arr, ptr = p.data(), p.data()._data.data_ptr()
    p.reset_ctx(mx.cpu())
    assert p.data() is arr and arr._data.data_ptr() == ptr
    p.reset_ctx([mx.cpu(1)])
    assert p.data() is arr and p.list_ctx() == [mx.cpu(1)]
    # it trains after the move
    with mx.cpu(1):
        with autograd.record():
            y = net(_x(mx))
        y.backward()
    assert np.abs(p.grad().asnumpy()).sum() > 0


def test_reset_ctx_of_deferred_and_uninitialized_parameters():
    for pkg in (jmx, mx):
        net = _mlp(pkg)
        net.initialize(ctx=pkg.cpu())
        w = net.collect_params()[list(net.collect_params())[0]]
        w.reset_ctx(pkg.cpu(1))  # deferred: the context is recorded
        assert w.list_ctx() == [pkg.cpu(1)]
        q = pkg.gluon.Parameter("q", shape=(2,))
        with pytest.raises(Exception, match="has not been initialized"):
            q.reset_ctx(pkg.cpu())


@pytest.mark.cuda
def test_reset_ctx_moves_to_the_card_in_place():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    net = _built(mx)
    params = net.collect_params()
    arrs = {k: p.data() for k, p in params.items()}
    before = {k: a.asnumpy() for k, a in arrs.items()}
    params.reset_ctx(mx.gpu(0))
    for k, p in params.items():
        assert p.data() is arrs[k] and arrs[k]._data.is_cuda
        np.testing.assert_array_equal(p.data().asnumpy(), before[k])


def test_setattr_sets_every_parameter():
    for pkg in (jmx, mx):
        params = _built(pkg).collect_params()
        params.setattr("lr_mult", 0.25)
        params.setattr("grad_req", "null")
        assert {p.lr_mult for p in params.values()} == {0.25}
        assert {p.grad_req for p in params.values()} == {"null"}


@pytest.mark.parametrize("kw", [
    {"shape": (2, 3), "lr_mult": 2.0},
    {"shape": (4,), "wd_mult": 0.0, "init": "zeros"},
    {"shape": (3, 0), "dtype": "float16"}])
def test_var_carries_the_jax_attributes(kw):
    kw = dict(kw)
    got = gluon.Parameter("w", **kw).var()
    want = jmx.gluon.Parameter("w", **kw).var()
    assert got.name == want.name == "w"
    assert got.attr_dict() == want.attr_dict()
    p = gluon.Parameter("v", shape=(1,))
    assert p.var() is p.var()


def test_infer_shape_finishes_deferred_init_as_in_jax():
    shapes, values = [], []
    for pkg in (jmx, mx):
        pkg.random.seed(8)
        net = _mlp(pkg)
        net.initialize(pkg.initializer.Xavier(), ctx=pkg.cpu())
        with pytest.raises(Exception):  # deferred until the shapes are known
            net.collect_params()[list(net.collect_params())[0]].data()
        net.infer_shape(_x(pkg, shape=(2, 5)))
        shapes.append([p.shape for p in net.collect_params().values()])
        values.append([p.data().asnumpy()
                       for p in net.collect_params().values()])
        # no moving statistic moved: the pass records nothing
        bn = list(net._children.values())[1]
        np.testing.assert_array_equal(bn.running_mean.data().asnumpy(), 0)
    assert shapes[1] == shapes[0]
    for g, w in zip(values[1], values[0]):
        np.testing.assert_array_equal(g, w)


def test_block_names_close_the_gap():
    """``Block``/``HybridBlock``/``Parameter``/``ParameterDict``/``gluon``
    have every public name of the JAX package's."""
    for j, m in ((jmx.gluon, mx.gluon), (jmx.gluon.Block, mx.gluon.Block),
                 (jmx.gluon.HybridBlock, mx.gluon.HybridBlock),
                 (jmx.gluon.Parameter, mx.gluon.Parameter),
                 (jmx.gluon.ParameterDict, mx.gluon.ParameterDict),
                 (jmx.gluon.contrib, mx.gluon.contrib)):
        missing = {n for n in dir(j) if not n.startswith("_")} - set(dir(m))
        assert missing == set(), (j, missing)
