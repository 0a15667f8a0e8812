"""The port's other eight initializers against the JAX package (CPU):
``Constant``, ``Orthogonal`` (uniform and normal draws), ``MSRAPrelu``,
``Bilinear``, ``LSTMBias``, ``FusedRNN``, ``Load`` and ``Mixed`` give the
same values from one seed (exactly: both draw from ``np_rng()`` and do
their arithmetic in numpy), by direct call, through a parameter's
``init`` (the ``__init__`` attribute dispatch that ``LSTMBias`` relies
on) and by ``create`` of the registered name; ``Load`` and ``Mixed``
route and raise as the JAX ones do; the name dispatch covers a fused
RNN's ``parameters``, states and quantization ranges as the JAX
``Initializer.__call__`` does.
"""
import json
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon, initializer as init

CASES = [
    ("constant", lambda m: m.initializer.Constant(2.5), "c_weight", (3, 4)),
    ("orthogonal_uniform", lambda m: m.initializer.Orthogonal(scale=1.2),
     "q_weight", (6, 4)),
    ("orthogonal_normal", lambda m: m.initializer.Orthogonal(
        rand_type="normal"), "q_weight", (4, 2, 3)),
    ("msraprelu", lambda m: m.initializer.MSRAPrelu(slope=0.1),
     "conv_weight", (8, 3, 3, 3)),
    ("msraprelu_in", lambda m: m.initializer.MSRAPrelu("in"), "fc_weight",
     (5, 7)),
    ("bilinear", lambda m: m.initializer.Bilinear(), "up_weight",
     (2, 1, 4, 4)),
    ("bilinear_odd", lambda m: m.initializer.Bilinear(), "up_weight",
     (1, 2, 3, 5)),
    ("lstmbias", lambda m: m.initializer.LSTMBias(forget_bias=2.0),
     "l0_weight", (12,)),
    ("fusedrnn", lambda m: m.initializer.FusedRNN(
        m.initializer.Uniform(0.3), 4, 1, "lstm"), "rnn_weight", (40,)),
    ("fusedrnn_dumps", lambda m: m.initializer.FusedRNN(
        m.initializer.Normal(0.2).dumps(), 4, 2, "gru", True), "rnn_weight",
     (30,)),
]


def _init_both(make, name, shape, seed=3):
    jmx.random.seed(seed)
    jw = jmx.nd.zeros(shape)
    make(jmx)(jmx.initializer.InitDesc(name), jw)
    mx.random.seed(seed)
    with mx.cpu():
        w = mx.nd.zeros(shape)
    make(mx)(init.InitDesc(name), w)
    return w.asnumpy(), jw.asnumpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_values_equal_the_jax_package(case):
    _, make, name, shape = case
    got, want = _init_both(make, name, shape)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_orthogonal_is_orthogonal_and_bilinear_is_separable():
    got, _ = _init_both(lambda m: m.initializer.Orthogonal(scale=1.0),
                        "q_weight", (16, 16))
    np.testing.assert_allclose(got @ got.T, np.eye(16), atol=1e-5)
    got, _ = _init_both(lambda m: m.initializer.Bilinear(), "u_weight",
                        (1, 1, 4, 4))
    k = np.array([0.25, 0.75, 0.75, 0.25], np.float32)
    np.testing.assert_allclose(got[0, 0], np.outer(k, k), rtol=1e-6)


@pytest.mark.parametrize("pname,init_name", [
    ("l0_bias", "LSTMBias"), ("dense0_weight", "Orthogonal"),
    ("conv0_weight", "MSRAPrelu"), ("up0_weight", "Bilinear"),
    ("k_weight", "Constant")])
def test_parameter_init_dispatches_through_the_init_attribute(pname,
                                                              init_name):
    """A parameter's own ``init`` reaches the initializer through the
    ``__init__`` attribute, whatever the name's suffix (LSTMBias on a
    ``bias``, which the suffix would zero)."""
    shape = (8,) if init_name == "LSTMBias" else (4, 2, 3, 3)
    kw = {"Constant": {"value": -1.5}, "LSTMBias": {"forget_bias": 1.0}}
    out = []
    for pkg in (jmx, mx):
        pkg.random.seed(11)
        p = pkg.gluon.Parameter(pname, shape=shape, init=getattr(
            pkg.initializer, init_name)(**kw.get(init_name, {})))
        p.initialize(ctx=pkg.cpu(), default_init=pkg.initializer.Uniform())
        out.append(p.data().asnumpy())
    np.testing.assert_array_equal(out[1], out[0])
    if init_name == "LSTMBias":
        np.testing.assert_array_equal(out[1], [0, 0, 1, 1, 0, 0, 0, 0])


def test_lstmbias_through_initdesc_attrs_as_in_jax():
    """``tests/test_optimizer.py::test_lstmbias``'s case in the port."""
    with mx.cpu():
        b = mx.nd.zeros((8,))
    desc = init.InitDesc("l0_bias", {"__init__": init.LSTMBias(
        forget_bias=1.0).dumps()})
    init.Uniform()(desc, b)
    np.testing.assert_allclose(b.asnumpy(), [0, 0, 1, 1, 0, 0, 0, 0])


@pytest.mark.parametrize("name", ["constant", "orthogonal", "msraprelu",
                                  "bilinear", "lstmbias", "load", "mixed",
                                  "fusedrnn"])
def test_registered_names_and_dumps(name):
    assert name in init._INIT_REGISTRY
    assert init._INIT_REGISTRY[name].__name__ == \
        jmx.initializer._INIT_REGISTRY[name].__name__
    if name in ("constant", "orthogonal", "msraprelu", "lstmbias"):
        a = init.create(name)
        b = jmx.initializer.create(name)
        assert json.loads(a.dumps()) == json.loads(b.dumps())


def test_load_routes_names_strips_tags_and_raises_as_in_jax():
    src = {"arg:p_weight": np.arange(6, dtype=np.float32).reshape(2, 3),
           "aux:bn_moving_mean": np.ones(3, np.float32)}
    outs = []
    for pkg in (jmx, mx):
        pkg.random.seed(5)
        ld = pkg.initializer.Load(src, default_init=pkg.initializer.Uniform(
            0.5))
        with pkg.cpu():
            a, b, c = (pkg.nd.zeros((2, 3)), pkg.nd.zeros((3,)),
                       pkg.nd.zeros((2, 2)))
        ld("p_weight", a)
        ld("bn_moving_mean", b)
        ld("q_weight", c)  # not in the dict: the default initializer
        outs.append([x.asnumpy() for x in (a, b, c)])
        with pytest.raises(Exception, match="Shape mismatch"):
            ld("p_weight", pkg.nd.zeros((3, 2), ctx=pkg.cpu()))
        with pytest.raises(Exception, match="no default initializer"):
            pkg.initializer.Load(src)("r_weight",
                                      pkg.nd.zeros((1,), ctx=pkg.cpu()))
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(outs[1][0], src["arg:p_weight"])


def test_mixed_takes_the_first_match_and_raises_without_one():
    outs = []
    for pkg in (jmx, mx):
        pkg.random.seed(2)
        m = pkg.initializer.Mixed(
            [".*fc2.*", ".*bias", ".*"],
            [pkg.initializer.Constant(1.0), pkg.initializer.Constant(3.0),
             pkg.initializer.Orthogonal()])
        got = []
        for name, shape in (("fc2_weight", (2, 2)), ("fc1_bias", (2,)),
                            ("fc1_weight", (3, 3))):
            arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
            m(pkg.initializer.InitDesc(name), arr)
            got.append(arr.asnumpy())
        outs.append(got)
        with pytest.raises(Exception, match="did not match any pattern"):
            pkg.initializer.Mixed(["a.*"], [pkg.initializer.Zero()])(
                "b_weight", pkg.nd.zeros((1,), ctx=pkg.cpu()))
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)
    # a bias under Constant's weight rule: the name dispatch zeroes it, as
    # in the JAX package
    np.testing.assert_array_equal(outs[1][1], [0.0, 0.0])
    with pytest.raises(MXNetError, match="same length"):
        init.Mixed([".*"], [])


@pytest.mark.parametrize("name,value", [
    ("rnn_parameters", None), ("l0_state", 0.0), ("l0_state_cell", 0.0),
    ("q_min", 0.0), ("q_max", 0.0), ("bn_moving_inv_var", 0.0),
    ("bn_moving_avg", 0.0), ("bn_moving_var", 1.0)])
def test_name_dispatch_covers_the_jax_suffixes(name, value):
    got, want = _init_both(lambda m: m.initializer.Xavier(), name, (6,))
    np.testing.assert_array_equal(got, want)
    if value is not None:
        np.testing.assert_array_equal(got, value)
    else:  # U(-0.07, 0.07) for a fused RNN's vector
        assert np.abs(got).max() <= 0.07 and np.abs(got).max() > 0


def test_unknown_pattern_raises_in_both():
    for pkg in (jmx, mx):
        with pytest.raises(Exception, match="Unknown initialization"):
            pkg.initializer.Uniform()(pkg.initializer.InitDesc("thing"),
                                      pkg.nd.zeros((2,), ctx=pkg.cpu()))


def test_numpy_targets_are_written_in_place():
    a = np.zeros((4, 3), np.float32)
    mx.random.seed(1)
    init.Orthogonal()("w_weight", a)
    b = np.zeros((4, 3), np.float32)
    jmx.random.seed(1)
    jmx.initializer.Orthogonal()("w_weight", b)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() > 0


def test_set_verbosity_logs_each_filled_array(caplog):
    """Quiet by default; with ``verbose`` one line an array, through the
    given ``print_func`` or the root mean square."""
    a = np.full((2, 2), 3.0, np.float32)
    with caplog.at_level(logging.INFO):
        init.Constant(3.0)("c_weight", a)
        assert not caplog.records
        init.Constant(3.0).set_verbosity(True)("c_weight", a)
        init.Constant(2.0).set_verbosity(
            True, print_func=lambda x: float(x.sum()))("d_bias", a)
    assert [r.getMessage() for r in caplog.records] == [
        "Initialized c_weight: 3.0", "Initialized d_bias: 0.0"]


def test_gluon_net_initializes_equal_with_msraprelu_and_orthogonal():
    """A Dense + Conv net initialized by each of the two drawing
    initializers: every parameter equal to the JAX package's."""
    def build(pkg):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Conv2D(4, 3, in_channels=2),
                    pkg.gluon.nn.Dense(5, in_units=36))
        return net

    for make in (lambda m: m.initializer.MSRAPrelu(),
                 lambda m: m.initializer.Orthogonal()):
        jmx.random.seed(9)
        jnet = build(jmx)
        jnet.initialize(make(jmx), ctx=jmx.cpu())
        mx.random.seed(9)
        with mx.cpu():
            net = build(mx)
            net.initialize(make(mx))
        want = [p.data().asnumpy() for p in jnet.collect_params().values()]
        got = [p.data().asnumpy() for p in net.collect_params().values()]
        assert gluon._canonical_names(list(net.collect_params())) == \
            gluon._canonical_names(list(jnet.collect_params()))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
