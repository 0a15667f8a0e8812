"""The port's Symbol surface against the JAX package (CPU): the same
graph built in both gives the same ``get_internals``, ``get_children``,
``list_inputs``, ``infer_type`` and ``infer_shape_partial``; ``eval``
gives the JAX package's values (fp32 within 2e-5) and no gradient; the
module functions ``zeros``, ``ones``, ``full``, ``arange``, ``eye``,
``maximum``, ``minimum``, ``hypot``, ``histogram`` and ``invoke`` build
the same nodes and values; a variable marked ``_forced_aux`` is an
auxiliary state wherever it is used.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd

TOL = dict(rtol=2e-5, atol=2e-5)


def _net(pkg):
    s = pkg.sym
    x = s.var("x")
    fc = s.FullyConnected(x, num_hidden=3, name="fc")
    bn = s.BatchNorm(fc, name="bn")
    return s.Activation(bn, act_type="relu", name="relu")


@pytest.mark.parametrize("what", ["internals", "children", "inputs",
                                  "arguments", "aux"])
def test_graph_listings_equal_the_jax_package(what):
    got, want = [], []
    for pkg, out in ((jmx, want), (mx, got)):
        net = _net(pkg)
        if what == "internals":
            out.append(net.get_internals().list_outputs())
        elif what == "children":
            out.append(net.get_children().list_outputs())
            assert pkg.sym.var("v").get_children() is None
        elif what == "inputs":
            out.append(net.list_inputs())
        elif what == "arguments":
            out.append(net.list_arguments())
        else:
            out.append(net.list_auxiliary_states())
    assert got == want


def test_internals_are_usable_outputs():
    """An internal output evaluates to the JAX package's value."""
    rng = np.random.RandomState(0)
    vals = {"x": rng.randn(2, 5).astype(np.float32),
            "fc_weight": rng.randn(3, 5).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}
    outs = []
    for pkg in (jmx, mx):
        fc_out = _net(pkg).get_internals()["fc_output"]
        outs.append(fc_out.eval(ctx=pkg.cpu(), **{
            k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in vals.items()}))
    np.testing.assert_allclose(outs[1].asnumpy(), outs[0].asnumpy(), **TOL)


@pytest.mark.parametrize("dtype", [None, np.float16, "float64"])
def test_infer_type_equals_the_jax_package(dtype):
    args = (dtype,) if dtype is not None else ()
    assert _net(mx).infer_type(*args) == _net(jmx).infer_type(*args)


@pytest.mark.parametrize("known", [{}, {"x": (2, 5)}, {"fc_weight": (3, 5)}])
def test_infer_shape_partial_equals_the_jax_package(known):
    got = _net(mx).infer_shape_partial(**known)
    want = _net(jmx).infer_shape_partial(**known)
    assert got == want
    if not known:
        with pytest.raises(MXNetError, match="insufficient"):
            _net(mx).infer_shape()


def test_infer_shape_partial_leaves_a_failing_op_unknown():
    """Shapes that an op refuses give None downstream, where
    ``infer_shape`` raises."""
    for pkg in (jmx, mx):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        c = pkg.sym.elemwise_add(a, b, name="add") * 2
        _, out, _ = c.infer_shape_partial(a=(2, 3), b=(4, 5))
        assert out == [None]
    with pytest.raises(MXNetError):
        c.infer_shape(a=(2, 3), b=(4, 5))


def test_eval_gives_the_jax_values_and_no_gradient():
    rng = np.random.RandomState(1)
    vals = {"x": rng.randn(4, 5).astype(np.float32),
            "fc_weight": rng.randn(3, 5).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32),
            "bn_gamma": rng.rand(3).astype(np.float32) + 0.5,
            "bn_beta": rng.randn(3).astype(np.float32),
            "bn_moving_mean": rng.randn(3).astype(np.float32),
            "bn_moving_var": rng.rand(3).astype(np.float32) + 0.5}
    jargs = {k: jmx.nd.array(v) for k, v in vals.items()}
    want = _net(jmx).eval(ctx=jmx.cpu(), **jargs)
    with jmx.autograd.record():  # train mode: BatchNorm's batch stats
        want_rec = _net(jmx).eval(ctx=jmx.cpu(), **jargs)
    with mx.cpu():
        args = {k: mx.nd.array(v) for k, v in vals.items()}
        for a in args.values():
            a.attach_grad()
        got = _net(mx).eval(**args)
        with autograd.record():
            rec = _net(mx).eval(**args)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    np.testing.assert_allclose(rec.asnumpy(), want_rec.asnumpy(), **TOL)
    assert not rec._in_graph  # eval records nothing, as eval_nd in JAX
    np.testing.assert_array_equal(args["bn_moving_mean"].asnumpy(),
                                  vals["bn_moving_mean"])


CREATION = [
    ("zeros", lambda s: s.zeros((2, 3)), {}),
    ("ones", lambda s: s.ones((3,)), {}),
    ("full", lambda s: s.full((2, 2), 7), {}),
    ("arange", lambda s: s.arange(0, 5, 2), {}),
    ("arange_repeat", lambda s: s.arange(1, 4, repeat=2), {}),
    ("eye", lambda s: s.eye(3, k=1), {}),
    ("eye_rect", lambda s: s.eye(2, 4), {}),
    ("maximum", lambda s: s.maximum(s.var("x"), 0.5), {"x": [0.2, 0.9]}),
    ("maximum_sym", lambda s: s.maximum(s.var("x"), s.var("y")),
     {"x": [0.2, 0.9], "y": [0.5, 0.5]}),
    ("minimum", lambda s: s.minimum(0.5, s.var("x")), {"x": [0.2, 0.9]}),
    ("hypot", lambda s: s.hypot(s.var("x"), s.var("y")),
     {"x": [3.0, 5.0], "y": [4.0, 12.0]}),
    ("histogram", lambda s: s.histogram(s.var("x"), bins=4, range=(0, 1)),
     {"x": list(np.linspace(0, 1, 9))}),
    ("invoke", lambda s: s.invoke("FullyConnected", s.var("x"),
                                  s.var("w"), num_hidden=2, no_bias=True,
                                  name="inv"),
     {"x": [[1.0, 2.0, 3.0]], "w": [[1.0, 0.0, 1.0], [0.5, 0.5, 0.5]]}),
]


@pytest.mark.parametrize("case", CREATION, ids=[c[0] for c in CREATION])
def test_module_functions_build_the_jax_graph(case):
    _, make, inputs = case
    outs = []
    for pkg in (jmx, mx):
        sym = make(pkg.sym)
        js = json.loads(sym.tojson())
        res = sym.eval(ctx=pkg.cpu(), **{
            k: pkg.nd.array(np.asarray(v, np.float32), ctx=pkg.cpu())
            for k, v in inputs.items()})
        res = res if isinstance(res, list) else [res]
        outs.append(([(n["op"], n.get("attrs", {})) for n in js["nodes"]],
                     sym.list_outputs(), [r.asnumpy() for r in res]))
    assert [op for op, _ in outs[1][0]] == [op for op, _ in outs[0][0]]
    assert len(outs[1][1]) == len(outs[0][1])
    for g, w in zip(outs[1][2], outs[0][2]):
        # values, not dtypes: 64-bit results stay 64-bit in the port
        np.testing.assert_allclose(g, w, **TOL)


def test_histogram_needs_a_range():
    with pytest.raises(MXNetError, match="range"):
        mx.sym.histogram(mx.sym.var("x"), bins=3)


def test_forced_aux_marks_a_variable_an_auxiliary_state():
    """A ``grad_req='null'`` parameter of a block trace (``_forced_aux``)
    is aux in either package, wherever it is used."""
    lists = []
    for pkg in (jmx, mx):
        x, w = pkg.sym.var("x"), pkg.sym.var("w")
        w._outputs[0][0]._forced_aux = True
        out = pkg.sym.FullyConnected(x, w, num_hidden=2, no_bias=True,
                                     name="fc")
        lists.append((out.list_arguments(), out.list_auxiliary_states(),
                      out.list_inputs()))
    assert lists[1] == lists[0] == (["x"], ["w"], ["x", "w"])


def test_symbol_names_close_the_gap_but_grad():
    """Every Symbol method of the JAX package is in the port, but
    ``grad`` (ROADMAP queue 1, item 6) and the JAX package's own
    ``eval_jax`` and ``get_backend_symbol``."""
    missing = {n for n in dir(jmx.sym.Symbol) if not n.startswith("__")} \
        - set(dir(mx.sym.Symbol))
    assert missing <= {"eval_jax", "get_backend_symbol", "grad"}
    for name in ("invoke", "zeros", "ones", "full", "arange", "eye",
                 "maximum", "minimum", "hypot", "histogram"):
        assert callable(getattr(mx.sym, name))
