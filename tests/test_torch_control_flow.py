"""The port's control flow (``nd.contrib``/``sym.contrib`` ``foreach``,
``while_loop``, ``cond``; the ``_foreach``/``_while_loop``/``_cond`` ops)
against the JAX package (CPU), one counterpart a test of
``tests/test_control_flow.py``, on the same numpy inputs:

* eager ``foreach``, ``while_loop`` and ``cond``, forward and backward;
* the symbolic foreach-RNN, forward and backward through the executor;
* the symbolic ``while_loop`` (rows past the last step zero) and ``cond``
  on both branches, with gradients, and a ``cond`` whose untaken branch
  is ``log`` of a non-positive value: its values and gradients are
  ``lax.cond``'s, finite;
* graph JSON equal between the packages, and each package's JSON of a
  control-flow symbol run by the other; shape inference inside a body
  (a FullyConnected's weight free in a ``foreach``) equal to JAX's;
* ``remat=True``: values and gradients equal the stored path's (and the
  JAX op's); on this eager path remat saves no more than the stored
  path on the tanh scan, where the body keeps nothing but its carry,
  and less on a gated body, whose gate values it drops.

fp32 values within ``atol=rtol=2e-5`` unless stated.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, nd, parallel
from mxnet_tpu_torch.ops.registry import get_op

TOL = dict(rtol=2e-5, atol=2e-5)


def _both(build):
    """``build(pkg)`` under a fresh name scope in each package."""
    with jmx.name.NameManager():
        jsym = build(jmx)
    with mx.name.NameManager():
        tsym = build(mx)
    return jsym, tsym


def _run(pkg, sym, values, train=False):
    """Outputs (and with ``train`` every gradient, the heads seeded with
    ones) of ``sym`` bound on the CPU over ``values``."""
    ex = sym.simple_bind(pkg.cpu(), **{k: v.shape for k, v in
                                       values.items()})
    for k, v in values.items():
        ex.arg_dict[k][:] = v
    outs = [o.asnumpy() for o in ex.forward(is_train=train)]
    if not train:
        return outs, None
    ex.backward()
    return outs, {k: g.asnumpy() for k, g in ex.grad_dict.items()
                  if g is not None}


def _agree(jsym, tsym, values, train=False):
    jo, jg = _run(jmx, jsym, values, train)
    to, tg = _run(mx, tsym, values, train)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)
    if train:
        assert sorted(tg) == sorted(jg)
        for k in jg:
            np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)
    return to, tg


# -- eager --------------------------------------------------------------------


def test_eager_foreach_forward():
    x = np.arange(20, dtype=np.float32).reshape(2, 10)
    s = np.ones(10, np.float32)
    res = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            outs, st = pkg.nd.contrib.foreach(
                lambda d, states: (d + states[0], [states[0] * 2]),
                pkg.nd.array(x), [pkg.nd.array(s)])
        res.append((outs.asnumpy(), st[0].asnumpy()))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][1], res[0][1])
    np.testing.assert_array_equal(res[1][0][1], np.arange(10, 20) + 2.0)


def test_eager_foreach_backward_through_states_and_free_vars():
    res = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            data = pkg.nd.array(np.ones((3, 2), np.float32))
            w = pkg.nd.array(np.full(2, 0.5, np.float32))
            s0 = pkg.nd.array(np.zeros(2, np.float32))
            for x in (data, w, s0):
                x.attach_grad()
            with pkg.autograd.record():
                def body(xs, states):
                    h = (xs + states[0]) * w
                    return h, [h]
                outs, _ = pkg.nd.contrib.foreach(body, data, [s0])
                loss = pkg.nd.sum(outs)
            loss.backward()
        res.append([outs.asnumpy(), data.grad.asnumpy(), w.grad.asnumpy(),
                    s0.grad.asnumpy()])
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(res[1][0][:, 0], [0.5, 0.75, 0.875])


def _while_funcs():
    return (lambda i, s: i <= 5,
            lambda i, s: ([i + s], [i + 1, s + i]))


def test_eager_while_loop_reference_example():
    cond, func = _while_funcs()
    res = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            lv = (pkg.nd.array([0], dtype="float32"),
                  pkg.nd.array([1], dtype="float32"))
            outs, st = pkg.nd.contrib.while_loop(cond, func, lv,
                                                 max_iterations=10)
        res.append([outs[0].asnumpy(), st[0].asnumpy(), st[1].asnumpy()])
    for got, want in zip(res[1], res[0]):
        np.testing.assert_array_equal(got, want)
    assert res[1][0].shape == (10, 1)
    np.testing.assert_array_equal(res[1][0][:6, 0], [1, 2, 4, 7, 11, 16])
    np.testing.assert_array_equal(res[1][0][6:], 0.0)


def test_eager_while_loop_requires_max_iterations():
    with mx.cpu():
        with pytest.raises(MXNetError):
            mx.nd.contrib.while_loop(lambda v: v < 1, lambda v: (None, [v]),
                                     [nd.zeros((1,))])
        with pytest.raises(MXNetError):
            mx.nd.contrib.while_loop(lambda v: v < 1, lambda v: (None, [v]),
                                     [], max_iterations=3)
    with pytest.raises(jmx.MXNetError):
        jmx.nd.contrib.while_loop(lambda v: v < 1, lambda v: (None, [v]),
                                  [jmx.nd.zeros((1,))])


def test_eager_cond():
    res = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            a, b = pkg.nd.array([1.0]), pkg.nd.array([2.0])
            a.attach_grad()
            with pkg.autograd.record():
                out = pkg.nd.contrib.cond(a * b < 5,
                                          lambda: (a + 5) * (b + 5),
                                          lambda: (a - 5) * (b - 5))
            out.backward()
            out2 = pkg.nd.contrib.cond(a * b >= 5,
                                       lambda: (a + 5) * (b + 5),
                                       lambda: (a - 5) * (b - 5))
        res.append([out.asnumpy(), a.grad.asnumpy(), out2.asnumpy()])
    for got, want in zip(res[1], res[0]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(res[1][0], [42.0])
    np.testing.assert_array_equal(res[1][2], [12.0])


# -- symbolic -----------------------------------------------------------------


def _rnn_symbol(pkg, remat=False):
    data, h0 = pkg.sym.var("data"), pkg.sym.var("h0")
    wx, wh = pkg.sym.var("wx"), pkg.sym.var("wh")

    def cell(x_t, states):
        h = pkg.sym.tanh(pkg.sym.dot(x_t, wx) + pkg.sym.dot(states[0], wh))
        return h, [h]

    outs, _ = pkg.sym.contrib.foreach(cell, data, [h0], remat=remat)
    return pkg.sym.sum(outs)


def _rnn_values(T=4, B=2, I=3, H=5):
    rng = np.random.RandomState(0)
    return {"data": rng.randn(T, B, I).astype(np.float32),
            "h0": np.zeros((B, H), np.float32),
            "wx": (rng.randn(I, H) * 0.4).astype(np.float32),
            "wh": (rng.randn(H, H) * 0.4).astype(np.float32)}


def test_sym_foreach_rnn_forward_backward():
    jsym, tsym = _both(_rnn_symbol)
    assert tsym.list_arguments() == jsym.list_arguments()
    values = _rnn_values()
    out, grads = _agree(jsym, tsym, values, train=True)
    h, hs = values["h0"], []
    for t in range(4):
        h = np.tanh(values["data"][t] @ values["wx"] + h @ values["wh"])
        hs.append(h)
    np.testing.assert_allclose(float(out[0]), np.sum(hs), rtol=1e-5)
    assert grads["data"].shape == (4, 2, 3)


def _while_symbol(pkg):
    cond, func = _while_funcs()
    i0, s0 = pkg.sym.var("i0"), pkg.sym.var("s0")
    outs, st = pkg.sym.contrib.while_loop(cond, func, [i0, s0],
                                          max_iterations=10)
    return pkg.sym.Group([outs[0], st[0], st[1]])


def test_sym_while_loop():
    jsym, tsym = _both(_while_symbol)
    out, grads = _agree(jsym, tsym, {"i0": np.zeros(1, np.float32),
                                     "s0": np.ones(1, np.float32)},
                        train=True)
    np.testing.assert_array_equal(out[0][:6, 0], [1, 2, 4, 7, 11, 16])
    np.testing.assert_array_equal(out[0][6:], 0.0)
    np.testing.assert_array_equal(out[1], [6])
    np.testing.assert_array_equal(out[2], [16])
    assert sorted(grads) == ["i0", "s0"]


def _cond_symbol(pkg):
    x, y = pkg.sym.var("x"), pkg.sym.var("y")
    return pkg.sym.contrib.cond(pkg.sym.sum(x * y) < 5,
                                lambda: (x + 5) * (y + 5),
                                lambda: (x - 5) * (y - 5))


@pytest.mark.parametrize("x, want, dx", [(1.0, 42.0, 7.0), (3.0, 6.0, -3.0)])
def test_sym_cond_both_branches(x, want, dx):
    jsym, tsym = _both(_cond_symbol)
    out, grads = _agree(jsym, tsym, {"x": np.array([x], np.float32),
                                     "y": np.array([2.0], np.float32)},
                        train=True)
    np.testing.assert_array_equal(out[0], [want])
    np.testing.assert_array_equal(grads["x"], [dx])


def _log_cond_symbol(pkg):
    x = pkg.sym.var("x")
    return pkg.sym.contrib.cond(pkg.sym.sum(x) > 0,
                                lambda: pkg.sym.log(x) * 3,
                                lambda: x * x)


@pytest.mark.parametrize("x", [[-1.0, 0.0], [2.0, 0.5]])
def test_sym_cond_untaken_branch_non_finite(x):
    """pred false: the untaken ``log`` branch is NaN/-inf at x <= 0 and
    its derivative 3/x is infinite at 0; pred true: the untaken branch is
    finite. Values and gradients are lax.cond's on both sides, finite
    where the taken branch is."""
    jsym, tsym = _both(_log_cond_symbol)
    x = np.array(x, np.float32)
    out, grads = _agree(jsym, tsym, {"x": x}, train=True)
    assert np.isfinite(out[0]).all() and np.isfinite(grads["x"]).all()
    if x.sum() <= 0:
        np.testing.assert_array_equal(grads["x"], 2 * x)
    else:
        np.testing.assert_allclose(grads["x"], 3 / x, **TOL)


def _foreach_json_symbol(pkg):
    d, s0, w = pkg.sym.var("d"), pkg.sym.var("s0"), pkg.sym.var("w")

    def body(xx, states):
        h = pkg.sym.broadcast_mul(xx + states[0], w)
        return h, [h]

    outs, states = pkg.sym.contrib.foreach(body, d, [s0])
    return pkg.sym.Group([outs, states[0]])


_JSON_CASES = {
    "foreach": (_foreach_json_symbol,
                {"d": np.ones((3, 4), np.float32),
                 "s0": np.zeros(4, np.float32),
                 "w": np.full(4, 0.5, np.float32)}),
    "while_loop": (_while_symbol, {"i0": np.zeros(1, np.float32),
                                   "s0": np.ones(1, np.float32)}),
    "cond": (_cond_symbol, {"x": np.ones(1, np.float32),
                            "y": np.full(1, 2.0, np.float32)}),
    "foreach_rnn_remat": (lambda pkg: _rnn_symbol(pkg, remat=True),
                          _rnn_values()),
}


@pytest.mark.parametrize("case", sorted(_JSON_CASES))
def test_control_flow_json_roundtrip(case):
    """Each package writes the other's JSON, and loads and runs it: node
    for node the same graph, the same outputs and gradients."""
    build, values = _JSON_CASES[case]
    jsym, tsym = _both(build)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    from_jax = mx.sym.load_json(jsym.tojson())
    from_port = jmx.sym.load_json(tsym.tojson())
    assert from_jax.tojson() == tsym.tojson()
    assert sorted(from_jax.list_arguments()) == \
        sorted(jsym.list_arguments())
    _agree(jsym, from_jax, values, train=True)
    _agree(from_port, tsym, values, train=True)
    if case == "foreach":
        out, _ = _run(mx, from_jax, values)
        np.testing.assert_allclose(out[0][:, 0], [0.5, 0.75, 0.875])


def test_symbol_comparison_operators():
    a, b = mx.sym.var("a"), mx.sym.var("b")
    ja, jb = jmx.sym.var("a"), jmx.sym.var("b")
    pairs = [(a < b, ja < jb), (a <= b, ja <= jb), (a > b, ja > jb),
             (a >= b, ja >= jb), (a == b, ja == jb), (a != b, ja != jb),
             (a < 2.0, ja < 2.0), (a >= 1.0, ja >= 1.0)]
    for tsym, jsym in pairs:
        values = {"a": np.ones(1, np.float32)}
        if "b" in tsym.list_arguments():
            values["b"] = np.full(1, 2.0, np.float32)
        assert [n.op for n in tsym._topo_nodes()] == \
            [n.op for n in jsym._topo_nodes()]
        _agree(jsym, tsym, values)


def _scan_attrs(pkg_op, sub, remat):
    return pkg_op.parse_attrs({
        "__subgraph__": sub, "data_names": ("w_in",),
        "state_names": ("x_in",), "free_names": (), "num_out_data": 0,
        "remat": remat})


def _port_scan(remat, gated, wstack, x0):
    """(gradient, bytes autograd saves) of the port's scan loss."""
    w_sym, x_sym = mx.sym.var("w_in"), mx.sym.var("x_in")
    pre = mx.sym.dot(x_sym, w_sym)
    body = mx.sym.tanh(pre)
    if gated:
        body = body * mx.sym.sigmoid(pre * 0.5)
    op = get_op("_foreach")
    attrs = _scan_attrs(op, mx.sym.Group([body]), remat)
    w = torch.from_numpy(wstack).requires_grad_(True)
    x = torch.from_numpy(x0)

    def grad():
        with autograd.train_mode():
            (final,) = op.fcompute(attrs, w, x)
            return torch.autograd.grad((final * final).mean(), w)[0]

    g, saved = parallel._measure(torch.device("cpu"), grad, [w, x])
    return g.numpy(), saved


def test_foreach_remat_values_and_saved_memory():
    """The JAX test holds XLA's compiled workspace; the port holds what
    remat can drop on an eager path: nothing on the tanh scan (tanh saves
    its output, the next carry; the product saves the carry), the gate
    values on a gated body. Gradients equal the stored path's and JAX's."""
    import jax
    import jax.numpy as jnp

    D, W, B = 8, 16, 32
    rs = np.random.RandomState(0)
    wstack = rs.randn(D, W, W).astype(np.float32) * 0.1
    x0 = rs.randn(B, W).astype(np.float32)

    jop = jmx.ops.registry.get_op("_foreach")
    wj, xj = jmx.sym.var("w_in"), jmx.sym.var("x_in")
    jattrs = _scan_attrs(jop, jmx.sym.Group([jmx.sym.tanh(
        jmx.sym.dot(xj, wj))]), True)

    def jloss(w, x):
        (final,) = jop.fcompute(jattrs, w, x)
        return (final * final).mean()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(wstack),
                                      jnp.asarray(x0)))
    saved = {}
    for gated in (False, True):
        g_stored, saved[gated, False] = _port_scan(False, gated, wstack, x0)
        g_remat, saved[gated, True] = _port_scan(True, gated, wstack, x0)
        np.testing.assert_allclose(g_remat, g_stored, rtol=0, atol=1e-6)
        if not gated:
            np.testing.assert_allclose(g_stored, want, **TOL)
    carry = B * W * 4
    # the D carries after the input (the last one the loss saves)
    assert saved[False, True] <= saved[False, False] == D * carry
    assert saved[True, True] < 0.7 * saved[True, False]


def _fc_rnn_symbol(pkg):
    """A foreach RNN whose weights are FullyConnected's own, free in the
    body: only inference inside the subgraph gives their shapes."""
    data, h0 = pkg.sym.var("data"), pkg.sym.var("h0")

    def cell(x_t, states):
        h = pkg.sym.tanh(
            pkg.sym.FullyConnected(x_t, num_hidden=5, name="i2h")
            + pkg.sym.FullyConnected(states[0], num_hidden=5, name="h2h"))
        return h, [h]

    outs, st = pkg.sym.contrib.foreach(cell, data, [h0])
    return pkg.sym.Group([outs, st[0]])


def test_shape_inference_reaches_into_subgraphs():
    jsym, tsym = _both(_fc_rnn_symbol)
    shapes = dict(data=(4, 2, 3), h0=(2, 5))
    want = jsym.infer_shape(**shapes)
    assert tsym.infer_shape(**shapes) == want
    assert dict(zip(tsym.list_arguments(), want[0]))["i2h_weight"] == (5, 3)
    rs = np.random.RandomState(5)
    values = {n: rs.randn(*s).astype(np.float32) * 0.5
              for n, s in zip(tsym.list_arguments(), want[0])}
    _agree(jsym, tsym, values, train=True)
