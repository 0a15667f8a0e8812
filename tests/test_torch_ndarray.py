"""The port's NDArray ops and autograd against the JAX package (CPU).

Each op of the training slice runs through both packages' ``invoke`` on
the same numpy inputs (from ``np.random.RandomState`` seeds), inside
``autograd.record()``, with a fixed random weighting of every output as
the head, then ``backward()``: forward values and every input gradient
are compared. Tolerance ``rtol=atol=2e-5`` in fp32: XLA-CPU and torch-CPU
sum and multiply in different orders (the tolerance the port's other
parity tests use). Then the autograd semantics: ``grad_req``
write/add/null across two backward passes, ``out=``, a rebind inside
``record()``, and a head that is itself a leaf.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, nd

TOL = dict(rtol=2e-5, atol=2e-5)


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _i(seed, high, *shape):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int32)


# name -> (op, inputs, attrs); float inputs get gradients, int32 ones not
_CASES = {
    "broadcast_add": ("broadcast_add", [_f(0, 2, 3, 4), _f(1, 1, 3, 1)], {}),
    "broadcast_sub": ("broadcast_sub", [_f(2, 2, 3, 4), _f(3, 2, 1, 4)], {}),
    "broadcast_mul": ("broadcast_mul", [_f(4, 2, 3, 4), _f(5, 4)], {}),
    "broadcast_div": ("broadcast_div",
                      [_f(6, 2, 3), np.abs(_f(7, 2, 3)) + 0.5], {}),
    "elemwise_add": ("elemwise_add", [_f(8, 3, 4), _f(9, 3, 4)], {}),
    "elemwise_sub": ("elemwise_sub", [_f(10, 3, 4), _f(11, 3, 4)], {}),
    "elemwise_mul": ("elemwise_mul", [_f(12, 3, 4), _f(13, 3, 4)], {}),
    "elemwise_div": ("elemwise_div",
                     [_f(14, 3, 4), np.abs(_f(15, 3, 4)) + 0.5], {}),
    "plus_scalar": ("_plus_scalar", [_f(16, 3, 4)], {"scalar": 1.5}),
    "minus_scalar": ("_minus_scalar", [_f(17, 3, 4)], {"scalar": 1.5}),
    "rminus_scalar": ("_rminus_scalar", [_f(18, 3, 4)], {"scalar": 1.5}),
    "mul_scalar": ("_mul_scalar", [_f(19, 3, 4)], {"scalar": -2.5}),
    "div_scalar": ("_div_scalar", [_f(20, 3, 4)], {"scalar": 3.0}),
    "rdiv_scalar": ("_rdiv_scalar", [np.abs(_f(21, 3, 4)) + 0.5],
                    {"scalar": 2.0}),
    "negative": ("negative", [_f(22, 3, 4)], {}),
    "abs": ("abs", [_f(23, 3, 4)], {}),
    "square": ("square", [_f(24, 3, 4)], {}),
    "sum_axis": ("sum", [_f(25, 2, 3, 4)], {"axis": 1}),
    "sum_all_keepdims": ("sum", [_f(26, 2, 3, 4)], {"keepdims": True}),
    "mean_exclude": ("mean", [_f(27, 4, 5, 1)],
                     {"axis": 0, "exclude": True}),
    "mean_axes": ("mean", [_f(28, 2, 3, 4)], {"axis": (0, 2)}),
    "reshape_0_-1": ("Reshape", [_f(29, 2, 5, 12)],
                     {"shape": (0, 0, 4, -1)}),
    "reshape_-2_-3": ("Reshape", [_f(30, 2, 3, 4, 5)],
                      {"shape": (-3, -2)}),
    "reshape_-4": ("Reshape", [_f(31, 6, 4)], {"shape": (-4, 2, -1, 0)}),
    "transpose": ("transpose", [_f(32, 2, 3, 4, 5)], {"axes": (0, 2, 1, 3)}),
    "transpose_reverse": ("transpose", [_f(33, 2, 3, 4)], {}),
    "split": ("SliceChannel", [_f(34, 2, 3, 12)],
              {"num_outputs": 3, "axis": 2}),
    "split_squeeze": ("SliceChannel", [_f(35, 2, 3, 4)],
                      {"num_outputs": 3, "axis": 1, "squeeze_axis": True}),
    "pick_keepdims": ("pick", [_f(36, 2, 5, 7), _i(37, 7, 2, 5)],
                      {"axis": 2, "keepdims": True}),
    "pick_axis1": ("pick", [_f(38, 3, 6), _i(39, 6, 3)], {"axis": 1}),
    "embedding": ("Embedding", [_i(40, 10, 3, 4), _f(41, 10, 6)],
                  {"input_dim": 10, "output_dim": 6}),
    "fc_flatten": ("FullyConnected",
                   [_f(42, 2, 3, 4), _f(43, 5, 12), _f(44, 5)],
                   {"num_hidden": 5}),
    "fc_no_flatten": ("FullyConnected",
                      [_f(45, 2, 3, 4), _f(46, 5, 4), _f(47, 5)],
                      {"num_hidden": 5, "flatten": False}),
    "fc_no_bias": ("FullyConnected", [_f(48, 2, 3, 4), _f(49, 5, 4), None],
                   {"num_hidden": 5, "flatten": False, "no_bias": True}),
    "layernorm": ("LayerNorm", [_f(50, 2, 3, 8), _f(51, 8), _f(52, 8)],
                  {"axis": -1, "eps": 1e-5}),
    "layernorm_axis1": ("LayerNorm", [_f(53, 2, 6, 3), _f(54, 6), _f(55, 6)],
                        {"axis": 1}),
    "relu": ("Activation", [_f(56, 3, 4)], {"act_type": "relu"}),
    "sigmoid": ("Activation", [_f(57, 3, 4)], {"act_type": "sigmoid"}),
    "tanh": ("Activation", [_f(58, 3, 4)], {"act_type": "tanh"}),
    "softrelu": ("Activation", [_f(59, 3, 4)], {"act_type": "softrelu"}),
    "softsign": ("Activation", [_f(60, 3, 4)], {"act_type": "softsign"}),
    "softmax": ("softmax", [_f(61, 2, 3, 7)], {"axis": -1}),
    "log_softmax": ("log_softmax", [_f(62, 2, 7, 3)], {"axis": 1}),
    "flash_attention": ("_contrib_flash_attention",
                        [_f(63, 1, 2, 9, 8), _f(64, 1, 2, 9, 8),
                         _f(65, 1, 2, 9, 8)], {"causal": True}),
}


def _run(pkg, op, inputs, attrs, ctx):
    arrs = [None if a is None else pkg.nd.array(a, ctx=ctx) for a in inputs]
    diff = [a for a, x in zip(arrs, inputs)
            if x is not None and x.dtype == np.float32]
    for a in diff:
        a.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.invoke(op, *arrs, **attrs)
        outs = out if isinstance(out, list) else [out]
        head = None
        for k, o in enumerate(outs):
            w = pkg.nd.array(_f(100 + k, *o.shape), ctx=ctx)
            term = (o * w).sum()
            head = term if head is None else head + term
    head.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in diff]


@pytest.mark.parametrize("case", sorted(_CASES))
def test_op_forward_and_gradients_match_jax(case):
    op, inputs, attrs = _CASES[case]
    want_out, want_grad = _run(jmx, op, inputs, attrs, jmx.cpu())
    got_out, got_grad = _run(mx, op, inputs, attrs, mx.cpu())
    assert len(got_out) == len(want_out) and len(got_grad) == len(want_grad)
    for g, w in zip(got_out + got_grad, want_out + want_grad):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def _two_passes(pkg, ctx, req):
    x = pkg.nd.array(_f(70, 3, 4), ctx=ctx)
    x.attach_grad(grad_req=req)
    for _ in range(2):
        with pkg.autograd.record():
            y = (x * x * 3.0).sum()
        y.backward()
    return x.grad.asnumpy()


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_semantics_match_jax(req):
    got = _two_passes(mx, mx.cpu(), req)
    np.testing.assert_allclose(got, _two_passes(jmx, jmx.cpu(), req), **TOL)
    one = 6.0 * _f(70, 3, 4)
    want = {"write": one, "add": 2 * one, "null": np.zeros_like(one)}[req]
    np.testing.assert_allclose(got, want, **TOL)


def test_out_rebinds_the_target():
    a, b = (nd.array(_f(s, 2, 3), ctx=mx.cpu()) for s in (71, 72))
    c = nd.zeros((2, 3), ctx=mx.cpu())
    r = nd.broadcast_add(a, b, out=c)
    assert r is c
    np.testing.assert_allclose(c.asnumpy(), _f(71, 2, 3) + _f(72, 2, 3),
                               **TOL)
    parts = [nd.zeros((2, 1), ctx=mx.cpu()) for _ in range(3)]
    nd.split(a, num_outputs=3, axis=1, out=parts)
    np.testing.assert_array_equal(parts[2].asnumpy(), a.asnumpy()[:, 2:])


def _rebind(pkg, ctx):
    x = pkg.nd.array(_f(73, 4), ctx=ctx)
    x.attach_grad()
    with pkg.autograd.record():
        y = x * 2.0
        x += 1.0  # rebinds x; y must keep the x it saw
        z = (y * x).sum()
    z.backward()
    return y.asnumpy(), z.asnumpy(), x.grad.asnumpy()


def test_rebind_inside_record_keeps_earlier_inputs():
    for g, w in zip(_rebind(mx, mx.cpu()), _rebind(jmx, jmx.cpu())):
        np.testing.assert_allclose(g, w, **TOL)


def test_leaf_head_and_no_graph():
    x = nd.array(_f(74, 3), ctx=mx.cpu())
    x.attach_grad()
    x.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.ones(3, np.float32))
    with pytest.raises(MXNetError, match="cannot differentiate"):
        nd.array(_f(75, 3), ctx=mx.cpu()).backward()
    # outside record() nothing is taped
    y = x * 2.0
    assert not y._in_graph
    with autograd.pause():
        assert not autograd.is_recording()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.predict_mode():
            assert not autograd.is_training()


def test_backward_reaches_every_leaf_and_only_those():
    # the leaves a head reaches get their gradient and the fresh bit;
    # one it does not reach keeps its buffer and stays stale. Backward
    # learns which is which from torch autograd alone, through a long
    # chain of ops and a custom autograd Function.
    xs = [nd.array(_f(80 + i, 3), ctx=mx.cpu()) for i in range(4)]
    for x in xs:
        x.attach_grad()
    with autograd.record():
        h = xs[0]
        for x in xs[1:3]:  # a chain of many nodes through three leaves
            for _ in range(20):
                h = nd.invoke("Activation", h * x + 0.1, act_type="tanh")
        head = nd.invoke("_contrib_flash_attention",
                         h.reshape((1, 1, 3, 1)), h.reshape((1, 1, 3, 1)),
                         h.reshape((1, 1, 3, 1))).sum()
    head.backward()
    for x in xs[:3]:
        assert x._fresh_grad and np.abs(x.grad.asnumpy()).sum() > 0
    assert not xs[3]._fresh_grad
    np.testing.assert_array_equal(xs[3].grad.asnumpy(), np.zeros(3))


def test_array_dtypes_and_host_copies():
    a = nd.array(np.arange(6, dtype=np.float64).reshape(2, 3), ctx=mx.cpu())
    assert a.dtype == np.float32 and a.shape == (2, 3) and a.size == 6
    i = nd.array(np.arange(4, dtype=np.int32), ctx=mx.cpu())
    assert i.dtype == np.int32 and i.context == mx.cpu()
    b = nd.array([1.5], ctx=mx.cpu(), dtype="bfloat16")
    assert b.asnumpy().dtype == np.float32 and float(b.asscalar()) == 1.5
    assert float((a - 1.0).mean().asscalar()) == pytest.approx(1.5)
    np.testing.assert_array_equal((10.0 - a).asnumpy(), 10.0 - a.asnumpy())


# The integer cases of the scalar ops, the reductions and the comparison
# operators, on the inputs that first showed the port computing with the
# float scalar, widening integer sums and comparing by identity. Integer
# results must match exactly, dtype included; float results at TOL.
_INT_IN = np.array([[5, -3, 7], [2, 9, -4]], np.int32)
_UINT_IN = np.array([[5, 3, 7], [2, 9, 4]], np.uint8)
_SCALAR_CASES = {
    "_plus_scalar": 1.5, "_minus_scalar": 1.5, "_rminus_scalar": 1.5,
    "_mul_scalar": 1.5, "_div_scalar": 2.0, "_rdiv_scalar": 2.0,
    "_mod_scalar": -2.5, "_rmod_scalar": 3.0, "_power_scalar": 1.5,
    "_rpower_scalar": 2.0, "_equal_scalar": 7.0, "_not_equal_scalar": 7.0,
    "_greater_scalar": 2.5, "_greater_equal_scalar": 2.0,
    "_lesser_scalar": 2.5, "_lesser_equal_scalar": 2.0,
}


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
@pytest.mark.parametrize("op", sorted(_SCALAR_CASES))
def test_integer_scalar_op_matches_jax(op, dtype):
    x = _INT_IN if dtype == "int32" else _UINT_IN
    s = _SCALAR_CASES[op]
    if dtype == "uint8" and s < 0:
        s = -s
    want = jmx.nd.invoke(op, jmx.nd.array(x, ctx=jmx.cpu(), dtype=dtype),
                         scalar=s).asnumpy()
    got = nd.invoke(op, nd.array(x, ctx=mx.cpu(), dtype=dtype),
                    scalar=s).asnumpy()
    _same(got, want)


@pytest.mark.parametrize("s", [-1.0, 300.0])
def test_uint8_scalar_out_of_range_raises_as_jax(s):
    with pytest.raises(OverflowError, match="out of bounds for uint8"):
        jmx.nd.invoke("_plus_scalar", jmx.nd.array(
            _UINT_IN, ctx=jmx.cpu(), dtype="uint8"), scalar=s)
    with pytest.raises(OverflowError, match="out of bounds for uint8"):
        nd.invoke("_plus_scalar", nd.array(_UINT_IN, ctx=mx.cpu(),
                                           dtype="uint8"), scalar=s)


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_integer_reduction_matches_jax(op, dtype):
    x = _INT_IN if dtype == "int32" else _UINT_IN
    for axis in (1, None):
        kw = {} if axis is None else {"axis": axis}
        want = getattr(jmx.nd, op)(jmx.nd.array(x, ctx=jmx.cpu(),
                                                dtype=dtype), **kw)
        got = getattr(nd, op)(nd.array(x, ctx=mx.cpu(), dtype=dtype), **kw)
        _same(got.asnumpy(), want.asnumpy())


_OPERATORS = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "mod": lambda a, b: a % b, "pow": lambda a, b: a ** b,
}


@pytest.mark.parametrize("rhs", ["array", "scalar", "reflected"])
@pytest.mark.parametrize("name", sorted(_OPERATORS))
def test_comparison_and_power_operators_match_jax(name, rhs):
    fn = _OPERATORS[name]
    x, y = np.array([1, 2, 3], np.float32), np.array([1, 0, 3], np.float32)

    def run(pkg, ctx):
        a = pkg.nd.array(x, ctx=ctx)
        if rhs == "array":
            return fn(a, pkg.nd.array(y, ctx=ctx)).asnumpy()
        if rhs == "scalar":
            return fn(a, 2).asnumpy()
        if name in ("mod", "pow"):  # __rmod__ / __rpow__
            return fn(7, a).asnumpy()
        return fn(2, a).asnumpy()  # reflected comparison

    _same(run(mx, mx.cpu()), run(jmx, jmx.cpu()))


def test_equality_with_none_and_hash_by_identity():
    a = nd.array([1, 2, 3], ctx=mx.cpu())
    b = nd.array([1, 2, 3], ctx=mx.cpu())
    assert (a == None) is False and (a != None) is True  # noqa: E711
    assert hash(a) == id(a) and len({a, b}) == 2
    np.testing.assert_array_equal((a == b).asnumpy(), [1, 1, 1])
