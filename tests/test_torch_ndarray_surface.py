"""The port's NDArray surface against the JAX package's (CPU): the
``NDArray`` methods and properties, the module-level ``nd`` functions and
the reference's aliases, the top-level aliases, ``autograd.grad`` and
``get_symbol``. Values at ``rtol=atol=2e-5`` (fp32), integers exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, nd

TOL = dict(rtol=2e-5, atol=2e-5)
X = np.random.RandomState(0).uniform(0.5, 2.0, (2, 3, 4)).astype(np.float32)
M = np.random.RandomState(1).randn(3, 4).astype(np.float32)
IDX = np.array([[2, 0], [1, 3]], np.float32)


def _both(fn):
    """``fn(pkg, ctx)`` in both packages, the results as numpy lists."""
    out = []
    for pkg in (jmx, mx):
        with mx.cpu():
            r = fn(pkg, pkg.cpu())
        rs = r if isinstance(r, (list, tuple)) else [r]
        out.append([np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
                    for v in rs])
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, **TOL)
        else:
            np.testing.assert_array_equal(g, w)


# method -> (input, positional args, keyword args)
_METHODS = {
    "T": (M, None, None),
    "max": (X, (), {"axis": 1}),
    "min": (X, (), {"axis": (0, 2), "keepdims": True}),
    "prod": (X, (), {"axis": 2}),
    "norm": (X, (), {}),
    "norm_ord1": (X, (), {"ord": 1, "axis": 1}),
    "argmax": (X, (), {"axis": 2}),
    "argmin": (X, (), {}),
    "argsort": (M, (), {"is_ascend": False}),
    "sort": (M, (), {"axis": 0}),
    "topk": (M, (), {"k": 2}),
    "topk_value": (M, (), {"k": 2, "ret_typ": "value"}),
    "topk_mask": (M, (), {"k": 2, "ret_typ": "mask", "axis": 0}),
    "topk_both": (M, (), {"k": 3, "ret_typ": "both", "is_ascend": True}),
    "clip": (M, (-0.5, 0.5), {}),
    "dot": (M, (M.T.copy(),), {}),
    "expand_dims": (M, (1,), {}),
    "squeeze": (X[:, :1], (), {}),
    "flatten": (X, (), {}),
    "flip": (M, (1,), {}),
    "pad": (X[None], ("constant", (0, 0, 0, 0, 1, 1, 2, 0)), {}),
    "repeat": (M, (2,), {"axis": 0}),
    "tile": (M, ((2, 1),), {}),
    "slice": (X, ((0, 1), (2, 3)), {}),
    "slice_axis": (X, (2, 1, 3), {}),
    "take": (M, (IDX,), {}),
    "one_hot": (IDX, (4,), {}),
    "reshape_like": (M, (np.zeros((4, 3), np.float32),), {}),
    "broadcast_to": (M[:1], ((3, 4),), {}),
    "broadcast_like": (M[:1], (M,), {}),
    "exp": (M, (), {}),
    "log": (X, (), {}),
    "sqrt": (X, (), {}),
    "tanh": (M, (), {}),
    "sigmoid": (M, (), {}),
    "relu": (M, (), {}),
    "sign": (M, (), {}),
}


@pytest.mark.parametrize("case", sorted(_METHODS))
def test_method_matches_jax(case):
    name = case.split("_")[0] if case.startswith(("norm_", "topk_")) \
        else case
    data, args, kw = _METHODS[case]

    def run(pkg, ctx):
        a = pkg.nd.array(data, ctx=ctx)
        if args is None:
            return getattr(a, name)
        conv = [pkg.nd.array(v, ctx=ctx) if isinstance(v, np.ndarray)
                else v for v in args]
        return getattr(a, name)(*conv, **kw)

    want, got = _both(run)
    _same(got, want)


def test_context_sync_storage_and_dlpack():
    with mx.cpu():
        a = nd.array(M)
    assert a.as_in_context(mx.cpu()) is a and a.as_in_ctx(mx.cpu()) is a
    a.wait_to_read()
    a.wait_to_write()
    assert a.stype == "default" == jmx.nd.array(M).stype
    b = a.tostype("default")
    assert b is not a and np.array_equal(b.asnumpy(), M)
    c = a.tostype("csr")  # sparse storage since slice 18
    assert c.stype == "csr" and np.array_equal(c.asnumpy(), M)
    with pytest.raises(MXNetError, match="unknown stype"):
        a.tostype("dense")
    back = nd.from_dlpack(a.to_dlpack_for_read())
    np.testing.assert_array_equal(back.asnumpy(), M)
    assert back.context == mx.cpu()
    writable = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_write())
    writable[0, 0] = 7.0  # the capsule shares the array's memory
    assert float(a.asnumpy()[0, 0]) == 7.0
    np.testing.assert_array_equal(
        nd.to_dlpack_for_read is not None and
        nd.from_dlpack(nd.to_dlpack_for_read(b)).asnumpy(), M)
    t = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(nd.from_dlpack(t).asnumpy(), t.numpy())


def test_asnumpy_is_a_copy():
    with mx.cpu():
        a = nd.array(M)
    host = a.asnumpy()
    host[0, 0] = 99.0
    assert float(a.asnumpy()[0, 0]) == M[0, 0]


# nd function -> fn(pkg, ctx)
_FUNCS = {
    "full": lambda p, c: p.nd.full((2, 3), 1.5, ctx=c),
    "full_int": lambda p, c: p.nd.full((2,), 4, ctx=c, dtype="int32"),
    "empty": lambda p, c: p.nd.empty((2, 3), ctx=c),
    "arange": lambda p, c: p.nd.arange(1, 4, 0.5, ctx=c),
    "arange_repeat": lambda p, c: p.nd.arange(3, repeat=2, ctx=c),
    "eye": lambda p, c: p.nd.eye(3, 4, 1, ctx=c),
    "concat": lambda p, c: p.nd.concat(p.nd.array(M, ctx=c),
                                       p.nd.array(M, ctx=c), dim=0),
    "stack": lambda p, c: p.nd.stack(p.nd.array(M, ctx=c),
                                     p.nd.array(M, ctx=c), axis=1),
    "concatenate": lambda p, c: p.nd.concatenate(
        [p.nd.array(M, ctx=c), p.nd.array(M, ctx=c)], axis=1),
    "moveaxis": lambda p, c: p.nd.moveaxis(p.nd.array(X, ctx=c), 0, -1),
    "moveaxis_many": lambda p, c: p.nd.moveaxis(p.nd.array(X, ctx=c),
                                                [0, 1], [2, 0]),
    "histogram": lambda p, c: p.nd.histogram(p.nd.array(M, ctx=c), bins=4),
    "histogram_edges": lambda p, c: p.nd.histogram(
        p.nd.array(M, ctx=c), bins=p.nd.array([-1.0, 0.0, 0.5, 2.0],
                                              ctx=c)),
    "onehot_encode": lambda p, c: p.nd.onehot_encode(
        p.nd.array([0, 2, 1], ctx=c), p.nd.zeros((3, 4), ctx=c)),
    "logical_and": lambda p, c: p.nd.logical_and(p.nd.array(M, ctx=c),
                                                 p.nd.array(M > 0, ctx=c)),
    "logical_or": lambda p, c: p.nd.logical_or(p.nd.array(M > 0, ctx=c),
                                               p.nd.array(M < 0.5, ctx=c)),
    "logical_xor": lambda p, c: p.nd.logical_xor(
        p.nd.array(M > 0, ctx=c), p.nd.array(M < 0.5, ctx=c)),
    "modulo": lambda p, c: p.nd.modulo(p.nd.array(M, ctx=c), 0.3),
    "true_divide": lambda p, c: p.nd.true_divide(p.nd.array(M, ctx=c),
                                                 p.nd.array(X[0], ctx=c)),
}
for _alias in ("power", "maximum", "minimum", "equal", "not_equal",
               "greater", "greater_equal", "lesser", "lesser_equal"):
    _FUNCS[_alias] = (lambda name: lambda p, c: getattr(p.nd, name)(
        p.nd.array(X[0], ctx=c), p.nd.array(np.round(X[1]), ctx=c)))(
        _alias)


@pytest.mark.parametrize("name", sorted(_FUNCS))
def test_nd_function_matches_jax(name):
    want, got = _both(_FUNCS[name])
    _same(got, want)


def test_nd_functions_waitall_and_imdecode():
    nd.waitall()
    # JPEG decodes as in the JAX package (PIL's pixels, exactly); a
    # stream of its SOI alone raises
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(1).randint(
        0, 256, (6, 10, 3)).astype(np.uint8)).save(buf, format="JPEG")
    with mx.cpu():
        got = nd.imdecode(buf.getvalue()).asnumpy()
        with pytest.raises(MXNetError, match="JPEG"):
            nd.imdecode(b"\xff\xd8")
    np.testing.assert_array_equal(got,
                                  jmx.nd.imdecode(buf.getvalue()).asnumpy())
    with mx.cpu():
        z = nd.random.uniform(shape=(2,), ctx=mx.cpu())
    assert z.context == mx.cpu()


def test_only_the_jax_packages_own_names_are_missing():
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert public(jmx.nd.NDArray) - public(nd.NDArray) == {"data_jax",
                                                             "astuple"}
    for name in ("full", "empty", "arange", "eye", "concat", "stack",
                 "waitall", "onehot_encode", "concatenate", "moveaxis",
                 "histogram", "logical_and", "logical_or", "logical_xor",
                 "modulo", "true_divide", "from_dlpack", "random",
                 "to_dlpack_for_read", "to_dlpack_for_write", "imdecode"):
        assert hasattr(nd, name), name


def test_top_level_aliases():
    assert mx.mod is mx.module and mx.mod.Module is mx.module.Module
    assert mx.NDArray is nd.NDArray
    assert mx.Symbol is mx.symbol.Symbol and mx.var is mx.symbol.var
    assert mx.AttrScope is mx.attribute.AttrScope
    assert mx.var("x").name == jmx.var("x").name == "x"
    for name in ("get_state", "set_state", "uniform", "normal", "randn",
                 "randint", "exponential", "gamma", "poisson",
                 "negative_binomial", "generalized_negative_binomial",
                 "multinomial", "shuffle"):
        assert callable(getattr(mx.random, name)), name
    with mx.cpu():
        assert mx.random.uniform(shape=(3,)).shape == (3,)


def _grads(pkg, create_graph):
    x = pkg.nd.array([1.0, 2.0, 3.0], ctx=pkg.cpu())
    y = pkg.nd.array([0.5, -1.0, 2.0], ctx=pkg.cpu())
    x.attach_grad()
    y.attach_grad()
    with pkg.autograd.record():
        z = (x * x * x * y).sum()
        gx, gy = pkg.autograd.grad(z, [x, y], create_graph=create_graph)
        second = (gx * gx).sum() if create_graph else None
    if create_graph:
        second.backward()
        return [gx.asnumpy(), gy.asnumpy(), x.grad.asnumpy(),
                y.grad.asnumpy()]
    return [gx.asnumpy(), gy.asnumpy(), x.grad.asnumpy()]


@pytest.mark.parametrize("create_graph", [False, True])
def test_autograd_grad_matches_jax(create_graph):
    want = _grads(jmx, create_graph)
    with mx.cpu():
        got = _grads(mx, create_graph)
    _same(got, want)
    x, y = np.array([1.0, 2.0, 3.0]), np.array([0.5, -1.0, 2.0])
    np.testing.assert_allclose(got[0], 3 * x ** 2 * y, **TOL)
    if create_graph:  # d/dx sum((3 x^2 y)^2) = 36 x^3 y^2
        np.testing.assert_allclose(got[2], 36 * x ** 3 * y ** 2, **TOL)
    else:  # grad() left the .grad buffer alone
        np.testing.assert_array_equal(got[2], 0.0)


def test_autograd_grad_head_grads_and_unreached_variables():
    with mx.cpu():
        x = nd.array([1.0, 2.0])
        u = nd.array([5.0])
        x.attach_grad()
        u.attach_grad()
        with autograd.record():
            z = x * 3.0
        gx, gu = autograd.grad(z, [x, u], head_grads=nd.array([1.0, 2.0]))
    np.testing.assert_allclose(gx.asnumpy(), [3.0, 6.0])
    np.testing.assert_array_equal(gu.asnumpy(), [0.0])
    with pytest.raises(MXNetError, match="not supported"):
        autograd.get_symbol(gx)
    with pytest.raises(Exception):
        jmx.autograd.get_symbol(jmx.nd.array([1.0]))
