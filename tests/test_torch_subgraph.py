"""The port's subgraph framework (``subgraph.py``, ``_subgraph_op``)
against the JAX package (CPU), one counterpart a test of
``tests/test_subgraph.py``: the same graph partitioned by the same
property gives node for node the same JSON in both packages (the fused
nodes' counters reset alike), its outputs equal the whole graph's and
JAX's, the backward through ``_subgraph_op`` equals the unpartitioned
graph's, non-convex groups split, and each package loads the other's
partitioned JSON. fp32 within ``atol=rtol=2e-5``.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import subgraph as jsubgraph
from mxnet_tpu_torch import MXNetError, subgraph
from mxnet_tpu_torch.ops.registry import OP_REGISTRY

TOL = dict(rtol=2e-5, atol=2e-5)


def _mlp(pkg):
    data, w1, w2 = (pkg.symbol.var(n) for n in ("data", "w1", "w2"))
    h = pkg.symbol.FullyConnected(data, weight=w1, no_bias=True,
                                  num_hidden=8, name="fc1")
    a = pkg.symbol.Activation(h, act_type="relu", name="act1")
    return pkg.symbol.FullyConnected(a, weight=w2, no_bias=True,
                                     num_hidden=3, name="fc2")


def _values(seed=0):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(4, 5).astype(np.float32),
            "w1": rs.randn(8, 5).astype(np.float32),
            "w2": rs.randn(3, 8).astype(np.float32)}


def _partition(build, prop):
    """(JAX partitioned, port partitioned, JAX whole, port whole), the
    fused nodes numbered from 1 in both packages."""
    jsym, tsym = build(jmx), build(mx)
    jsubgraph.SubgraphProperty._counter = 0
    subgraph.SubgraphProperty._counter = 0
    return (jsubgraph.partition_graph(jsym, prop),
            subgraph.partition_graph(tsym, prop), jsym, tsym)


def _run(pkg, sym, values, train=False):
    ex = sym.simple_bind(pkg.cpu(), grad_req="write",
                         **{k: v.shape for k, v in values.items()})
    ex.copy_params_from({k: pkg.nd.array(v, ctx=pkg.cpu())
                         for k, v in values.items()})
    outs = [o.asnumpy() for o in ex.forward(is_train=train)]
    grads = None
    if train:
        ex.backward(out_grads=pkg.nd.ones(outs[0].shape, ctx=pkg.cpu()))
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
    return outs, grads


def _ops(sym):
    return [n.op for n in sym._topo_nodes() if not n.is_var()]


def _same_graph(jpart, tpart):
    assert json.loads(tpart.tojson()) == json.loads(jpart.tojson())


def test_partition_fuses_whitelisted_ops():
    jpart, tpart, _, tsym = _partition(_mlp, ["FullyConnected",
                                              "Activation"])
    assert _ops(tpart) == ["_subgraph_op"]
    _same_graph(jpart, tpart)
    values = _values()
    want = _run(jmx, jpart, values)[0][0]
    np.testing.assert_allclose(_run(mx, tpart, values)[0][0], want, **TOL)
    np.testing.assert_allclose(_run(mx, tsym, values)[0][0], want, **TOL)


def test_partition_partial_whitelist():
    jpart, tpart, _, _ = _partition(_mlp, ["FullyConnected"])
    ops = _ops(tpart)
    assert ops.count("_subgraph_op") == 2 and "Activation" in ops
    _same_graph(jpart, tpart)
    values = _values(1)
    np.testing.assert_allclose(_run(mx, tpart, values)[0][0],
                               _run(jmx, jpart, values)[0][0], **TOL)


def _nonconvex(pkg):
    x = pkg.symbol.var("x")
    e = pkg.symbol.exp(x, name="e")
    u = pkg.symbol.negative(e, name="u")
    return pkg.symbol.elemwise_add(e, u, name="add")


def test_partition_nonconvex_split():
    jpart, tpart, _, _ = _partition(_nonconvex, ["exp", "elemwise_add"])
    ops = _ops(tpart)
    assert ops.count("_subgraph_op") == 2 and "negative" in ops
    _same_graph(jpart, tpart)
    values = {"x": np.random.RandomState(2).randn(3, 3).astype(np.float32)}
    out = _run(mx, tpart, values)[0][0]
    np.testing.assert_allclose(out, _run(jmx, jpart, values)[0][0], **TOL)
    np.testing.assert_allclose(out, np.zeros((3, 3), np.float32), atol=1e-5)


def test_partitioned_json_roundtrip():
    """Each package loads and runs its own partitioned JSON and the
    other's."""
    jpart, tpart, _, _ = _partition(_mlp, ["FullyConnected", "Activation"])
    values = _values(3)
    want = _run(jmx, jpart, values)[0][0]
    for loaded in (mx.sym.load_json(tpart.tojson()),
                   mx.sym.load_json(jpart.tojson())):
        assert loaded.tojson() == tpart.tojson()
        np.testing.assert_allclose(_run(mx, loaded, values)[0][0], want,
                                   **TOL)
    np.testing.assert_allclose(
        _run(jmx, jmx.sym.load_json(tpart.tojson()), values)[0][0], want,
        **TOL)


def test_partitioned_backward_matches():
    jpart, tpart, jsym, tsym = _partition(_mlp, ["FullyConnected",
                                                 "Activation"])
    values = _values(4)
    _, whole = _run(mx, tsym, values, train=True)
    out, part = _run(mx, tpart, values, train=True)
    jout, jgrads = _run(jmx, jpart, values, train=True)
    np.testing.assert_allclose(out[0], jout[0], **TOL)
    assert sorted(part) == sorted(whole) == sorted(jgrads)
    for k in whole:
        np.testing.assert_array_equal(part[k], whole[k], err_msg=k)
        np.testing.assert_allclose(part[k], jgrads[k], err_msg=k, **TOL)


def test_get_backend_symbol():
    prop = ["FullyConnected", "Activation"]
    jsubgraph.register_subgraph_property(
        "fuse_fc", jsubgraph.DefaultSubgraphProperty(prop))
    subgraph.register_subgraph_property(
        "fuse_fc", subgraph.DefaultSubgraphProperty(prop))
    jsubgraph.SubgraphProperty._counter = 0
    subgraph.SubgraphProperty._counter = 0
    jpart = _mlp(jmx).get_backend_symbol("fuse_fc")
    tpart = _mlp(mx).get_backend_symbol("fuse_fc")
    assert _ops(tpart) == ["_subgraph_op"]
    _same_graph(jpart, tpart)


def test_property_registry():
    prop = subgraph.DefaultSubgraphProperty(["exp"])
    subgraph.register_subgraph_property("test_backend", prop)
    assert subgraph.get_subgraph_property("test_backend") is prop
    part = subgraph.partition_graph(mx.symbol.exp(mx.symbol.var("x")),
                                    "test_backend")
    assert "_subgraph_op" in _ops(part)
    with pytest.raises(MXNetError):
        subgraph.get_subgraph_property("nope")
    with pytest.raises(jmx.MXNetError):
        jsubgraph.get_subgraph_property("nope")
    # the reference's op name runs the same executor, as in the JAX
    # package
    assert OP_REGISTRY["_default_subgraph_op"] is \
        OP_REGISTRY["_subgraph_op"]
    js = json.loads(part.tojson())
    for node in js["nodes"]:
        if node["op"] == "_subgraph_op":
            node["op"] = "_default_subgraph_op"
    x = np.arange(4, dtype=np.float32)
    out = _run(mx, mx.sym.load_json(json.dumps(js)), {"x": x})[0][0]
    np.testing.assert_allclose(out, np.exp(x), **TOL)
