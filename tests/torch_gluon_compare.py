"""A gluon block built in the JAX package and in the port, the JAX one's
weights carried into the port's (``params_from_jax``), then the same
inputs forward and backward in both under a fixed random weighting of
every output: outputs, the inputs' gradients and every parameter's
gradient within ``rtol=atol=2e-5`` (fp32; the port's parity tolerance).
Used by ``test_torch_rnn*.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon

TOL = dict(rtol=2e-5, atol=2e-5)
T, N, C = 5, 3, 4


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _run(pkg, net, fwd, inputs, train):
    xs = [pkg.nd.array(a, ctx=pkg.cpu()) for a in inputs]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record(train_mode=train):
        outs = _flat(fwd(pkg, net, *xs))
        head = None
        for k, o in enumerate(outs):
            w = pkg.nd.array(np.random.RandomState(50 + k).randn(
                *o.shape).astype(np.float32), ctx=pkg.cpu())
            term = (o * w).sum()
            head = term if head is None else head + term
    head.backward()
    params = net.collect_params()
    return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs],
            list(params.keys()),
            [p.grad().asnumpy() for p in params.values()
             if p.grad_req != "null"])


def compare(build, fwd, inputs, train=True):
    """``build(pkg)`` in both packages, the JAX one's weights into the
    port's, then ``fwd(pkg, net, *inputs)`` forward and backward."""
    jmx.random.seed(7)  # the same weights in every run (rnn_relu's
    jnet = build(jmx)   # gradient jumps where a unit crosses 0)
    jnet.initialize()
    want = _run(jmx, jnet, fwd, inputs, train)
    arrays = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    with mx.cpu():
        net = build(mx)
        net.initialize()
        gluon.params_from_jax(net, arrays)
        got = _run(mx, net, fwd, inputs, train)
    assert gluon._canonical_names(got[2]) == gluon._canonical_names(want[2])
    for part in (0, 1, 3):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **TOL)
    return got


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)




@pytest.fixture
def jax_sequence_last(monkeypatch):
    """The JAX package's ``unroll`` passes the lengths to SequenceLast as
    an attribute, where the op then finds no lengths and raises; the
    port passes them as its second input. For the JAX side of these
    comparisons the lengths go in as the input."""
    orig = jmx.nd.SequenceLast

    def fixed(data, *args, sequence_length=None, **kw):
        if sequence_length is not None:
            args = (sequence_length,) + args
        return orig(data, *args, **kw)

    monkeypatch.setattr(jmx.nd, "SequenceLast", fixed)
