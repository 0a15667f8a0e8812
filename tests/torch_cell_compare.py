"""A recurrent cell built in the JAX package and in the port, the JAX
one's weights carried into the port's (``params_from_jax``), unrolled
over ``T_STEPS`` steps of the same input under a fixed random weighting
of every output and state: outputs and states within 2e-5, the input's
and every weight's gradient within 5e-5 (fp32; a gradient sums over the
steps, and a convolution's over its windows, in another order). Used by
``test_torch_gluon_contrib*.py``."""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)
T_STEPS = 3


def _run(pkg, cell, x_np, weights):
    x = pkg.nd.array(x_np, ctx=pkg.cpu())
    x.attach_grad()
    with pkg.autograd.record():
        outs, states = cell.unroll(T_STEPS, x, layout="NTC",
                                   merge_outputs=True)
        flat = [outs] + list(states)
        head = None
        for k, o in enumerate(flat):
            w = pkg.nd.array(np.random.RandomState(40 + k).randn(
                *o.shape).astype(np.float32), ctx=pkg.cpu())
            term = (o * w).sum()
            head = term if head is None else head + term
    head.backward()
    params = cell.collect_params()
    return ([o.asnumpy() for o in flat], x.grad.asnumpy(),
            [params[k].grad().asnumpy() for k in params])


def compare(make, x_shape, seed=0):
    x = np.random.RandomState(seed).randn(*x_shape).astype(np.float32)
    jmx.random.seed(3)
    jcell = make(jmx)
    jcell.initialize(ctx=jmx.cpu())
    want = _run(jmx, jcell, x, None)
    with mx.cpu():
        cell = make(mx)
        cell.initialize()
        cell.unroll(T_STEPS, mx.nd.array(x), layout="NTC")  # shapes
        gluon.params_from_jax(cell, {k: p.data().asnumpy() for k, p in
                                     jcell.collect_params().items()})
        got = _run(mx, cell, x, None)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **FWD)
    np.testing.assert_allclose(got[1], want[1], **GRAD)
    assert len(got[2]) == len(want[2]) >= 4
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, **GRAD)
    return got
