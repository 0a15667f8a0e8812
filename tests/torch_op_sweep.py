"""The op sweep's runner: one case of ``torch_op_cases`` through the JAX
package and the port on the CPU, compared (``test_torch_tensor_ops*``).

In float32 the case runs inside ``autograd.record()`` with a fixed random
weighting of every float output as the head, so the forward values and
the gradient of every float input are compared; in int32, forward only,
exact. Tolerance ``rtol=atol=2e-5`` in float32 (the port's parity
tolerance: XLA-CPU and torch-CPU order their sums differently). Dtypes
must match, except that the port keeps 64-bit integers 64-bit where JAX
without x64 gives 32 bits (``shape_array``, ``size_array``,
``_histogram``'s counts): those compare values.
"""
import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from torch_op_cases import CASES, make_inputs

TOL = dict(rtol=2e-5, atol=2e-5)


def _run(pkg, op, inputs, attrs, ctx, grad):
    arrs = [pkg.nd.array(a, ctx=ctx, dtype=a.dtype) for a in inputs]
    diff = [a for a, x in zip(arrs, inputs) if grad and x.dtype == np.float32]
    for a in diff:
        a.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.invoke(op, *arrs, **attrs) if inputs \
            else pkg.nd.invoke(op, ctx=ctx, **attrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        head = None
        for k, o in enumerate(outs):
            if not diff or o.dtype != np.float32:
                continue
            w = pkg.nd.array(np.asarray(np.random.RandomState(100 + k).randn(
                *o.shape), np.float32), ctx=ctx)
            term = (o * w).sum()
            head = term if head is None else head + term
    if head is not None:
        head.backward()
    return [o.asnumpy() for o in outs], \
        [a.grad.asnumpy() for a in diff] if head is not None else []


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not (got.dtype == np.int64 and want.dtype == np.int32):
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def check(op, specs, attrs, flags, dtype):
    """``op`` on the case's inputs in ``dtype``, the port against JAX."""
    inputs = make_inputs(specs, dtype, seed=11)
    grad = flags["grad"] and dtype == "float32"
    want_out, want_grad = _run(jmx, op, inputs, attrs, jmx.cpu(), grad)
    got_out, got_grad = _run(mx, op, inputs, attrs, mx.cpu(), grad)
    assert len(got_out) == len(want_out)
    for g, w in zip(got_out, want_out):
        same(g, w)
    assert len(got_grad) == len(want_grad)
    for g, w in zip(got_grad, want_grad):
        same(g, w)


def check_case(case, dtype):
    op, specs, attrs, flags = CASES[case]
    check(op, specs, attrs, flags, dtype)
