"""The port's ``ops/linalg.py`` against the JAX package's, name by name
(CPU).

Every case of ``torch_tail_cases``' linalg group runs through both
packages (``torch_op_sweep``: forward and the gradient of every float
input under a fixed random weighting, ``rtol=atol=2e-5`` in float32);
each ``linalg_*`` alias runs its op's first case under its own name.
``syevd`` and ``gelqf`` give vectors whose signs the solver chooses
(LAPACK here, cuSOLVER on the card), so they are compared through
sign-invariant forms: the eigenvalues, |U| and U^T diag(w) U; |L|, |Q|
and L Q; and the gradient of a sign-invariant head (the squares of every
output, weighted) within 1e-4.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_sweep import TOL, check
from torch_tail_cases import (ALIASES, SIGN_CASES, TAIL_CASES, canonical,
                              group, sign_invariant)

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", group("linalg"))
def test_linalg_op_matches_jax(case):
    check(*TAIL_CASES[case], "float32")


@pytest.mark.parametrize("name", ALIASES["linalg"])
def test_linalg_alias_runs_its_op(name):
    assert OP_REGISTRY[name] is OP_REGISTRY["_" + name]
    assert JAX_REGISTRY[name] is JAX_REGISTRY["_" + name]
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    if op in ("_linalg_syevd", "_linalg_gelqf"):
        _check_sign_case(name, specs)
    else:
        check(name, specs, attrs, flags, "float32")


def _sign_run(pkg, op, inputs):
    a = pkg.nd.array(inputs[0], ctx=pkg.cpu())
    a.attach_grad()
    with pkg.autograd.record():
        outs = pkg.nd.invoke(op, a)
        head = None
        for k, o in enumerate(outs):
            w = pkg.nd.array(np.random.RandomState(70 + k).randn(
                *o.shape).astype(np.float32), ctx=pkg.cpu())
            term = (o * o * w).sum()
            head = term if head is None else head + term
    head.backward()
    return [o.asnumpy() for o in outs], a.grad.asnumpy()


def _check_sign_case(op, inputs):
    want, want_g = _sign_run(jmx, op, inputs)
    got, got_g = _sign_run(mx, op, inputs)
    canon = op if op.startswith("_") else "_" + op
    for g, w in zip(sign_invariant(canon, got),
                    sign_invariant(canon, want)):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got_g, want_g, **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(SIGN_CASES))
def test_sign_free_op_matches_jax(case):
    _check_sign_case(*SIGN_CASES[case])


def test_syevd_reconstructs_and_orders():
    """U's rows are orthonormal and U^T diag(w) U gives the symmetric
    part back, with w ascending."""
    a = SIGN_CASES["syevd_asymmetric_input"][1][0]
    with mx.cpu():
        u, w = mx.nd.linalg_syevd(mx.nd.array(a))
    u, w = u.asnumpy(), w.asnumpy()
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), u.shape)
    np.testing.assert_allclose(u @ u.transpose(0, 2, 1), eye, atol=1e-5)
    sym = (a + a.transpose(0, 2, 1)) / 2
    np.testing.assert_allclose(
        np.einsum("bki,bk,bkj->bij", u, w, u), sym, atol=1e-5)
    assert np.all(np.diff(w, axis=-1) >= 0)
