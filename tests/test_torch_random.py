"""The port's samplers (``ops/random_ops.py``, ``nd.random``,
``mx.random``) against the JAX package's (CPU).

The draws cannot equal the JAX package's (its PRNG keys are not torch's
generators), so parity is held in other ways: each sampler's shape,
dtype and support against the JAX op's; the moments of 10,000 draws
against the distribution's (``torch_op_cases.check_moments``: the mean
within 5 standard errors, the variance within 12 %); the same seed gives
the same draws; ``get_state``/``set_state`` replays every stream, draw
for draw; and nothing draws from torch's global generator. The
``_sample_*`` ops' broadcasting and the ``nd.random`` functions' shapes:
``test_torch_random_shapes.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from torch_op_cases import (MULTINOMIAL_P, RANDOM_CASES, RANDOM_N,
                            check_moments, check_support)


def _draw(pkg, op, arrays, attrs, shape):
    params = [pkg.nd.array(a, ctx=pkg.cpu()) for a in arrays]
    kw = dict(attrs, shape=shape)
    out = pkg.nd.invoke(op, *params, **kw) if params \
        else pkg.nd.invoke(op, ctx=pkg.cpu(), **kw)
    return out[0] if isinstance(out, (list, tuple)) else out


@pytest.mark.parametrize("op", sorted(RANDOM_CASES))
def test_sampler_shape_dtype_support_and_moments(op):
    arrays, attrs, rows, _ = RANDOM_CASES[op]
    mx.random.seed(42)
    got = _draw(mx, op, arrays, attrs, (RANDOM_N,))
    want = _draw(jmx, op, arrays, attrs, (RANDOM_N,))
    assert got.shape == want.shape and got.dtype == want.dtype or (
        got.dtype == np.int64 and want.dtype == np.int32)
    vals = got.asnumpy()
    check_support(op, vals)
    check_moments(op, vals.reshape(-1, RANDOM_N) if arrays else vals[None])


def test_multinomial_and_shuffle():
    mx.random.seed(1)
    with mx.cpu():
        probs = nd.array(MULTINOMIAL_P)
        draws = nd.random.multinomial(probs, shape=(RANDOM_N,))
        assert draws.shape == (2, RANDOM_N) and draws.dtype == np.int32
        freq = np.stack([(draws.asnumpy() == j).mean(axis=1)
                         for j in range(3)], axis=1)
        np.testing.assert_allclose(freq, MULTINOMIAL_P, atol=0.02)
        s, lp = nd.random.multinomial(probs, shape=(5,), get_prob=True)
        want = np.log(MULTINOMIAL_P / MULTINOMIAL_P.sum(1, keepdims=True))
        np.testing.assert_allclose(
            lp.asnumpy(), np.take_along_axis(want, s.asnumpy(), 1),
            rtol=1e-6)
        one = nd.random.multinomial(nd.array(MULTINOMIAL_P[0]))
        assert one.shape == (1,)  # the reference's default shape (1,)
        perm = nd.random.shuffle(nd.arange(50).reshape((25, 2))).asnumpy()
        assert sorted(perm[:, 0].tolist()) == list(range(0, 50, 2))
        np.testing.assert_array_equal(perm[:, 1], perm[:, 0] + 1)
    jd = jmx.nd.random.multinomial(jmx.nd.array(MULTINOMIAL_P), shape=(5,))
    assert jd.shape == (2, 5) and jd.dtype == np.int32


def _run_streams():
    """Draws from every stream: device ops, dropout, np_rng, numpy."""
    with mx.cpu():
        a = nd.random.normal(shape=(4,)).asnumpy()
        b = nd.random.poisson(2.0, shape=(4,)).asnumpy()
        with mx.autograd.train_mode():
            c = nd.Dropout(nd.ones((8,)), p=0.5).asnumpy()
        d = nd.random.shuffle(nd.arange(10)).asnumpy()
    return [a, b, c, d, mx.random.np_rng().rand(3), np.random.rand(2)]


def test_seed_replays_and_set_state_replays_draw_for_draw():
    mx.random.seed(123)
    first = _run_streams()
    mx.random.seed(123)
    again = _run_streams()
    for x, y in zip(first, again):
        np.testing.assert_array_equal(x, y)
    state = mx.random.get_state()
    later = _run_streams()
    assert not np.array_equal(later[0], first[0])
    mx.random.set_state(state)
    replay = _run_streams()
    for x, y in zip(later, replay):
        np.testing.assert_array_equal(x, y)
    # a generator made after the snapshot is made again, seeded, on replay
    mx.random.seed(7)
    mx.random._GENERATORS.clear()
    state = mx.random.get_state()
    with mx.cpu():
        x = nd.random.uniform(shape=(3,)).asnumpy()
    mx.random.set_state(state)
    with mx.cpu():
        y = nd.random.uniform(shape=(3,)).asnumpy()
    np.testing.assert_array_equal(x, y)


def test_nothing_draws_from_torchs_global_generator():
    torch.manual_seed(0)
    before = torch.get_rng_state()
    mx.random.seed(3)
    for op, (arrays, attrs, _, _) in sorted(RANDOM_CASES.items()):
        _draw(mx, op, arrays, attrs, (10,))
    _run_streams()
    with mx.cpu():
        nd.random.multinomial(nd.array(MULTINOMIAL_P), shape=(4,))
    assert torch.equal(torch.get_rng_state(), before)
    assert mx.random.generator("cpu") is mx.random.generator(
        torch.device("cpu"))
