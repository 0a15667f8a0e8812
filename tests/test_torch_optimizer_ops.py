"""The port's fused optimizer-update ops against the JAX package's and
against the port's optimizer classes (CPU), as ``tests/
test_optimizer_ops.py`` holds the JAX ones.

Every op (and the ``adagrad_update`` alias) runs on the same numpy
inputs, with and without clipping and weight decay, in both packages:
outputs within 2e-5, the same number of them, and the JAX package's
input names. The order of weight decay and clipping (``tests/
test_optimizer_ops.py:133-200``) is held on inputs where the two orders
differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ndarray.ndarray import invoke as jinvoke
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray
from mxnet_tpu.ops.optimizer_ops import __name__ as _JAX_OPS_MODULE
from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.ndarray.ndarray import NDArray, invoke
from mxnet_tpu_torch.ops.registry import OP_REGISTRY

TOL = 2e-5
SHAPE = (5, 4)

# op -> (number of state inputs after weight and grad, attrs)
OPS = {
    "sgd_update": (0, {"lr": 0.1}),
    "sgd_mom_update": (1, {"lr": 0.1, "momentum": 0.9}),
    "mp_sgd_update": (1, {"lr": 0.1}),
    "mp_sgd_mom_update": (2, {"lr": 0.1, "momentum": 0.9}),
    "adam_update": (2, {"lr": 0.01}),
    "ftml_update": (3, {"lr": 0.1, "t": 2}),
    "ftrl_update": (2, {"lr": 0.1}),
    "rmsprop_update": (1, {"lr": 0.01}),
    "rmspropalex_update": (3, {"lr": 0.01}),
    "signsgd_update": (0, {"lr": 0.1}),
    "signum_update": (1, {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}),
    "_sparse_adagrad_update": (1, {"lr": 0.1}),
    "adagrad_update": (1, {"lr": 0.1}),
}
EXTRA = {"plain": {}, "wd_clip_rescale": {"wd": 0.05, "clip_gradient": 0.4,
                                          "rescale_grad": 0.5}}


def _inputs(name, n_state):
    rs = np.random.RandomState(len(name))
    w = rs.randn(*SHAPE).astype(np.float32)
    g = (rs.randn(*SHAPE) + 0.2 * np.sign(rs.randn(*SHAPE))) \
        .astype(np.float32)
    if name in ("_sparse_adagrad_update", "adagrad_update"):
        g[[1, 3]] = 0.0  # rows the lazy update leaves alone
    # states positive where an op takes their square root
    states = [np.abs(rs.randn(*SHAPE)).astype(np.float32) + 0.5
              for _ in range(n_state)]
    if name.startswith("mp_"):
        states[-1] = w.copy()  # the float32 master
        w = w.astype(np.float16)
        g = g.astype(np.float16)
    if name == "rmspropalex_update":
        states[1] *= 0.1  # mean g small against n: n - g*g stays positive
    return [w, g] + states


def _port(name, arrays, attrs):
    outs = invoke(name, *[NDArray(torch.from_numpy(a.copy()))
                          for a in arrays], **attrs)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [o.asnumpy() for o in outs]


def _jax(name, arrays, attrs):
    from mxnet_tpu import cpu

    outs = jinvoke(name, *[JNDArray(jnp.asarray(a), cpu()) for a in arrays],
                   **attrs)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return [np.asarray(o._data) for o in outs]


def test_the_ops_are_the_jax_ones():
    jax_names = sorted(n for n, o in JAX_REGISTRY.items()
                       if o.fcompute.__module__ == _JAX_OPS_MODULE)
    assert jax_names == sorted(OPS)
    for name in OPS:
        mine, theirs = OP_REGISTRY[name], JAX_REGISTRY[name]
        assert mine.input_names() == theirs.input_names()
        assert mine.num_outputs() == theirs.num_outputs()
        assert set(mine.params) == set(theirs.params)


@pytest.mark.parametrize("extra", sorted(EXTRA))
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name, extra):
    n_state, attrs = OPS[name]
    attrs = dict(attrs, **EXTRA[extra])
    arrays = _inputs(name, n_state)
    got, want = _port(name, arrays, attrs), _jax(name, arrays, attrs)
    assert len(got) == len(want) == OP_REGISTRY[name].num_outputs()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), rtol=TOL, atol=TOL)


def _class_step(o, w, g, steps=1, state=None):
    wt = NDArray(torch.from_numpy(w.copy()))
    state = o.create_state(0, wt) if state is None else state
    for _ in range(steps):
        state = o.update(0, wt, NDArray(torch.from_numpy(g.copy())), state)
    return wt.asnumpy(), state


@pytest.mark.parametrize("name,cls,kw,steps", [
    ("sgd_update", "sgd", {"wd": 0.01}, 1),
    ("sgd_mom_update", "sgd", {"momentum": 0.9}, 3),
    ("signsgd_update", "signsgd", {"wd": 0.01}, 1),
    ("rmsprop_update", "rmsprop", {"gamma1": 0.95, "wd": 0.01}, 3),
    ("rmspropalex_update", "rmsprop",
     {"gamma1": 0.95, "centered": True}, 3),
])
def test_op_matches_the_optimizer_class(name, cls, kw, steps):
    rs = np.random.RandomState(3)
    w = rs.randn(*SHAPE).astype(np.float32)
    g = rs.randn(*SHAPE).astype(np.float32)
    lr = 0.01 if cls == "rmsprop" else 0.1
    o = opt.create(cls, learning_rate=lr, rescale_grad=1.0, **kw)
    want, _ = _class_step(o, w, g, steps)
    n_state = OPS[name][0]
    arrays = [w] + [g] + [np.zeros_like(w)] * n_state
    attrs = dict(lr=lr, **{k: v for k, v in kw.items()
                           if k not in ("centered",)})
    if cls == "rmsprop":
        attrs.setdefault("gamma1", 0.95)
    for _ in range(steps):
        outs = _port(name, arrays, attrs)
        arrays = [outs[0], g] + outs[1:]
    np.testing.assert_allclose(arrays[0], want, rtol=1e-5, atol=1e-6)


def test_sparse_adagrad_keeps_zero_rows():
    w, g, hist = _inputs("_sparse_adagrad_update", 1)
    w2, h2 = _port("_sparse_adagrad_update", [w, g, hist], {"lr": 0.1})
    for r in (1, 3):
        np.testing.assert_array_equal(w2[r], w[r])
        np.testing.assert_array_equal(h2[r], hist[r])
    assert not np.allclose(w2[0], w[0])


def test_clip_and_weight_decay_order():
    """adam and rmsprop clip after folding in ``wd * weight``; sgd clips
    the bare gradient (``tests/test_optimizer_ops.py:133-168``)."""
    w = np.full((3, 2), 10.0, np.float32)
    g = np.full((3, 2), 0.5, np.float32)
    z = np.zeros_like(w)
    clip, wd, lr = 0.1, 1.0, 0.01
    g_eff = np.clip(g + wd * w, -clip, clip)
    m, v = (1 - 0.9) * g_eff, (1 - 0.999) * g_eff * g_eff
    out = _port("adam_update", [w, g, z, z],
                dict(lr=lr, wd=wd, clip_gradient=clip))
    np.testing.assert_allclose(out[0], w - lr * m / (np.sqrt(v) + 1e-8),
                               rtol=1e-6)
    n = (1 - 0.95) * g_eff * g_eff
    out = _port("rmsprop_update", [w, g, z],
                dict(lr=lr, wd=wd, clip_gradient=clip))
    np.testing.assert_allclose(out[0], w - lr * g_eff / np.sqrt(n + 1e-8),
                               rtol=1e-5)
    out = _port("sgd_update", [w, g], dict(lr=lr, wd=wd, clip_gradient=clip))
    np.testing.assert_allclose(
        out[0], w - lr * (np.clip(g, -clip, clip) + wd * w), rtol=1e-6)


def test_optimizer_classes_order_clip_and_weight_decay():
    """Adam folds wd before the clip; AdaGrad keeps wd out of its
    history (``tests/test_optimizer_ops.py:171-200``)."""
    w = np.full((4,), 10.0, np.float32)
    g = np.full((4,), 0.5, np.float32)
    clip, wd, lr = 0.1, 1.0, 0.01
    got, _ = _class_step(opt.Adam(learning_rate=lr, wd=wd,
                                  clip_gradient=clip), w, g)
    g_eff = np.clip(g + wd * w, -clip, clip)
    lr_t = lr * np.sqrt(1 - 0.999) / (1 - 0.9)
    want = w - lr_t * (0.1 * g_eff) / (np.sqrt(0.001 * g_eff ** 2) + 1e-8)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got, st = _class_step(opt.AdaGrad(learning_rate=lr, wd=wd,
                                      clip_gradient=clip), w, g)
    g_eff = np.clip(g, -clip, clip)
    h = g_eff * g_eff
    np.testing.assert_allclose(
        got, w - lr * (g_eff / np.sqrt(h + 1e-7) + wd * w), rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), h, rtol=1e-6)


def test_mp_sgd_keeps_the_weight_low_precision():
    rs = np.random.RandomState(4)
    w32 = rs.randn(*SHAPE).astype(np.float32)
    g = rs.randn(*SHAPE).astype(np.float32)
    with mx.cpu():
        w16 = NDArray(torch.from_numpy(w32).to(torch.bfloat16))
        g16 = NDArray(torch.from_numpy(g).to(torch.bfloat16))
        w_out, w32_out = invoke("mp_sgd_update", w16, g16,
                                NDArray(torch.from_numpy(w32.copy())), lr=0.1)
    assert w_out._data.dtype == torch.bfloat16
    np.testing.assert_allclose(
        w32_out.asnumpy(),
        w32 - 0.1 * g16._data.float().numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(w_out._data, w32_out._data.to(torch.bfloat16))
