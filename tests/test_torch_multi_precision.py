"""``multi_precision`` and ``lr_scheduler`` in the port against the JAX
package (CPU).

* ``create_state_multi_precision``, ``update_multi_precision`` (through
  ``Updater``) and ``ensure_mp_state`` for SGD with and without momentum
  and Adam, on bfloat16 and float16 weights, three updates from the same
  weights and gradients: the masters and states within fp32 ``TOL`` of
  the JAX package's, the weights equal bit for bit (the master cast
  back), the dtypes equal (masters and states float32, weights in their
  own dtype). At creation the port's states are float32 already (made
  from the master); the JAX package makes them in the weight's dtype and
  its first update hands back float32 ones.
* An Adam ``(m, v)`` state is not taken for a ``(master, base)`` pair,
  and a state from before the master layout is adopted on both paths
  (``tests/test_fastpath.py:107-150``).
* The fused apply equals the per-parameter loop bit for bit on a list
  that mixes float32 weights with bfloat16 weights under
  ``multi_precision``.
* ``lr_scheduler``'s five classes (warmup included) give the JAX
  package's learning rates, and an optimizer reads its scheduler at
  ``num_update`` as the JAX one does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

from mxnet_tpu_torch import MXNetError, fastpath, lr_scheduler, optimizer
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.optimizer import _is_mp_pair, ensure_mp_state

TOL = 2e-5
OPTS = [("sgd", {"learning_rate": 0.1}),
        ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
        ("adam", {"learning_rate": 0.01, "wd": 1e-3})]
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, np.float16)}


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v).astype(np.float32)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [t for s in state for t in _leaves(s)]
    return [state]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,kw", OPTS, ids=["sgd", "sgd_mom", "adam"])
def test_multi_precision_updates_match_jax(name, kw, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    w0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * 0.1 for _ in range(3)]
    po = optimizer.create(name, multi_precision=True, **kw)
    jo = jopt.create(name, multi_precision=True, **kw)
    pu, ju = optimizer.get_updater(po), jopt.get_updater(jo)
    pw = NDArray(torch.from_numpy(w0).to(tdt))
    jw = JNDArray(jnp.asarray(w0, jdt), jmx.cpu())
    for g in grads:
        pu(0, NDArray(torch.from_numpy(g).to(tdt)), pw)
        ju(0, JNDArray(jnp.asarray(g, jdt), jmx.cpu()), jw)
        assert pw._data.dtype == tdt and jw._data.dtype == jdt
        np.testing.assert_array_equal(_f32(pw._data), _f32(jw._data))
        (pm, pb), (jm, jb) = pu.states[0], ju.states[0]
        assert pm.dtype == torch.float32 and jm.dtype == jnp.float32
        np.testing.assert_allclose(_f32(pm), _f32(jm), rtol=TOL, atol=TOL)
        # the weight is the master cast back
        assert torch.equal(pw._data, pm.to(tdt))
        pl, jl = _leaves(pb), _leaves(jb)
        assert len(pl) == len(jl)
        for a, b in zip(pl, jl):
            assert a.dtype == torch.float32 and b.dtype == jnp.float32
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,kw", OPTS, ids=["sgd", "sgd_mom", "adam"])
def test_create_state_multi_precision(name, kw):
    w = NDArray(torch.ones(3, 2, dtype=torch.bfloat16))
    po = optimizer.create(name, multi_precision=True, **kw)
    master, base = po.create_state_multi_precision(0, w)
    assert master.dtype == torch.float32 and torch.equal(master,
                                                          torch.ones(3, 2))
    assert all(t.dtype == torch.float32 for t in _leaves(base))
    assert _is_mp_pair(po, 0, w, (master, base))
    # float32 weights, or multi_precision off: the plain state
    w32 = NDArray(torch.ones(3, 2))
    assert not _is_mp_pair(po, 0, w32, po.create_state_multi_precision(
        0, w32))
    off = optimizer.create(name, **kw)
    plain = off.create_state_multi_precision(0, w)
    assert _leaves(plain) == [] or _leaves(plain)[0].dtype == torch.bfloat16


def test_adam_moments_are_not_taken_for_a_master_pair():
    """``tests/test_fastpath.py:132-150``: an fp32 Adam ``(m, v)`` resumed
    onto bfloat16 weights becomes the base of a fresh master pair."""
    o = optimizer.create("adam", learning_rate=0.01, multi_precision=True)
    w = NDArray(torch.full((4, 3), 0.75).bfloat16())
    m = torch.full((4, 3), 1e-8)
    v = torch.full((4, 3), 1e-8)
    assert not _is_mp_pair(o, 0, w, (m, v))
    state = ensure_mp_state(o, 0, w, (m, v))
    master, base = state
    np.testing.assert_allclose(master.numpy(), 0.75, rtol=1e-2)
    assert base[0] is m and base[1] is v
    assert ensure_mp_state(o, 0, w, state) is state
    # the JAX package decides the same on the same layout
    jo = jopt.create("adam", learning_rate=0.01, multi_precision=True)
    jw = JNDArray(jnp.asarray(np.full((4, 3), 0.75), jnp.bfloat16),
                  jmx.cpu())
    jm = jnp.full((4, 3), 1e-8, jnp.float32)
    assert not jopt._is_mp_pair(jo, 0, jw, (jm, jm))


@pytest.mark.parametrize("path", ["fused", "perparam"])
def test_pre_master_states_are_adopted(path):
    """``tests/test_fastpath.py:107-129``: a plain ``(m, v)`` made for a
    bfloat16 weight before ``multi_precision`` is adopted as the base of
    a master pair, on both paths."""
    o = optimizer.create("adam", learning_rate=0.01, multi_precision=True)
    upd = optimizer.get_updater(o)
    w = NDArray(torch.ones(4, 3).bfloat16())
    g = NDArray(torch.full((4, 3), 0.5).bfloat16())
    upd.states[0] = o.create_state(0, w)
    if path == "fused":
        fastpath.apply_updater(upd, [(0, g, w)])
    else:
        upd(0, g, w)
    master, base = upd.states[0]
    assert master.dtype == torch.float32 and master.shape == (4, 3)
    assert len(base) == 2
    assert (w.asnumpy() < 1.0).all()


@pytest.mark.parametrize("name,kw", OPTS, ids=["sgd", "sgd_mom", "adam"])
def test_fused_equals_perparam_on_mixed_dtype_lists(name, kw):
    rng = np.random.RandomState(2)
    shapes = [(6, 5), (5,), (3, 4, 2), (7,)]
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16]
    w0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
          for _ in range(3)]
    runs = {}
    for path in ("fused", "perparam"):
        upd = optimizer.get_updater(
            optimizer.create(name, multi_precision=True, **kw))
        ws = [NDArray(torch.tensor(w).to(d)) for w, d in zip(w0, dtypes)]
        for step in gs:
            triples = [(i, NDArray(torch.from_numpy(g).to(d)), w)
                       for i, (g, d, w) in enumerate(zip(step, dtypes, ws))]
            if path == "fused":
                fastpath.apply_updater(upd, triples)
            else:
                for t in triples:
                    upd(*t)
        runs[path] = [w._data for w in ws] + [
            t for i in range(len(ws)) for t in _leaves(upd.states[i])]
    assert len(runs["fused"]) == len(runs["perparam"])
    for a, b in zip(runs["fused"], runs["perparam"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


SCHEDULES = [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=0.4)),
    ("FactorScheduler", dict(step=2, factor=0.9, stop_factor_lr=0.2,
                             base_lr=0.4, warmup_steps=3,
                             warmup_begin_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3, base_lr=1.0)),
    ("MultiFactorScheduler", dict(step=[4], factor=0.5, base_lr=1.0,
                                  warmup_steps=3, warmup_mode="constant",
                                  warmup_begin_lr=0.2)),
    ("PolyScheduler", dict(max_update=10, base_lr=0.5, pwr=2,
                           final_lr=0.01)),
    ("PolyScheduler", dict(max_update=12, base_lr=0.5, pwr=1,
                           warmup_steps=4)),
    ("CosineScheduler", dict(max_update=10, base_lr=0.5, final_lr=0.05)),
    ("CosineScheduler", dict(max_update=9, base_lr=0.3, warmup_steps=2,
                             warmup_begin_lr=0.1)),
]


@pytest.mark.parametrize("cls,kw", SCHEDULES,
                         ids=[c + str(i) for i, (c, _) in
                              enumerate(SCHEDULES)])
def test_lr_schedulers_match_jax(cls, kw):
    mine = getattr(lr_scheduler, cls)(**kw)
    ref = getattr(jlrs, cls)(**kw)
    assert [mine(t) for t in range(16)] == [ref(t) for t in range(16)]


def test_lr_scheduler_errors_match_jax():
    for mod in (lr_scheduler, jlrs):
        with pytest.raises(Exception, match="greater or equal"):
            mod.FactorScheduler(step=0)
        with pytest.raises(Exception, match="increasing"):
            mod.MultiFactorScheduler(step=[3, 2])
        with pytest.raises(Exception, match="warmup_mode"):
            mod.LRScheduler(warmup_mode="cubic")


def test_optimizer_reads_its_scheduler_as_jax():
    """``Optimizer(lr_scheduler=...)`` sets the scheduler's base lr, reads
    it at ``num_update`` for every index, and refuses
    ``set_learning_rate``, as the JAX package's does."""
    seen = {}
    for pkg, mod, opt in (("port", lr_scheduler, optimizer),
                          ("jax", jlrs, jopt)):
        o = opt.create("sgd", learning_rate=0.8,
                       lr_scheduler=mod.FactorScheduler(step=2, factor=0.5))
        rows = []
        for _ in range(6):
            o._update_count(0)
            o._update_count(1)
            rows.append((o.learning_rate, o._get_lr(0), o._get_lr(1)))
        seen[pkg] = rows
        with pytest.raises(Exception, match="already been defined"):
            o.set_learning_rate(0.1)
    assert seen["port"] == seen["jax"]
    with pytest.raises(MXNetError):
        optimizer.create("sgd", lr_scheduler=lr_scheduler.FactorScheduler(
            step=1)).set_learning_rate(0.1)
