"""The port's ``BucketingModule`` against the JAX package (CPU):

* the ``tests/test_module.py`` cases: a bucket made by a forward, its
  outputs, and the switch back to the default bucket; every bucket's
  executor holding the default bucket's parameter arrays themselves;
* three buckets over an interleaved bucket sequence, each batch
  ``forward_backward`` and ``update`` (SGD with momentum): every output,
  weight and momentum equal to JAX's, and every parameter, gradient and
  auxiliary array one memory (``data_ptr``) across the buckets'
  executors, a switch copying nothing; the shared updater's index of a
  parameter the same in every bucket;
* ``fit`` over a small bucketed ``DataIter``: the trained weights equal
  JAX's;
* the port's ``example/rnn/bucketing_lstm.py`` against the JAX script
  (loaded by path) at ``--epochs 2``, both seeded alike: the epoch
  accuracies equal, the final weights within 1e-5;
* with no context the module runs on the card, raising without one.

fp32 within ``atol=rtol=2e-5`` unless stated.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.example.rnn import bucketing_lstm as port_bl
from mxnet_tpu_torch.module import BucketingModule

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    """A state as numpy: an NDArray, a torch tensor or a jax array."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _pooled_gen(pkg):
    def sym_gen(seq_len):
        data = pkg.sym.var("data")  # (batch, seq_len, 6)
        pooled = pkg.sym.mean(data, axis=1)
        fc = pkg.sym.FullyConnected(pooled, name="fc", num_hidden=4)
        return (pkg.sym.SoftmaxOutput(fc, name="softmax"), ("data",),
                ("softmax_label",))
    return sym_gen


def _embed_gen(pkg):
    def sym_gen(seq_len):
        data = pkg.sym.var("data")
        label = pkg.sym.var("softmax_label")
        emb = pkg.sym.Embedding(data, input_dim=8, output_dim=6,
                                name="shareemb")
        pooled = pkg.sym.mean(emb, axis=1)
        fc = pkg.sym.FullyConnected(pooled, num_hidden=4, name="sharefc")
        return (pkg.sym.SoftmaxOutput(fc, label, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _batch(pkg, data, label, key):
    return pkg.io.DataBatch(
        data=[pkg.nd.array(data, ctx=pkg.cpu())],
        label=[pkg.nd.array(label, ctx=pkg.cpu())], bucket_key=key,
        provide_data=[pkg.io.DataDesc("data", data.shape)],
        provide_label=[pkg.io.DataDesc("softmax_label", label.shape)])


def _bound(pkg, gen, key, data_shape, label_shape, init, **kw):
    mod = pkg.module.BucketingModule(gen(pkg), default_bucket_key=key,
                                     context=pkg.cpu(), **kw)
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(init(pkg))
    return mod


def test_bucketing_module():
    """tests/test_module.py:125 in both packages, on the same weights."""
    rs = np.random.RandomState(0)
    x5, x10 = rs.randn(8, 5, 6), rs.randn(8, 10, 6)
    y = rs.randint(0, 4, 8).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        mod = _bound(pkg, _pooled_gen, 10, (8, 10, 6), (8,),
                     lambda p: p.initializer.Xavier(magnitude=1.0))
        if pkg is mx:
            mod.set_params(*mx.module.params_from_jax(
                mod._curr_module, *jmod.get_params()))
        else:
            jmod = mod
        got = []
        for x, key in ((x5, 5), (x10, 10)):
            mod.forward(_batch(pkg, x.astype(np.float32), y, key),
                        is_train=False)
            got.append(mod.get_outputs()[0].asnumpy())
            assert got[-1].shape == (8, 4)
        assert sorted(mod._buckets) == [5, 10]
        assert mod._curr_module is mod._buckets[10]
        outs.append(got)
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, **TOL)


def test_bucketing_executors_share_param_memory():
    """tests/test_module.py:271: the weight NDArray is the same object in
    both buckets' executors, so a write through one is the other's."""
    for pkg in (jmx, mx):
        mod = _bound(pkg, _embed_gen, 10, (2, 10), (2,),
                     lambda p: p.initializer.One())
        mod.forward(_batch(pkg, np.ones((2, 5), np.float32),
                           np.zeros(2, np.float32), 5))
        exec10 = mod._buckets[10]._exec_group.execs[0]
        exec5 = mod._buckets[5]._exec_group.execs[0]
        assert exec5.arg_dict["sharefc_weight"] is \
            exec10.arg_dict["sharefc_weight"]
        exec10.arg_dict["sharefc_weight"][:] = 3.5
        np.testing.assert_allclose(
            exec5.arg_dict["sharefc_weight"].asnumpy(), 3.5)


_SEQUENCE = [10, 5, 5, 7, 10, 7, 5, 10, 7]


def _train_three_buckets(pkg, rs_seed=1, jax_params=None):
    mod = _bound(pkg, _embed_gen, 10, (4, 10), (4,),
                 lambda p: p.initializer.Xavier(magnitude=2.0))
    if jax_params is not None:
        mod.set_params(*mx.module.params_from_jax(mod._curr_module,
                                                  *jax_params))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.9, "wd": 1e-3})
    rs = np.random.RandomState(rs_seed)
    outs = []
    for key in _SEQUENCE:
        data = rs.randint(0, 8, (4, key)).astype(np.float32)
        label = rs.randint(0, 4, 4).astype(np.float32)
        mod.forward_backward(_batch(pkg, data, label, key))
        outs.append(mod.get_outputs()[0].asnumpy())
        mod.update()
    return mod, outs


def test_three_buckets_train_like_jax_and_share_memory():
    jmod, jouts = _train_three_buckets(jmx)
    with mx.cpu():
        tmod, touts = _train_three_buckets(
            mx, jax_params=_initial_params(jmx))
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, **TOL)
    jarg, _ = jmod.get_params()
    targ, _ = tmod.get_params()
    assert sorted(targ) == sorted(jarg)
    for k in jarg:
        np.testing.assert_allclose(targ[k].asnumpy(), jarg[k].asnumpy(),
                                   err_msg=k, **TOL)
    jstates = jmod._curr_module._updater.states
    tstates = tmod._curr_module._updater.states
    assert sorted(tstates) == sorted(jstates)
    for i in jstates:
        np.testing.assert_allclose(_np(tstates[i]), _np(jstates[i]), **TOL)
    # one memory for every parameter, gradient and auxiliary array, and
    # the same optimizer index of each name, in every bucket
    assert sorted(tmod._buckets) == [5, 7, 10]
    execs = [m._exec_group.execs[0] for m in tmod._buckets.values()]
    default = tmod._buckets[10]
    for name in default._param_names:
        for d in ("arg_dict", "grad_dict"):
            ptrs = {getattr(e, d)[name]._data.data_ptr() for e in execs}
            assert len(ptrs) == 1, (name, d)
    for m in tmod._buckets.values():
        assert m._ordered_param_names() == default._ordered_param_names()
        assert m._updater is default._updater


def _initial_params(pkg):
    """The weights ``_train_three_buckets`` starts from in the JAX
    package: the seeded draws of a fresh module."""
    pkg.random.seed(3)
    mod = _bound(pkg, _embed_gen, 10, (4, 10), (4,),
                 lambda p: p.initializer.Xavier(magnitude=2.0))
    return mod.get_params()


@pytest.fixture(autouse=True)
def _seed_both():
    jmx.random.seed(3)
    mx.random.seed(3)


def test_switch_copies_nothing(monkeypatch):
    """A switch between bound buckets after an update hands the
    parameters over through ``set_params`` without a device copy."""
    with mx.cpu():
        mod, _ = _train_three_buckets(mx)
        copies = []
        orig = torch.Tensor.copy_

        def counting(self, src, *a, **kw):
            copies.append(tuple(self.shape))
            return orig(self, src, *a, **kw)

        monkeypatch.setattr(torch.Tensor, "copy_", counting)
        for key in (5, 7, 10):
            mod.switch_bucket(key, [mx.io.DataDesc("data", (4, key))],
                              [mx.io.DataDesc("softmax_label", (4,))])
            mod._params_dirty = True
        assert copies == []


class _BucketIter(object):
    """A bucketed iterator over fixed batches (``provide_data`` the
    default bucket's, each batch its own)."""

    def __init__(self, pkg, batches, default):
        self._pkg, self._batches = pkg, batches
        self.batch_size = 4
        self.provide_data = [pkg.io.DataDesc("data", (4, default))]
        self.provide_label = [pkg.io.DataDesc("softmax_label", (4,))]
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i == len(self._batches):
            raise StopIteration
        data, label, key = self._batches[self._i]
        self._i += 1
        return _batch(self._pkg, data, label, key)

    def reset(self):
        self._i = 0


def test_fit_over_a_bucketed_iterator():
    rs = np.random.RandomState(5)
    batches = []
    for key in _SEQUENCE:
        batches.append((rs.randint(0, 8, (4, key)).astype(np.float32),
                        rs.randint(0, 4, 4).astype(np.float32), key))
    start = _initial_params(jmx)
    results = []
    for pkg in (jmx, mx):
        mod = pkg.module.BucketingModule(_embed_gen(pkg),
                                         default_bucket_key=10,
                                         context=pkg.cpu())
        arg = start[0] if pkg is jmx else {
            k: mx.nd.array(v.asnumpy(), ctx=mx.cpu())
            for k, v in start[0].items()}
        mod.fit(_BucketIter(pkg, batches, 10), num_epoch=2,
                arg_params=arg, aux_params={}, optimizer="sgd",
                optimizer_params={"learning_rate": 0.3, "momentum": 0.9})
        results.append({k: v.asnumpy()
                        for k, v in mod.get_params()[0].items()})
        assert sorted(mod._buckets) == [5, 7, 10]
    for k in results[0]:
        np.testing.assert_allclose(results[1][k], results[0][k],
                                   err_msg=k, **TOL)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bucketing_lstm", REPO / "example" / "rnn" / "bucketing_lstm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bucketing_lstm_example_matches_jax(monkeypatch):
    """The JAX script's main at --epochs 2 (its module and its metric's
    readings caught by subclasses), seeded as the port's example seeds
    itself, against the port's example on the CPU."""
    torch.set_num_threads(1)  # a fixed order of the CPU's sums
    script = _jax_script()
    made, accs = [], []

    class Caught(jmx.module.BucketingModule):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    class Acc(jmx.metric.Accuracy):
        def get(self):
            res = super().get()
            accs.append(res[1])
            return res

    monkeypatch.setattr(script.mx.module, "BucketingModule", Caught)
    monkeypatch.setattr(script.mx.metric, "Accuracy", Acc)
    monkeypatch.setattr(sys, "argv", ["bucketing_lstm.py", "--epochs", "2"])
    jmx.random.seed(0)
    script.main()
    res = port_bl.main(["--epochs", "2", "--device", "cpu"])
    assert res["accuracy"] == accs
    assert res["buckets"] == [8, 16, 24]
    jarg, jaux = made[0].get_params()
    targ, taux = res["module"].get_params()
    assert sorted(targ) == sorted(jarg) and not jaux and not taux
    for k in jarg:
        np.testing.assert_allclose(targ[k].asnumpy(), jarg[k].asnumpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_bucketing_module_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(MXNetError, match="no CUDA device"):
        BucketingModule(_embed_gen(mx), default_bucket_key=10)
    with mx.cpu():
        mod = BucketingModule(_embed_gen(mx), default_bucket_key=10)
    assert mod._context == [mx.cpu()]
    # group2ctxs reach every bucket's Module
    mod = BucketingModule(_embed_gen(mx), default_bucket_key=10,
                          context=mx.cpu(), group2ctxs={"a": mx.cpu()})
    assert mod._new_module(10)._group2ctxs == {"a": mx.cpu()}
