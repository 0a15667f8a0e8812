"""Several contexts in one process (CPU): the port against the JAX
package on the same seeded inputs.

* ``gluon.Trainer`` over ``[cpu(0), cpu(1)]`` with ``split_and_load``
  and a ``tpu`` store: ``tests/test_parallel.py:293-336``'s user script
  in both packages (the JAX contexts are forced host devices,
  ``tests/conftest.py:15-16``), and the port's one-context run;
* ``Module`` over 2 and 3 contexts with an uneven ``work_load_list``:
  outputs, metric and weights against the JAX ``Module``;
  ``_split_input_slice`` case by case;
* ``group2ctx``: ``simple_bind``/``bind`` of a symbol with two
  ``ctx_group``s built here (``AttrScope``, as
  ``example/model-parallel/matrix_factorization.py`` builds its own),
  against the plain bind and the JAX executor, outputs and every
  gradient;
* ``matrix_factorization.py`` under both packages, ``--epochs 2``;
* the host arrays' ``cpu(i)``, ``tpu()``/``num_tpus()``, ``fit.py``'s
  ``--devices``.

Tolerances: ``tests/test_parallel.py:334``'s 1e-4 / 1e-6 for the
Trainer, 1e-5 / 1e-6 for the Module and the executor (one step's
arithmetic in another order), the printed digits for the rmse.
"""
import contextlib
import importlib.util
import io
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon, nd as jnd
from mxnet_tpu.module import executor_group as jeg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch.example.image_classification.common import fit
from mxnet_tpu_torch.example.model_parallel import matrix_factorization as mf
from mxnet_tpu_torch.gluon.utils import split_and_load
from mxnet_tpu_torch.module import executor_group as teg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINER_TOL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-6)


# -- gluon.Trainer over several contexts -----------------------------------

def _train_trainer(pkg, ctx_list, seed=13, steps=4):
    """``tests/test_parallel.py:_train_trainer`` in package ``pkg``: one
    user script, parameterized only by the context list."""
    xs = np.random.RandomState(seed).rand(16, 6).astype(np.float32)
    ys = np.random.RandomState(seed + 1).rand(16, 1).astype(np.float32)
    nn = pkg.gluon.nn
    with pkg.cpu():
        net = nn.HybridSequential(prefix="tt_")
        with net.name_scope():
            net.add(nn.Dense(8, activation="relu"))
            net.add(nn.Dense(1))
        net.initialize(pkg.initializer.Xavier(rnd_type="uniform"),
                       ctx=ctx_list)
        pkg.random.seed(99)
        with pkg.autograd.pause():
            net(pkg.nd.array(xs).as_in_context(ctx_list[0]))
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.05}, kvstore="tpu")
        loss_fn = pkg.gluon.loss.L2Loss()
        split = pkg.gluon.utils.split_and_load
        for _ in range(steps):
            data = split(pkg.nd.array(xs), ctx_list)
            label = split(pkg.nd.array(ys), ctx_list)
            with pkg.autograd.record():
                losses = [loss_fn(net(x), y) for x, y in zip(data, label)]
            for loss in losses:
                loss.backward()
            trainer.step(16)
        return {n: [np.asarray(d.asnumpy()) for d in p.list_data()]
                for n, p in net.collect_params().items()}


def test_trainer_over_two_contexts_equals_jax_and_one_context():
    two = [mx.cpu(0), mx.cpu(1)]
    got = _train_trainer(mx, two)
    want = _train_trainer(jmx, [jmx.cpu(0), jmx.cpu(1)])
    one = _train_trainer(mx, [mx.cpu(0)])
    assert set(got) == set(want) == set(one)
    for name in got:
        # every context's copy updated the same
        np.testing.assert_array_equal(got[name][0], got[name][1])
        np.testing.assert_allclose(got[name][0], want[name][0],
                                   err_msg=name, **TRAINER_TOL)
        np.testing.assert_allclose(got[name][0], one[name][0],
                                   err_msg=name, **TRAINER_TOL)


def test_parameters_and_arrays_over_host_contexts():
    ctxs = [mx.cpu(0), mx.cpu(1)]
    with mx.cpu():
        p = gluon.Parameter("w", shape=(2, 3))
        p.initialize(mx.initializer.One(), ctx=ctxs)
        assert [d.context for d in p.list_data()] == ctxs
        assert [g.context for g in p.list_grad()] == ctxs
        # two copies, never one tensor
        assert p.list_data()[0]._data.data_ptr() != \
            p.list_data()[1]._data.data_ptr()
        p.set_data(np.full((2, 3), 2.0, np.float32))
        for d in p.list_data():
            np.testing.assert_array_equal(d.asnumpy(), 2.0)
        # data() without a context: the current context's copy
        assert p.data() is p.list_data()[0]
        with mx.cpu(1):
            assert p.data() is p.list_data()[1]
        x = nd.array(np.ones((4, 3), np.float32), ctx=mx.cpu(1))
        assert x.context == mx.cpu(1)
        # an op's output, a slice, a copy keep the cpu(i)
        assert (x * 2).context == mx.cpu(1) and x[1:].context == mx.cpu(1)
        assert x.as_in_context(mx.cpu(0)).context == mx.cpu(0)
        parts = split_and_load(nd.array(np.arange(8.0).reshape(4, 2)), ctxs)
        assert [q.context for q in parts] == ctxs
        np.testing.assert_array_equal(parts[1].asnumpy(),
                                      [[4.0, 5.0], [6.0, 7.0]])
        for g in p.list_grad():
            g._data += 1.0
        p.zero_grad()
        assert all(float(g.asnumpy().sum()) == 0.0 for g in p.list_grad())


# -- Module over several contexts ------------------------------------------

@pytest.mark.parametrize("batch,load", [
    (24, [1, 1]), (24, [1, 2, 1]), (10, [1, 1, 1]), (7, [3, 1]),
    (5, [1, 1, 1, 1, 1, 1]), (16, [0.5, 0.25, 0.25])])
def test_split_input_slice_equals_jax(batch, load):
    assert teg._split_input_slice(batch, load) == \
        jeg._split_input_slice(batch, load)


def _mlp(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=8, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _module_run(pkg, n, load):
    rs = np.random.RandomState(0)
    xs = rs.rand(24, 6).astype(np.float32)
    ys = rs.randint(0, 3, 24).astype(np.float32)
    init = {"fc1_weight": rs.randn(8, 6).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rs.randn(3, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}
    with pkg.cpu():
        it = pkg.io.NDArrayIter(xs, ys, 6)
        mod = pkg.module.Module(_mlp(pkg),
                                context=[pkg.cpu(i) for i in range(n)],
                                work_load_list=load)
        metric = pkg.metric.create("acc")
        mod.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: pkg.nd.array(v) for k, v in init.items()},
                num_epoch=2, eval_metric=metric)
        args, _ = mod.get_params()
        it.reset()
        mod.forward(next(iter(it)), is_train=False)
        outs = mod.get_outputs()[0].asnumpy()
        split = mod.get_outputs(merge_multi_context=False)[0]
        return ({k: v.asnumpy() for k, v in args.items()}, outs,
                metric.get(), mod, [a.shape[0] for a in split])


@pytest.mark.parametrize("n,load", [(2, None), (3, [1, 2, 1])])
def test_module_over_contexts_equals_jax(n, load):
    args, outs, metric, mod, rows = _module_run(mx, n, load)
    jargs, jouts, jmetric, _, jrows = _module_run(jmx, n, load)
    assert len(mod._exec_group.execs) == n and rows == jrows
    assert metric == jmetric
    np.testing.assert_allclose(outs, jouts, **TOL)
    assert sorted(args) == sorted(jargs)
    for name in args:
        np.testing.assert_allclose(args[name], jargs[name], err_msg=name,
                                   **TOL)
    # every executor's copy took the store's same update
    for name in args:
        copies = [e.arg_dict[name].asnumpy() for e in mod._exec_group.execs]
        for c in copies[1:]:
            np.testing.assert_array_equal(c, copies[0])


# -- group2ctx --------------------------------------------------------------

def _grouped(pkg):
    """Two ctx_groups (an embedding and a dense layer each), joined by an
    unmapped elementwise product and a loss."""
    s = pkg.sym
    with pkg.AttrScope(ctx_group="g_emb"):
        e = s.Embedding(s.var("idx"), weight=s.var("emb_weight"),
                        input_dim=10, output_dim=4, name="emb")
    with pkg.AttrScope(ctx_group="g_fc"):
        f = s.FullyConnected(s.var("data"), num_hidden=4, name="fc")
        f = s.Activation(f, act_type="tanh", name="act")
    return s.LinearRegressionOutput(s.sum(e * f, axis=1), s.var("score"),
                                    name="lro")


def _grouped_run(pkg, group2ctx, bind=False):
    rs = np.random.RandomState(5)
    vals = {"idx": rs.randint(0, 10, 6).astype(np.float32),
            "data": rs.rand(6, 3).astype(np.float32),
            "score": rs.rand(6).astype(np.float32),
            "emb_weight": rs.rand(10, 4).astype(np.float32),
            "fc_weight": rs.rand(4, 3).astype(np.float32) - 0.5,
            "fc_bias": rs.rand(4).astype(np.float32)}
    sym = _grouped(pkg)
    with pkg.cpu():
        if bind:
            # the port's arrays where their groups live; the JAX
            # executor's jit takes its arguments on one device and places
            # the groups inside
            where = {"emb_weight": "g_emb", "fc_weight": "g_fc",
                     "fc_bias": "g_fc"} if pkg is mx else {}
            args = {k: pkg.nd.array(v, ctx=(group2ctx or {}).get(
                where.get(k), pkg.cpu())) for k, v in vals.items()}
            grads = {k: pkg.nd.zeros(v.shape, ctx=args[k].context)
                     for k, v in vals.items() if k.endswith(("weight",
                                                             "bias"))}
            ex = sym.bind(pkg.cpu(), args, args_grad=grads,
                          grad_req={k: "write" if k in grads else "null"
                                    for k in sym.list_arguments()},
                          group2ctx=group2ctx)
        else:
            ex = sym.simple_bind(pkg.cpu(), group2ctx=group2ctx,
                                 idx=(6,), data=(6, 3), score=(6,))
            for k, v in vals.items():
                ex.arg_dict[k][:] = v
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if g is not None and k.endswith(("weight", "bias"))}
        return out, grads, ex


@pytest.mark.parametrize("bind", [False, True], ids=["simple_bind", "bind"])
def test_group2ctx_executor_equals_plain_and_jax(bind):
    g2c = {"g_emb": mx.cpu(0), "g_fc": mx.cpu(1)}
    out, grads, ex = _grouped_run(mx, g2c, bind)
    pout, pgrads, _ = _grouped_run(mx, None, bind)
    jout, jgrads, _ = _grouped_run(
        jmx, {"g_emb": jmx.cpu(0), "g_fc": jmx.cpu(1)}, bind)
    np.testing.assert_array_equal(out, pout)
    np.testing.assert_allclose(out, jout, **TOL)
    assert sorted(grads) == sorted(pgrads) == sorted(jgrads) == \
        ["emb_weight", "fc_bias", "fc_weight"]
    for k in grads:
        np.testing.assert_array_equal(grads[k], pgrads[k])
        np.testing.assert_allclose(grads[k], jgrads[k], err_msg=k, **TOL)
    # each group's arrays live on its context; the unmapped on the
    # executor's
    assert ex.arg_dict["fc_weight"].context == mx.cpu(1)
    assert ex.grad_dict["fc_bias"].context == mx.cpu(1)
    assert ex.arg_dict["emb_weight"].context == mx.cpu(0)
    assert not ex.crosses_devices
    assert ex.reshape(idx=(3,), data=(3, 3), score=(3,)).arg_dict[
        "fc_weight"].context == mx.cpu(1)


def test_module_with_group2ctxs_trains_as_without():
    def run(g2c):
        rs = np.random.RandomState(2)
        xs = rs.rand(12, 3).astype(np.float32)
        idx = rs.randint(0, 10, 12).astype(np.float32)
        score = rs.rand(12).astype(np.float32)
        with mx.cpu():
            it = mx.io.NDArrayIter({"idx": idx, "data": xs},
                                   {"score": score}, 6)
            mod = mx.module.Module(_grouped(mx), data_names=("idx", "data"),
                                   label_names=("score",),
                                   context=[mx.cpu(0), mx.cpu(1)],
                                   group2ctxs=g2c)
            mx.random.seed(4)
            mod.fit(it, optimizer="sgd", num_epoch=2,
                    optimizer_params={"learning_rate": 0.1},
                    initializer=mx.initializer.Uniform(0.5),
                    eval_metric="mse")
            return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    got = run([{"g_emb": mx.cpu(2), "g_fc": mx.cpu(3)},
               {"g_emb": mx.cpu(4), "g_fc": mx.cpu(5)}])
    want = run(None)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- matrix_factorization.py -----------------------------------------------

def test_matrix_factorization_example_equals_jax(monkeypatch):
    res = mf.run(mf.parse_args(["--device", "cpu", "--epochs", "2"]))
    path = os.path.join(REPO, "example", "model-parallel",
                        "matrix_factorization.py")
    spec = importlib.util.spec_from_file_location("_jax_mf", path)
    jmf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmf)
    monkeypatch.setattr(sys, "argv", [path, "--epochs", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jmf.main() == 0
    lines = buf.getvalue().splitlines()
    jrmse = [float(line.split()[3]) for line in lines
             if line.startswith("[epoch")]
    assert "(improved)" in lines[-1] and res["improved"]
    assert len(jrmse) == len(res["rmse"]) == 2
    # JAX prints 4 digits
    np.testing.assert_allclose(res["rmse"], jrmse, rtol=0, atol=6e-5)


def test_matrix_factorization_places_the_groups():
    args = mf.parse_args(["--device", "cpu"])
    assert mf.group2ctx(args) == {"embed_user": mx.cpu(0),
                                  "embed_item": mx.cpu(1)}
    args = mf.parse_args([])
    assert args.device == "gpu" and args.user_ctx == "cpu"
    if mx.num_gpus() == 0:
        with pytest.raises(MXNetError, match="no CUDA device"):
            mf.group2ctx(args)


# -- small names --------------------------------------------------------------

def test_tpu_names_the_card():
    assert mx.num_tpus() == mx.num_gpus()
    assert mx.tpu is mx.context.tpu and "tpu" in mx.__all__
    if mx.num_gpus() == 0:
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.tpu()
    else:
        assert mx.tpu(0) == mx.gpu(0)
    with pytest.raises(MXNetError, match="CUDA device"):
        mx.tpu(mx.num_gpus())


def test_fit_devices_gives_contexts_of_the_current_type():
    with mx.cpu():
        assert fit._contexts(SimpleNamespace(devices=1)) == [mx.cpu()]
        assert fit._contexts(SimpleNamespace(devices=3)) == \
            [mx.cpu(0), mx.cpu(1), mx.cpu(2)]
    if mx.num_gpus() < 2:
        with mx.gpu(0) if mx.num_gpus() else contextlib.nullcontext():
            # gpu(1) beyond the cards present raises: no fallback
            with pytest.raises(MXNetError):
                fit._contexts(SimpleNamespace(devices=2))
