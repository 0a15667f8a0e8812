"""Module.fit, score and predict against the JAX package (CPU).

The symbolic MLP of ``custom_softmax_rtc.py`` (``FullyConnected(128)``
-> relu -> ``FullyConnected(10)`` -> ``Custom``) with the numpy softmax
op of the two examples (the JAX one's ``np_softmax_ce``, loaded by file,
and the port's), on a small ``NDArrayIter`` (256 samples, batch 32,
shuffled), both packages seeded alike (``mx.random.seed(7)`` before the
iterators: the shuffle and the Xavier weights come from the same host
stream in both). ``fit`` runs 2 epochs of SGD (lr 0.2, momentum 0.9,
``rescale_grad`` 1: the op's backward already divides by the batch),
then ``score`` and ``predict`` on 64 test samples.

The JAX package's ``fit`` takes its graph plane here (one compiled
step per batch, ``trainplane.module_plane``; the numpy op runs in a
host callback inside it); the port's plane refuses the numpy op at its
first pass (the op reads back to the host, which a CUDA graph cannot
replay), counts ``FALLBACKS{reason="module-trace: MXNetError"}`` and
runs the eager ``forward_backward`` + ``update`` branch; the rtc op
takes the port's plane (on the CPU through its kernels' plain
versions), one graph step a batch. Tolerances, fp32 on the CPU:
the final parameters and the predictions within 1e-5 (sums in other
orders, carried by the momentum over 16 steps), the scores exactly
(both are counts of argmax hits). ``Speedometer`` logs the JAX
package's lines, with only the speed differing.
"""
import importlib.util
import logging
import re
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.example.numpy_ops import custom_softmax as port_cs
from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as port_cr

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
SGD = {"learning_rate": 0.2, "momentum": 0.9, "rescale_grad": 1.0}
BATCH = 32


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_custom_softmax",
        REPO / "example" / "numpy-ops" / "custom_softmax.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # registers np_softmax_ce with the JAX one
    return mod


def _jax_symbol():
    s = jmx.sym
    fc1 = s.FullyConnected(s.var("data"), num_hidden=128, name="fc1")
    act = s.Activation(fc1, act_type="relu", name="relu1")
    fc2 = s.FullyConnected(act, num_hidden=10, name="fc2")
    return s.Custom(fc2, s.var("softmax_label"), op_type="np_softmax_ce",
                    name="softmax")


def _data():
    rs = np.random.RandomState(19)
    return port_cs.make_data(256, rs), port_cs.make_data(64, rs)


def _fit(pkg, symbol, ctx, caplog):
    (xtr, ytr), (xte, yte) = _data()
    with ctx:
        pkg.random.seed(7)
        train = pkg.io.NDArrayIter(xtr, ytr, BATCH, shuffle=True)
        test = pkg.io.NDArrayIter(xte, yte, BATCH)
        mod = pkg.module.Module(symbol, context=ctx)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.fit(train, eval_metric="acc", optimizer="sgd",
                    optimizer_params=SGD,
                    initializer=pkg.initializer.Xavier(), num_epoch=2,
                    batch_end_callback=pkg.callback.Speedometer(BATCH, 4))
        lines = [r.getMessage() for r in caplog.records
                 if "Speed:" in r.getMessage()]
        score = mod.score(test, "acc")
        pred = mod.predict(test).asnumpy()
        args, _ = mod.get_params()
    return (mod, {k: v.asnumpy() for k, v in args.items()}, score, pred,
            lines)


def _demotions():
    return {r["labels"]["reason"]: r["value"]
            for r in mx.trainplane.FALLBACKS.series()}


def test_fit_score_predict_match_jax(caplog):
    _jax_example()
    jmod, jparams, jscore, jpred, jlines = _fit(jmx, _jax_symbol(),
                                                jmx.cpu(), caplog)
    assert jmx.trainplane.module_plane(jmod) is not None  # the graph plane
    before = _demotions()
    graph0 = mx.telemetry.STEP_DISPATCHES.value(plane="graph")
    _, tparams, tscore, tpred, tlines = _fit(
        mx, port_cr.get_symbol("np_softmax_ce"), mx.cpu(), caplog)
    reason = "module-trace: MXNetError"
    assert _demotions()[reason] == before.get(reason, 0.0) + 1
    assert mx.telemetry.STEP_DISPATCHES.value(plane="graph") == graph0
    assert sorted(tparams) == sorted(jparams)
    for name in jparams:
        np.testing.assert_allclose(tparams[name], jparams[name], **TOL)
    assert tscore == jscore and tscore[0][0] == "accuracy"
    assert tscore[0][1] > 0.9
    assert tpred.shape == jpred.shape == (64, 10)
    np.testing.assert_allclose(tpred, jpred, **TOL)
    speed = re.compile(r"Speed: [0-9.]+ samples/sec")
    assert len(tlines) == len(jlines) == 2  # batch 4 of each epoch
    assert [speed.sub("Speed: * samples/sec", x) for x in tlines] == \
        [speed.sub("Speed: * samples/sec", x) for x in jlines]


def test_rtc_example_fits_on_the_cpu_through_the_plain_versions():
    """``custom_softmax_rtc.run`` with the rtc op on the CPU: the op runs
    its kernels' plain versions there, learns, and predicts the whole
    test set; it agrees with the numpy op after the first batch."""
    args = ["--device", "cpu", "--epochs", "1", "--train-size", "512"]
    graph0 = mx.telemetry.STEP_DISPATCHES.value(plane="graph")
    res = port_cr.run(port_cr.parse_args(args))
    # the rtc op's fit runs on the module plane, one step a batch
    assert mx.telemetry.STEP_DISPATCHES.value(plane="graph") - graph0 == 8
    ref = port_cr.run(port_cr.parse_args(args + ["--op", "np_softmax_ce"]))
    assert res["train_batches"] == 8 and res["test_batches"] == 8
    assert res["learned"] and ref["learned"]
    assert res["pred"].shape == (512, 10)
    np.testing.assert_allclose(res["first"]["prob"], ref["first"]["prob"],
                               **TOL)
    for name, v in res["first"]["params"].items():
        np.testing.assert_allclose(v, ref["first"]["params"][name], **TOL)


def test_fit_refuses_what_is_not_ported():
    (xtr, ytr), _ = _data()
    with mx.cpu():
        train = mx.io.NDArrayIter(xtr, ytr, BATCH)
        mod = mx.module.Module(port_cr.get_symbol("np_softmax_ce"))
        # dist_sync is ported now: one worker outside a launched job, the
        # eager path through the store
        mod.fit(train, num_epoch=1, kvstore="dist_sync")
        assert mod._kvstore.type == "dist_sync"
        # a monitor is ported now: fit takes it (the eager path)
        mod.fit(train, num_epoch=1, monitor=mx.monitor.Monitor(100))
        # group2ctxs are ported now: one map a context, the fit the same
        mod = mx.module.Module(port_cr.get_symbol("np_softmax_ce"),
                               group2ctxs=[{"dev1": mx.cpu()}])
        mod.fit(train, num_epoch=1)
        assert mod._exec_group.group2ctxs == [{"dev1": mx.cpu()}]
