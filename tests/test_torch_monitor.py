"""The port's ``Monitor`` against the JAX package's (CPU):
``tests/test_module.py:306-345``'s cases on both packages (a bound
executor, ``install``, ``tic``/``toc``, the interval), with the same row
names and the same statistics within 1e-5; ``Module.install_monitor``;
and ``Module.fit(monitor=)``, which runs the eager path (no module
plane) and logs the rows the JAX package logs.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.telemetry import STEP_DISPATCHES

TOL = 1e-5


def _fc(m):
    x = m.sym.Variable("data")
    w = m.sym.Variable("w")
    return m.sym.FullyConnected(data=x, weight=w, no_bias=True,
                                num_hidden=3, name="fc")


def _bound(m, ctx):
    rs = np.random.RandomState(0)
    exe = _fc(m).simple_bind(ctx, data=(2, 4))
    exe.arg_dict["data"][:] = rs.randn(2, 4).astype(np.float32)
    exe.arg_dict["w"][:] = rs.randn(3, 4).astype(np.float32)
    return exe


def _rows(m, ctx, interval=1, stat_func=None, steps=1, sort=False):
    exe = _bound(m, ctx)
    mon = m.monitor.Monitor(interval, stat_func=stat_func, pattern=".*",
                            sort=sort)
    mon.install(exe)
    out = []
    for _ in range(steps):
        mon.tic()
        exe.forward()
        out.append(mon.toc())
    return out


def _same_rows(mine, theirs):
    assert [(s, n) for s, n, _ in mine] == [(s, n) for s, n, _ in theirs]
    for (_, _, a), (_, _, b) in zip(mine, theirs):
        va = np.array([float(x) for x in a.split()])
        vb = np.array([float(x) for x in b.split()])
        np.testing.assert_allclose(va, vb, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sort", [False, True])
def test_executor_rows_match_jax(sort):
    mine = _rows(mx, mx.cpu(), sort=sort)[0]
    theirs = _rows(jmx, jmx.cpu(), sort=sort)[0]
    assert mine, "monitor collected nothing"
    assert {n for _, n, _ in mine} == {"fc_output", "data", "w"}
    _same_rows(mine, theirs)


def test_interval_and_custom_stat_match_jax():
    def stat(m):
        return lambda x: [m.nd.max(x), m.nd.min(x)]

    mine = _rows(mx, mx.cpu(), interval=2, stat_func=stat(mx), steps=3)
    theirs = _rows(jmx, jmx.cpu(), interval=2, stat_func=stat(jmx), steps=3)
    assert [len(r) for r in mine] == [len(r) for r in theirs]
    assert mine[1] == [] and mine[0] and mine[2]
    for a, b in zip(mine, theirs):
        _same_rows(a, b)


def test_step_and_activated():
    mon = mx.monitor.Monitor(3)
    assert (mon.step, mon.activated) == (0, False)
    mon.tic()
    assert (mon.step, mon.activated) == (1, True)
    assert mon.toc() == []
    assert not mon.activated


def _mlp(m):
    data = m.sym.var("data")
    fc1 = m.sym.FullyConnected(data=data, name="fc1", num_hidden=8)
    act = m.sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = m.sym.FullyConnected(data=act, name="fc2", num_hidden=3)
    return m.sym.SoftmaxOutput(data=fc2, name="softmax")


class _Recording(object):
    """A Monitor of either package that keeps what ``toc_print`` logs."""

    def __init__(self, m, interval):
        self.mon = m.monitor.Monitor(interval, pattern=".*")
        self.rows = []
        toc = self.mon.toc

        def toc_print():
            self.rows.extend(toc())

        self.mon.toc_print = toc_print


def _fit(m, ctx, monitor, xs, ys):
    m.random.seed(4)
    with ctx:
        it = m.io.NDArrayIter(xs, ys, 16)
        mod = m.mod.Module(_mlp(m), context=ctx)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=m.initializer.Xavier(), monitor=monitor)
    return mod


def test_fit_with_a_monitor_runs_eager_and_logs_the_jax_rows():
    rs = np.random.RandomState(2)
    xs = rs.randn(64, 5).astype(np.float32)
    ys = xs[:, :3].argmax(1).astype(np.float32)
    mine = _Recording(mx, 2)
    graph = STEP_DISPATCHES.value(plane="graph")
    mod = _fit(mx, mx.cpu(), mine.mon, xs, ys)
    # the monitor forced the eager pair: no module-plane step
    assert STEP_DISPATCHES.value(plane="graph") == graph
    theirs = _Recording(jmx, 2)
    jmod = _fit(jmx, jmx.cpu(), theirs.mon, xs, ys)
    # through a Module only the outputs are reported (the JAX package's
    # install_monitor sets the hook without Monitor.install)
    assert [n for _, n, _ in mine.rows] == ["softmax_output"] * 2
    _same_rows(mine.rows, theirs.rows)
    ja, _ = jmod.get_params()
    for k, v in mod.get_params()[0].items():
        np.testing.assert_allclose(v.asnumpy(), ja[k].asnumpy(), rtol=TOL,
                                   atol=TOL)


def test_module_install_monitor_and_toc_print(caplog):
    rs = np.random.RandomState(3)
    with mx.cpu():
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        mon = mx.monitor.Monitor(1, pattern="softmax.*")
        mod.install_monitor(mon)
        batch = mx.io.DataBatch([mx.nd.array(rs.randn(4, 5))],
                                [mx.nd.array(np.arange(4) % 3)])
        mon.tic()
        mod.forward(batch, is_train=False)
        with caplog.at_level(logging.INFO):
            mon.toc_print()
    assert any("softmax_output" in r.getMessage() for r in caplog.records)
