"""The port's ``example/gluon/neural_style.py`` against the JAX script
(CPU), both in this process, seeded alike (``torch_example_compare.py``):
the loss of each of 40 Adam steps on the input image at ``--size 48``
within 1e-4 relative, and the JAX example's own criterion (the
trailing-5 mean below half the first). The run needs a gradient leaf to
survive ``img[:] = img.clip(0, 1)``: where ``NDArray.__setitem__``
dropped the leaf, the image's ``.grad`` stayed at the first step's and
the loss rose (pinned in ``test_setitem_keeps_a_gradient_leaf``).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.example.gluon import neural_style
from torch_example_compare import rel_errs, run_both


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_neural_style_losses_step_for_step(monkeypatch):
    got, want, res = run_both(
        monkeypatch, "neural_style", ["--iters", "40", "--size", "48"],
        lambda argv: neural_style.run(neural_style.parse_args(argv)))
    assert len(got) == 40
    assert max(rel_errs(got, want)) <= 1e-4
    np.testing.assert_allclose(res["losses"], got, rtol=1e-6)
    assert res["improved"]


def test_setitem_keeps_a_gradient_leaf():
    """``x[:] = ...`` on an ``attach_grad`` array keeps it a leaf with its
    ``.grad``: three Adam steps on ((x - 0.5)^2).sum() with a clip
    between them give the JAX package's losses and gradients."""
    outs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            x = pkg.nd.array(np.random.RandomState(0).rand(2, 3).astype(
                np.float32))
            x.attach_grad()
            grad_obj = x.grad
            opt = pkg.optimizer.create("adam", learning_rate=0.05)
            state = opt.create_state(0, x)
            run = []
            for _ in range(3):
                with pkg.autograd.record():
                    loss = ((x - 0.5) ** 2).sum()
                loss.backward()
                run.append((float(loss.asnumpy()), x.grad.asnumpy().copy()))
                state = opt.update(0, x, x.grad, state)
                x[:] = x.clip(0.0, 1.0)
            if pkg is mx:
                assert x.grad is grad_obj
        outs.append(run)
    for (gl, gg), (wl, wg) in zip(outs[1], outs[0]):
        assert abs(gl - wl) <= 1e-6 * abs(wl)
        np.testing.assert_allclose(gg, wg, rtol=1e-6, atol=1e-7)
