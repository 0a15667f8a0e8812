"""The ``CTCLoss`` op (and its three aliases' op) against the JAX
package's (CPU).

The CTC cases of ``torch_tail_cases`` run through both packages
(``torch_op_sweep``: the per-sample losses and the data's gradient,
``rtol=atol=2e-5`` in float32): without and with data and label lengths,
blank ``first`` and ``last`` (classes and labels rotated), and an
infeasible label, whose loss is about 1e30 with finite gradients in
both. Then the op against ``F.ctc_loss`` on feasible labels (a yardstick
the port does not call; rtol 1e-5, gradients 1e-4).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops.nn import ctc_loss
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_sweep import check
from torch_tail_cases import TAIL_CASES, group


@pytest.mark.parametrize("case", [k for k in group("nn_tail")
                                  if k.startswith("CTCLoss")])
def test_ctc_op_matches_jax(case):
    check(*TAIL_CASES[case], "float32")


@pytest.mark.parametrize("name", ["_contrib_CTCLoss", "ctc_loss",
                                  "_contrib_ctc_loss"])
def test_ctc_alias_runs_the_op(name):
    assert OP_REGISTRY[name] is OP_REGISTRY["CTCLoss"]
    assert JAX_REGISTRY[name] is JAX_REGISTRY["CTCLoss"]
    _, specs, attrs, flags = TAIL_CASES["CTCLoss_blank_last"]
    check(name, specs, attrs, flags, "float32")


def test_ctc_infeasible_label_is_large_and_finite():
    op, specs, attrs, _ = TAIL_CASES["CTCLoss_infeasible"]
    x = torch.randn(2, 3, 4, requires_grad=True)
    lab = torch.as_tensor(specs[1])
    loss = ctc_loss(OP_REGISTRY[op].parse_attrs(attrs), x, lab)
    loss.sum().backward()
    assert float(loss[0].detach()) > 1e29 and float(loss[1].detach()) < 100
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_op_matches_torch_ctc_loss_on_feasible_labels(blank):
    """The recursion against PyTorch's CTC (a yardstick, not used by the
    port): the same negative log-likelihoods and gradients."""
    rs = np.random.RandomState(5)
    b, t, c, lab_len = 4, 9, 6, 3
    data = torch.tensor(rs.randn(b, t, c), dtype=torch.float32,
                        requires_grad=True)
    lab = rs.randint(1, c, (b, lab_len))
    lengths = np.array([3, 2, 3, 1])
    for i, n in enumerate(lengths):
        lab[i, n:] = 0
    attrs = OP_REGISTRY["CTCLoss"].parse_attrs({"blank_label": blank})
    if blank == "last":  # classes 0..c-2, blank c-1, padding -1
        lab_in = np.where(lab > 0, lab - 1, -1)
        targets, blank_id = lab_in, c - 1
    else:
        lab_in, targets, blank_id = lab, lab, 0
    ours = ctc_loss(attrs, data, torch.tensor(lab_in, dtype=torch.float32))
    g_ours, = torch.autograd.grad(ours.sum(), data)
    logp = torch.log_softmax(data, -1).transpose(0, 1)
    ref = F.ctc_loss(logp, torch.tensor(np.where(targets < 0, 0, targets)),
                     torch.full((b,), t, dtype=torch.int64),
                     torch.tensor(lengths), blank=blank_id,
                     reduction="none")
    g_ref, = torch.autograd.grad(ref.sum(), data)
    np.testing.assert_allclose(ours.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_ours.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-5)
