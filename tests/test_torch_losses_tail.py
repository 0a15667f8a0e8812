"""The port's other nine gluon losses against the JAX package's (CPU):
``SigmoidBinaryCrossEntropyLoss`` (``SigmoidBCELoss``), ``KLDivLoss``,
``CTCLoss``, ``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``,
``LogisticLoss`` and ``TripletLoss``, with their options, a ``weight``
and a ``sample_weight``: the same seeded numpy inputs through both, the
per-sample losses within ``rtol=atol=2e-5`` and the prediction's
gradient (``backward`` of the summed losses) within 1e-4.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
RS = np.random.RandomState(3)
PRED = RS.randn(4, 5).astype(np.float32)
PROB = RS.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
BIN = (RS.rand(4, 5) > 0.5).astype(np.float32)
PM1 = 2 * BIN - 1
DIST = RS.dirichlet(np.ones(5), 4).astype(np.float32)
SW = RS.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
CTC_PRED = RS.randn(3, 8, 5).astype(np.float32)
CTC_LABEL = np.array([[1, 2, 0], [3, 3, 1], [4, 0, 0]], np.float32)

# name -> (constructor, kwargs, [pred, *other inputs])
CASES = {
    "bce": ("SigmoidBinaryCrossEntropyLoss", {}, [PRED, BIN]),
    "bce_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                         {"from_sigmoid": True}, [PROB, BIN]),
    "bce_alias_weighted": ("SigmoidBCELoss", {"weight": 0.5},
                           [PRED, BIN, SW]),
    "kl": ("KLDivLoss", {}, [np.log(PROB), DIST]),
    "kl_logits": ("KLDivLoss", {"from_logits": False, "weight": 2.0},
                  [PRED, DIST, SW]),
    "ctc": ("CTCLoss", {}, [CTC_PRED, CTC_LABEL]),
    "ctc_tnc_tn": ("CTCLoss", {"layout": "TNC", "label_layout": "TN"},
                   [CTC_PRED.transpose(1, 0, 2).copy(),
                    CTC_LABEL.T.copy()]),
    "ctc_lengths": ("CTCLoss", {"weight": 0.5},
                    [CTC_PRED, CTC_LABEL, np.array([8, 6, 7], np.float32),
                     np.array([2, 3, 1], np.float32)]),
    "huber": ("HuberLoss", {}, [PRED, PRED[::-1].copy()]),
    "huber_rho": ("HuberLoss", {"rho": 0.3}, [PRED, PRED[::-1].copy(),
                                              SW]),
    "hinge": ("HingeLoss", {}, [PRED, PM1]),
    "hinge_margin": ("HingeLoss", {"margin": 0.5, "weight": 3.0},
                     [PRED, PM1, SW]),
    "squared_hinge": ("SquaredHingeLoss", {}, [PRED, PM1]),
    "squared_hinge_margin": ("SquaredHingeLoss", {"margin": 2.0},
                             [PRED, PM1, SW]),
    "logistic": ("LogisticLoss", {}, [PRED, PM1]),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        [PRED, BIN, SW]),
    "triplet": ("TripletLoss", {}, [PRED, PRED * 0.5,
                                    RS.randn(4, 5).astype(np.float32)]),
    "triplet_margin": ("TripletLoss", {"margin": 0.2, "weight": 2.0},
                       [PRED, PRED * 0.9, PRED * 1.1]),
}


def _run(pkg, name, kw, inputs):
    arrs = [pkg.nd.array(a, ctx=pkg.cpu()) for a in inputs]
    arrs[0].attach_grad()
    lossfn = getattr(pkg.gluon.loss, name)(**kw)
    if name == "CTCLoss" and len(arrs) == 4:
        call = lambda: lossfn(arrs[0], arrs[1], arrs[2], arrs[3])  # noqa
    else:
        call = lambda: lossfn(*arrs)  # noqa: E731
    with pkg.autograd.record():
        loss = call()
        total = loss.sum()
    total.backward()
    return loss.asnumpy(), arrs[0].grad.asnumpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(case):
    name, kw, inputs = CASES[case]
    want, want_g = _run(jmx, name, kw, inputs)
    got, got_g = _run(mx, name, kw, inputs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_g, want_g, **GRAD_TOL)


def test_every_loss_of_the_jax_module_is_ported():
    assert sorted(mx.gluon.loss.__all__) == sorted(jmx.gluon.loss.__all__)
    with pytest.raises(ValueError):
        mx.gluon.loss.CTCLoss(layout="NCT")
    with pytest.raises(ValueError):
        mx.gluon.loss.LogisticLoss(label_format="pm1")
