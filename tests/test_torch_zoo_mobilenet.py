"""The port's DenseNet and MobileNet v1 against the JAX package's (CPU),
with the helpers of ``test_torch_zoo.py``: the same parameter names, and
from the same He weights the same logits, in predict mode and in train
mode (where the BatchNorm moving statistics move too).

* DenseNet with the family's own knobs cut small (stem 8, growth 4, two
  stages of 2 layers) at 56 x 56, the size its 7 x 7 head pool needs
  after two halvings and a transition: within ``TOL``.
* MobileNet v1 at multiplier 0.25: predict mode at 64 x 64 within
  ``TOL``; train mode at 128 x 128, batch 4 (4 x 4 maps at the head, 64
  values a channel for its last BatchNorms) within ``MOBILE_TRAIN_TOL``.
"""
import pytest

from test_torch_zoo import TOL, compare
from test_torch_zoo import _one_torch_thread  # noqa: F401

# Train mode normalises each of MobileNet's convolutions by its batch's
# statistics, and each BatchNorm over the last stages' few values a
# channel magnifies the two packages' fp32 summation-order differences:
# at 128 x 128, batch 4, the logits differ by 6.0e-5 (v1) and 4.8e-5 (v2)
# at most (measured on this CPU; at 64 x 64, batch 2, by 1.7e-4 and
# 4.8e-4, which is why the train-mode cases run at 128).
MOBILE_TRAIN_TOL = 1e-4


@pytest.mark.parametrize("train", [False, True])
def test_densenet_forward_matches_jax(train):
    compare(lambda v: v.DenseNet(8, 4, [2, 2], classes=10), 56, train=train)


@pytest.mark.parametrize("train", [False, True])
def test_mobilenet_v1_forward_matches_jax(train):
    compare(lambda v: v.MobileNet(0.25, classes=10), 128 if train else 64,
            batch=4 if train else 2, train=train,
            tol=MOBILE_TRAIN_TOL if train else TOL)
