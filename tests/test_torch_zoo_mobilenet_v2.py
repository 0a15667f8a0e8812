"""The port's MobileNet v2 against the JAX package's in predict mode
(CPU), with the helpers of ``test_torch_zoo.py``: at multiplier 0.25,
64 x 64, the same parameter names, and from the same He weights the same
logits within ``TOL``. Its ReLU6 is the ``clip`` op; its depthwise
convolutions are grouped convolutions with one group a channel. Train
mode (BatchNorm on its batch statistics, through the same conv, BN and
depthwise units) is held for MobileNet v1 in
``test_torch_zoo_mobilenet.py``: the JAX forward of v2 at the size a
well-conditioned train-mode comparison needs takes 17-26 s alone on the
CPU box."""
from test_torch_zoo import TOL, compare
from test_torch_zoo import _one_torch_thread  # noqa: F401


def test_mobilenet_v2_forward_matches_jax():
    compare(lambda v: v.MobileNetV2(0.25, classes=10), 64, tol=TOL)
