"""The port's SqueezeNet 1.0 and 1.1 against the JAX package's (CPU),
with the helpers of ``test_torch_zoo.py``: at 224 x 224 (the head is a
13 x 13 average pool), one image, the same parameter names, and from the
same He weights the same logits in predict mode (its Dropout draws in
train mode), within ``TOL``; the ``ceil_mode`` max pools are the
``Pooling`` op's ``pooling_convention="full"``."""
import pytest

from test_torch_zoo import compare
from test_torch_zoo import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("version", ["1.0", "1.1"])
def test_squeezenet_forward_matches_jax(version):
    compare(lambda v: v.get_model("squeezenet" + version, classes=10), 224,
            batch=1)
