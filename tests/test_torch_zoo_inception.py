"""The port's Inception v3 against the JAX package's (CPU), with the
helpers of ``test_torch_zoo.py``: at its 299 x 299 input (the head's
8 x 8 average pool) and full width (the family has no width knob), one
image, the same parameter names (its ``HybridConcurrent`` branches and
``A1_`` ... ``E2_`` prefixes), and from the same He weights the same
logits in predict mode, within ``TOL``."""
from test_torch_zoo import compare
from test_torch_zoo import _one_torch_thread  # noqa: F401


def test_inception_v3_forward_matches_jax():
    compare(lambda v: v.Inception3(classes=10), 299, batch=1)
