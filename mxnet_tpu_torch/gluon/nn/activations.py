"""Advanced activation layers: the port of
``mxnet_tpu/gluon/nn/activations.py``, whole (LeakyReLU, PReLU, ELU,
SELU, GELU, Swish over the port's ``LeakyReLU`` op)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class LeakyReLU(HybridBlock):
    """Leaky ReLU (reference activations.py:LeakyReLU)."""

    def __init__(self, alpha, **kwargs):
        assert alpha >= 0, "Slope coefficient for LeakyReLU must be no less than 0."
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "{name}({alpha})".format(
            name=self.__class__.__name__, alpha=self._alpha)


class PReLU(HybridBlock):
    """Parametric ReLU with learned slope (reference activations.py:PReLU)."""

    def __init__(self, alpha_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,), init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """Exponential linear unit (reference activations.py:ELU)."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (reference activations.py:SELU)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """Gaussian error linear unit."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """x * sigmoid(beta*x) (reference activations.py:Swish)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
