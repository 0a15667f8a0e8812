"""AlexNet: the port of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``,
with the same blocks and parameter names (``params_from_jax`` carries a
JAX net's weights across). ``pretrained=True`` raises."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._builders import refuse_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """AlexNet (reference alexnet.py:AlexNet); input 224 x 224."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                for ch, k, s, p in ((64, 11, 4, 2), (192, 5, 1, 2)):
                    self.features.add(nn.Conv2D(ch, kernel_size=k, strides=s,
                                                padding=p,
                                                activation="relu"))
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                for ch in (384, 256, 256):
                    self.features.add(nn.Conv2D(ch, kernel_size=3, padding=1,
                                                activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
                for _ in range(2):
                    self.features.add(nn.Dense(4096, activation="relu"))
                    self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    refuse_pretrained(pretrained)
    return AlexNet(**kwargs)
