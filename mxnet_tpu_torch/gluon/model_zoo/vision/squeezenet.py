"""SqueezeNet 1.0 and 1.1: the port of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``, with the same blocks
and parameter names. The ``ceil_mode`` pools are the ``Pooling`` op's
``pooling_convention="full"``. ``pretrained=True`` raises."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._builders import refuse_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    """squeeze 1 x 1, then 1 x 1 and 3 x 3 expansions concatenated."""

    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.expand1x1(x), self.expand3x3(x), dim=1,
                        num_args=2)


# per version: the stem convolution (channels, kernel), then the stages'
# fire modules (squeeze, expand) with a ceil-mode max pool before each
_STEM = {"1.0": (96, 7), "1.1": (64, 3)}
_STAGES = {
    "1.0": [[(16, 64), (16, 64), (32, 128)],
            [(32, 128), (48, 192), (48, 192), (64, 256)], [(64, 256)]],
    "1.1": [[(16, 64), (16, 64)], [(32, 128), (32, 128)],
            [(48, 192), (48, 192), (64, 256), (64, 256)]],
}


class SqueezeNet(HybridBlock):
    """SqueezeNet (reference squeezenet.py:SqueezeNet); input 224 x 224
    (the head's 13 x 13 average pool)."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _STEM:
            raise MXNetError("Unsupported SqueezeNet version %s: 1.0 or 1.1 "
                             "expected" % version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            ch, k = _STEM[version]
            self.features.add(nn.Conv2D(ch, kernel_size=k, strides=2,
                                        activation="relu"))
            for stage in _STAGES[version]:
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                for squeeze, expand in stage:
                    self.features.add(_Fire(squeeze, expand, expand))
            self.features.add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.AvgPool2D(13))
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None,
                   **kwargs):
    refuse_pretrained(pretrained)
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
