"""DenseNet-BC 121/161/169/201: the port of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``, with the same blocks
and parameter names. Each dense layer concatenates its growth onto its
input (``F.concat``). ``pretrained=True`` raises."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._builders import named_factory, refuse_pretrained, seq as _pipeline

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


def _bn_relu_conv(channels, kernel, pad=0):
    """The pre-activation composite H(.): BN, relu, convolution."""
    return [nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(channels, kernel_size=kernel, padding=pad,
                      use_bias=False)]


class _DenseLayer(HybridBlock):
    """BN-relu-1x1 then BN-relu-3x3, concatenated onto the input."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = _pipeline(*(_bn_relu_conv(bn_size * growth_rate, 1)
                                + _bn_relu_conv(growth_rate, 3, pad=1)))
        self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        grown = self.body(x)
        if self.dropout is not None:
            grown = self.dropout(grown)
        return F.concat(x, grown, dim=1, num_args=2)


def _dense_stage(num_layers, bn_size, growth_rate, dropout, index):
    stage = nn.HybridSequential(prefix="stage%d_" % index)
    with stage.name_scope():
        for _ in range(num_layers):
            stage.add(_DenseLayer(growth_rate, bn_size, dropout))
    return stage


def _transition(channels):
    """Compress and downsample between dense stages."""
    return _pipeline(*_bn_relu_conv(channels, 1),
                     nn.AvgPool2D(pool_size=2, strides=2))


class DenseNet(HybridBlock):
    """DenseNet-BC (reference densenet.py:DenseNet); input 224 x 224 (the
    head's 7 x 7 average pool)."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = _pipeline(
                nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                          padding=3, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            width = num_init_features
            last = len(block_config) - 1
            for i, num_layers in enumerate(block_config):
                self.features.add(_dense_stage(num_layers, bn_size,
                                               growth_rate, dropout, i + 1))
                width += num_layers * growth_rate
                if i != last:
                    width //= 2
                    self.features.add(_transition(width))
            for tail in (nn.BatchNorm(), nn.Activation("relu"),
                         nn.AvgPool2D(pool_size=7), nn.Flatten()):
                self.features.add(tail)
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (stem channels, growth rate, layers per stage)
densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def get_densenet(num_layers, pretrained=False, ctx=None, root=None,
                 **kwargs):
    if num_layers not in densenet_spec:
        raise MXNetError("Invalid DenseNet depth %d; options: %s"
                         % (num_layers, sorted(densenet_spec)))
    refuse_pretrained(pretrained)
    stem, growth, config = densenet_spec[num_layers]
    return DenseNet(stem, growth, config, **kwargs)


def _factory(depth):
    return named_factory(get_densenet, "densenet%d" % depth,
                         "DenseNet-%d (reference densenet.py)." % depth,
                         depth)


densenet121 = _factory(121)
densenet161 = _factory(161)
densenet169 = _factory(169)
densenet201 = _factory(201)
