"""VGG 11/13/16/19 with and without BatchNorm: the port of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``, with the same blocks and
parameter names. ``pretrained=True`` raises."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._builders import refuse_pretrained

__all__ = ["VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]


class VGG(HybridBlock):
    """VGG (reference vgg.py:VGG): ``layers[i]`` 3 x 3 convolutions of
    ``filters[i]`` channels (each with BatchNorm when ``batch_norm``) then
    a 2 x 2 max pool, per stage; two Dense(4096) and the classifier."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise MXNetError("VGG: %d stages of layers, %d of filters"
                             % (len(layers), len(filters)))
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu",
                                           weight_initializer="normal",
                                           bias_initializer="zeros"))
                self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for num, ch in zip(layers, filters):
            for _ in range(num):
                featurizer.add(nn.Conv2D(ch, kernel_size=3, padding=1,
                                         weight_initializer="xavier",
                                         bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    if num_layers not in vgg_spec:
        raise MXNetError("Invalid vgg layers %d" % num_layers)
    refuse_pretrained(pretrained)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
