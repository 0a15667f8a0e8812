"""ResNet V1/V2: the port of ``mxnet_tpu/gluon/model_zoo/vision/
resnet.py``, whole (depths 18 to 152).

The same blocks, in the same order, with the same names and shapes, so
``gluon.params_from_jax`` carries a JAX ResNet's weights and moving
statistics across unchanged. The port runs them eagerly, or captured as
one CUDA graph a step by ``parallel.TrainStep``/``InferStep``.
``pretrained=True`` raises: the model store needs a download, which the
port does not make.
"""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock
from ._builders import named_factory, refuse_pretrained, seq as _seq

__all__ = [
    "ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
    "BottleneckV1", "BottleneckV2", "get_resnet",
    "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
    "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
]


def _conv(ch, k, stride=1, pad=0, in_ch=0, bias=False):
    return nn.Conv2D(ch, kernel_size=k, strides=stride, padding=pad,
                     use_bias=bias, in_channels=in_ch)


def _conv3x3(channels, stride, in_channels):
    return _conv(channels, 3, stride, 1, in_channels)


def _conv_bn_act(specs, final_act=True):
    """conv→BN(→relu) pipeline from (ch, k, stride, pad, in_ch) rows; the
    trailing relu is omitted when the residual add comes first (V1 blocks)."""
    layers = []
    for row_i, row in enumerate(specs):
        layers += [_conv(*row), nn.BatchNorm()]
        if final_act or row_i + 1 < len(specs):
            layers.append(nn.Activation("relu"))
    return _seq(*layers)


def _shortcut(channels, stride, in_channels, with_bn):
    proj = [_conv(channels, 1, stride, 0, in_channels)]
    if with_bn:
        proj.append(nn.BatchNorm())
    return _seq(*proj)


class _BlockV1(HybridBlock):
    """Post-activation residual block: relu(body(x) + shortcut(x))."""

    def __init__(self, body_specs, channels, stride, downsample,
                 in_channels, **kwargs):
        super().__init__(**kwargs)
        self.body = _conv_bn_act(body_specs, final_act=False)
        self.downsample = _shortcut(channels, stride, in_channels,
                                    with_bn=True) if downsample else None

    def hybrid_forward(self, F, x):
        skip = x if self.downsample is None else self.downsample(x)
        return F.Activation(self.body(x) + skip, act_type="relu")


class BasicBlockV1(_BlockV1):
    """3x3 ×2 (reference resnet.py:BasicBlockV1)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        specs = [(channels, 3, stride, 1, in_channels),
                 (channels, 3, 1, 1, channels)]
        super().__init__(specs, channels, stride, downsample, in_channels,
                         **kwargs)


class BottleneckV1(_BlockV1):
    """1x1 → 3x3 → 1x1 (reference resnet.py:BottleneckV1)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        mid = channels // 4
        # the 1x1 convs keep their bias — a reference quirk preserved for
        # parameter-file compatibility (reference BottleneckV1 uses the
        # Conv2D bias default for both pointwise convs)
        specs = [(mid, 1, stride, 0, 0, True),
                 (mid, 3, 1, 1, mid),
                 (channels, 1, 1, 0, 0, True)]
        super().__init__(specs, channels, stride, downsample, in_channels,
                         **kwargs)


class _BlockV2(HybridBlock):
    """Pre-activation residual block (identity mappings): the shortcut taps
    the post-BN-relu stream, convs carry no BN after the last one."""

    def __init__(self, conv_specs, channels, stride, downsample,
                 in_channels, **kwargs):
        super().__init__(**kwargs)
        self._bns = []
        self._convs = []
        for i, (ch, k, st, pad, in_ch) in enumerate(conv_specs):
            bn = nn.BatchNorm()
            conv = _conv(ch, k, st, pad, in_ch)
            setattr(self, "bn%d" % (i + 1), bn)
            setattr(self, "conv%d" % (i + 1), conv)
            self._bns.append(bn)
            self._convs.append(conv)
        self.downsample = _shortcut(channels, stride, in_channels,
                                    with_bn=False) if downsample else None

    def hybrid_forward(self, F, x):
        skip = x
        for i, (bn, conv) in enumerate(zip(self._bns, self._convs)):
            x = F.Activation(bn(x), act_type="relu")
            if i == 0 and self.downsample is not None:
                skip = self.downsample(x)
            x = conv(x)
        return x + skip


class BasicBlockV2(_BlockV2):
    """Pre-activation 3x3 ×2 (reference resnet.py:BasicBlockV2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        specs = [(channels, 3, stride, 1, in_channels),
                 (channels, 3, 1, 1, channels)]
        super().__init__(specs, channels, stride, downsample, in_channels,
                         **kwargs)


class BottleneckV2(_BlockV2):
    """Pre-activation bottleneck (reference resnet.py:BottleneckV2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        mid = channels // 4
        specs = [(mid, 1, 1, 0, 0),
                 (mid, 3, stride, 1, mid),
                 (channels, 1, 1, 0, 0)]
        super().__init__(specs, channels, stride, downsample, in_channels,
                         **kwargs)


def _stage(block, count, channels, stride, index, in_channels):
    """One resolution stage: a strided (possibly projected) block followed
    by count-1 identity blocks."""
    stage = nn.HybridSequential(prefix="stage%d_" % index)
    with stage.name_scope():
        stage.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=""))
        for _ in range(1, count):
            stage.add(block(channels, 1, False, in_channels=channels,
                            prefix=""))
    return stage


def _stem(channels, thumbnail):
    """Input stem: 3x3 for CIFAR-size inputs, 7x7+maxpool for ImageNet."""
    if thumbnail:
        return [_conv3x3(channels, 1, 0)]
    return [nn.Conv2D(channels, 7, 2, 3, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), nn.MaxPool2D(3, 2, 1)]


class _ResNet(HybridBlock):
    """Shared features→output skeleton for both versions."""

    def __init__(self, classes, **kwargs):
        super().__init__(**kwargs)
        self._classes = classes

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """ResNet V1 (reference resnet.py:ResNetV1)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(classes, **kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = _seq(*_stem(channels[0], thumbnail))
            for i, count in enumerate(layers):
                self.features.add(_stage(block, count, channels[i + 1],
                                         1 if i == 0 else 2, i + 1,
                                         channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])


class ResNetV2(_ResNet):
    """ResNet V2 (reference resnet.py:ResNetV2)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(classes, **kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            # leading data BN (no affine) then the same stem as V1
            self.features = _seq(nn.BatchNorm(scale=False, center=False),
                                 *_stem(channels[0], thumbnail))
            width = channels[0]
            for i, count in enumerate(layers):
                self.features.add(_stage(block, count, channels[i + 1],
                                         1 if i == 0 else 2, i + 1, width))
                width = channels[i + 1]
            for tail in (nn.BatchNorm(), nn.Activation("relu"),
                         nn.GlobalAvgPool2D(), nn.Flatten()):
                self.features.add(tail)
            self.output = nn.Dense(classes, in_units=width)


# depth → (block kind, per-stage counts, per-stage channels)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Factory (reference resnet.py:get_resnet); ``ctx`` and ``root`` are
    accepted and unused, as in the JAX package without ``pretrained``."""
    if num_layers not in resnet_spec:
        raise MXNetError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, str(sorted(resnet_spec))))
    if version not in (1, 2):
        raise MXNetError(
            "Invalid resnet version: %d. Options are 1 and 2." % version)
    refuse_pretrained(pretrained)
    kind, layers, channels = resnet_spec[num_layers]
    net_cls = resnet_net_versions[version - 1]
    block_cls = resnet_block_versions[version - 1][kind]
    return net_cls(block_cls, layers, channels, **kwargs)


def _factory(version, depth):
    name = "resnet%d_v%d" % (depth, version)
    return named_factory(get_resnet, name,
                         "ResNet-%d V%d (reference resnet.py:%s)."
                         % (depth, version, name), version, depth)


resnet18_v1 = _factory(1, 18)
resnet34_v1 = _factory(1, 34)
resnet50_v1 = _factory(1, 50)
resnet101_v1 = _factory(1, 101)
resnet152_v1 = _factory(1, 152)
resnet18_v2 = _factory(2, 18)
resnet34_v2 = _factory(2, 34)
resnet50_v2 = _factory(2, 50)
resnet101_v2 = _factory(2, 101)
resnet152_v2 = _factory(2, 152)
