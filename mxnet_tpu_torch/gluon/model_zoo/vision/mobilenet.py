"""MobileNet v1 and v2 at width multipliers 1.0, 0.75, 0.5 and 0.25: the
port of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``, with the same
blocks and parameter names. Depthwise convolutions are grouped
convolutions (``groups`` = channels: cuDNN's depthwise kernels on the
card); v2's ReLU6 is the ``clip`` op. ``pretrained=True`` raises."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._builders import named_factory, refuse_pretrained

__all__ = [
    "MobileNet", "MobileNetV2",
    "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
    "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
    "mobilenet_v2_0_25",
    "get_mobilenet", "get_mobilenet_v2",
]

# v1's separable stack: (depthwise width, pointwise width, stride) a row,
# before the width multiplier
_V1_ROWS = [
    (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2), (256, 256, 1),
    (256, 512, 2), (512, 512, 1), (512, 512, 1), (512, 512, 1),
    (512, 512, 1), (512, 512, 1), (512, 1024, 2), (1024, 1024, 1),
]

# v2's inverted residuals: (in width, out width, expansion t, stride)
_V2_ROWS = [
    (32, 16, 1, 1),
    (16, 24, 6, 2), (24, 24, 6, 1),
    (24, 32, 6, 2), (32, 32, 6, 1), (32, 32, 6, 1),
    (32, 64, 6, 2), (64, 64, 6, 1), (64, 64, 6, 1), (64, 64, 6, 1),
    (64, 96, 6, 1), (96, 96, 6, 1), (96, 96, 6, 1),
    (96, 160, 6, 2), (160, 160, 6, 1), (160, 160, 6, 1),
    (160, 320, 6, 1),
]


class RELU6(HybridBlock):
    """min(max(x, 0), 6) (reference mobilenet.py:RELU6)."""

    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6)


def _unit(out, channels, kernel=1, stride=1, pad=0, groups=1, act="relu"):
    """conv, BN, then the activation ("relu", "relu6" or None)."""
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=groups,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    if act == "relu6":
        out.add(RELU6())
    elif act:
        out.add(nn.Activation(act))


def _separable(out, dw, pw, stride, act="relu"):
    """Depthwise 3 x 3 then pointwise 1 x 1: one v1 unit."""
    _unit(out, dw, kernel=3, stride=stride, pad=1, groups=dw, act=act)
    _unit(out, pw, act=act)


class LinearBottleneck(HybridBlock):
    """v2's inverted residual: expand 1 x 1, depthwise 3 x 3, project
    1 x 1 (no activation), with the input added where the shapes allow
    (reference mobilenet.py:LinearBottleneck)."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        wide = in_channels * t
        with self.name_scope():
            self.out = nn.HybridSequential()
            _unit(self.out, wide, act="relu6")
            _unit(self.out, wide, kernel=3, stride=stride, pad=1,
                  groups=wide, act="relu6")
            _unit(self.out, channels, act=None)

    def hybrid_forward(self, F, x):
        y = self.out(x)
        return y + x if self.use_shortcut else y


def _scaled(width, multiplier):
    return int(width * multiplier)


class MobileNet(HybridBlock):
    """MobileNet v1 (reference mobilenet.py:MobileNet)."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _unit(self.features, _scaled(32, multiplier), kernel=3,
                      stride=2, pad=1)
                for dw, pw, stride in _V1_ROWS:
                    _separable(self.features, _scaled(dw, multiplier),
                               _scaled(pw, multiplier), stride)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """MobileNet v2 (reference mobilenet.py:MobileNetV2)."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _unit(self.features, _scaled(32, multiplier), kernel=3,
                      stride=2, pad=1, act="relu6")
                for in_w, out_w, t, stride in _V2_ROWS:
                    self.features.add(LinearBottleneck(
                        in_channels=_scaled(in_w, multiplier),
                        channels=_scaled(out_w, multiplier),
                        t=t, stride=stride))
                head = _scaled(1280, multiplier) if multiplier > 1.0 \
                    else 1280
                _unit(self.features, head, act="relu6")
                self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(
                    nn.Conv2D(classes, 1, use_bias=False, prefix="pred_"),
                    nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    refuse_pretrained(pretrained)
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=None,
                     **kwargs):
    refuse_pretrained(pretrained)
    return MobileNetV2(multiplier, **kwargs)


def _factory(maker, multiplier, name):
    kind = "MobileNetV2" if maker is get_mobilenet_v2 else "MobileNet"
    return named_factory(maker, name,
                         "%s with width multiplier %.2f." % (kind, multiplier),
                         multiplier)


mobilenet1_0 = _factory(get_mobilenet, 1.0, "mobilenet1_0")
mobilenet0_75 = _factory(get_mobilenet, 0.75, "mobilenet0_75")
mobilenet0_5 = _factory(get_mobilenet, 0.5, "mobilenet0_5")
mobilenet0_25 = _factory(get_mobilenet, 0.25, "mobilenet0_25")
mobilenet_v2_1_0 = _factory(get_mobilenet_v2, 1.0, "mobilenet_v2_1_0")
mobilenet_v2_0_75 = _factory(get_mobilenet_v2, 0.75, "mobilenet_v2_0_75")
mobilenet_v2_0_5 = _factory(get_mobilenet_v2, 0.5, "mobilenet_v2_0_5")
mobilenet_v2_0_25 = _factory(get_mobilenet_v2, 0.25, "mobilenet_v2_0_25")
