"""Inception v3: the port of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``, with the same blocks
and parameter names. Each mixed block is a ``HybridConcurrent`` of
branches, each branch a list of ``(channels, kernel, stride, padding)``
convolutions (conv, BN with eps 1e-3, relu), optionally after an
``"avg"`` or ``"max"`` pool. ``pretrained=True`` raises."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ...contrib.nn import HybridConcurrent
from ._builders import refuse_pretrained

__all__ = ["Inception3", "inception_v3"]


def _cbr(channels, kernel, stride=1, padding=0):
    """conv (no bias), BN (eps 1e-3), relu."""
    unit = nn.HybridSequential(prefix="")
    unit.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                       padding=padding, use_bias=False))
    unit.add(nn.BatchNorm(epsilon=0.001))
    unit.add(nn.Activation("relu"))
    return unit


def _branch(*steps):
    """An optional leading "avg"/"max" pool, then conv specs."""
    seq = nn.HybridSequential(prefix="")
    for step in steps:
        if step == "avg":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif step == "max":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        else:
            seq.add(_cbr(*step))
    return seq


def _mixed(prefix, *branch_makers):
    """Branches concatenated along the channels. Takes builders, not
    blocks: the branches must be made inside the block's name scope for
    its prefix (A1_, B_, ...) to reach their parameter names."""
    block = HybridConcurrent(axis=1, prefix=prefix)
    with block.name_scope():
        for make in branch_makers:
            block.add(make())
    return block


def _block_a(pool_features, prefix):
    return _mixed(
        prefix,
        lambda: _branch((64, 1)),
        lambda: _branch((48, 1), (64, 5, 1, 2)),
        lambda: _branch((64, 1), (96, 3, 1, 1), (96, 3, 1, 1)),
        lambda: _branch("avg", (pool_features, 1)))


def _block_b(prefix):
    return _mixed(
        prefix,
        lambda: _branch((384, 3, 2)),
        lambda: _branch((64, 1), (96, 3, 1, 1), (96, 3, 2)),
        lambda: _branch("max"))


def _block_c(c7, prefix):
    return _mixed(
        prefix,
        lambda: _branch((192, 1)),
        lambda: _branch((c7, 1), (c7, (1, 7), 1, (0, 3)),
                        (192, (7, 1), 1, (3, 0))),
        lambda: _branch((c7, 1), (c7, (7, 1), 1, (3, 0)),
                        (c7, (1, 7), 1, (0, 3)), (c7, (7, 1), 1, (3, 0)),
                        (192, (1, 7), 1, (0, 3))),
        lambda: _branch("avg", (192, 1)))


def _block_d(prefix):
    return _mixed(
        prefix,
        lambda: _branch((192, 1), (320, 3, 2)),
        lambda: _branch((192, 1), (192, (1, 7), 1, (0, 3)),
                        (192, (7, 1), 1, (3, 0)), (192, 3, 2)),
        lambda: _branch("max"))


def _fork(stem_steps):
    """An E-block branch: a stem, then a 1x3 / 3x1 split concatenated."""
    seq = nn.HybridSequential(prefix="")
    seq.add(_branch(*stem_steps))
    split = HybridConcurrent(axis=1, prefix="")
    split.add(_branch((384, (1, 3), 1, (0, 1))))
    split.add(_branch((384, (3, 1), 1, (1, 0))))
    seq.add(split)
    return seq


def _block_e(prefix):
    return _mixed(
        prefix,
        lambda: _branch((320, 1)),
        lambda: _fork([(384, 1)]),
        lambda: _fork([(448, 1), (384, 3, 1, 1)]),
        lambda: _branch("avg", (192, 1)))


def _feature_layers():
    """The 299 x 299 feature pipeline, stem through the mixed blocks."""
    yield _cbr(32, 3, 2)
    yield _cbr(32, 3)
    yield _cbr(64, 3, 1, 1)
    yield nn.MaxPool2D(pool_size=3, strides=2)
    yield _cbr(80, 1)
    yield _cbr(192, 3)
    yield nn.MaxPool2D(pool_size=3, strides=2)
    yield _block_a(32, "A1_")
    yield _block_a(64, "A2_")
    yield _block_a(64, "A3_")
    yield _block_b("B_")
    yield _block_c(128, "C1_")
    yield _block_c(160, "C2_")
    yield _block_c(160, "C3_")
    yield _block_c(192, "C4_")
    yield _block_d("D_")
    yield _block_e("E1_")
    yield _block_e("E2_")
    yield nn.AvgPool2D(pool_size=8)
    yield nn.Dropout(0.5)


class Inception3(HybridBlock):
    """Inception v3 (reference inception.py:Inception3); input 299 x 299
    (the head's 8 x 8 average pool)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for layer in _feature_layers():
                self.features.add(layer)
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    refuse_pretrained(pretrained)
    return Inception3(**kwargs)
