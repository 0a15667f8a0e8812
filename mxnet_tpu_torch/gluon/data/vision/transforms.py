"""Vision transforms: the port of
``mxnet_tpu/gluon/data/vision/transforms.py`` (all 15 names).

A transform takes an HWC image NDArray (``ToTensor`` and ``Normalize``
an image or an NHWC batch) and computes on its device, returning one on
the same context; the vision datasets keep their images on the host, so
there the transforms run on the host. ``Resize``, ``CenterCrop`` and
``RandomResizedCrop`` resize with the port's ``image.imresize`` weights
(``jax.image.resize``'s antialiased bilinear weights, as the JAX
transforms use), as two matrix products on the image's device, in float32:
an integer image comes out float32, a float one keeps its dtype. The
random transforms draw from :func:`mx.random.np_rng` in the JAX
package's order, so one seed gives the same crops, flips and factors.
"""
from __future__ import annotations

import numpy as np
import torch

from ....ndarray import ndarray as nd_mod
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = [
    "Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
    "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
    "RandomBrightness", "RandomContrast", "RandomSaturation", "RandomHue",
    "RandomColorJitter", "RandomLighting",
]


def _np_rng():
    from .... import random as _random

    return _random.np_rng()


def _const(a, x):
    """A float32 constant on ``x``'s context."""
    return nd_mod.array(np.asarray(a, np.float32), ctx=x.context)


class Compose(Sequential):
    """The transforms in order (a plain callable is wrapped)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t if isinstance(t, Block) else _Lambda(t))


class _Lambda(Block):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, x):
        return self._fn(x)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC (or NHWC) in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""

    def hybrid_forward(self, F, x):
        x = x.astype("float32") / 255.0
        if x.ndim == 3:
            return x.transpose((2, 0, 1))
        return x.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """``(x - mean) / std`` a channel, on a CHW input."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32)
        self._std = np.asarray(std, dtype=np.float32)

    def hybrid_forward(self, F, x):
        return (x - _const(self._mean.reshape((-1, 1, 1)), x)) \
            / _const(self._std.reshape((-1, 1, 1)), x)


def _resize_hwc(x, size):
    """``x`` (HWC or NHWC) resized to ``size`` (w, h) on its own device,
    with ``image.imresize``'s antialiased bilinear weights, height then
    width, in float32; integer images come out float32."""
    from ....image import _triangle, _weight_mat

    if isinstance(size, int):
        size = (size, size)
    w, h = size
    t = x._data.detach().to(torch.float32)
    lead = t.ndim - 3
    for axis, n in ((lead, h), (lead + 1, w)):
        m = t.shape[axis]
        if m == n:
            continue
        wm = torch.from_numpy(_weight_mat(m, n, _triangle)).to(t.device)
        t = torch.movedim(torch.tensordot(t, wm, dims=([axis], [0])), -1,
                          axis)
    out = nd_mod.NDArray(t.contiguous())
    if np.issubdtype(np.dtype(x.dtype), np.floating) \
            and np.dtype(x.dtype) != np.float32:
        out = out.astype(x.dtype)
    return out


class Resize(Block):
    """Resize to ``size`` (an int, or (w, h)); with ``keep_ratio`` and an
    int, the shorter side becomes ``size``."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        if isinstance(self._size, int) and self._keep:
            h, w = x.shape[0], x.shape[1]
            if h < w:
                size = (int(self._size * w / h), self._size)
            else:
                size = (self._size, int(self._size * h / w))
        else:
            size = self._size
        return _resize_hwc(x, size)


class CenterCrop(Block):
    """The central (w, h) crop, after a resize up where the image is
    smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        if H < h or W < w:
            x = _resize_hwc(x, (max(w, W), max(h, H)))
            H, W = x.shape[0], x.shape[1]
        y0, x0 = (H - h) // 2, (W - w) // 2
        return x[y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    """A crop of random area (``scale`` of the image's) and aspect ratio
    (log-uniform in ``ratio``), resized to ``size``; ten tries, then the
    center crop."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        rng = _np_rng()
        H, W = x.shape[0], x.shape[1]
        area = H * W
        log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
        for _ in range(10):
            target_area = rng.uniform(*self._scale) * area
            aspect = np.exp(rng.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = rng.randint(0, W - w + 1)
                y0 = rng.randint(0, H - h + 1)
                return _resize_hwc(x[y0:y0 + h, x0:x0 + w, :], self._size)
        return CenterCrop(self._size).forward(x)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _np_rng().rand() < 0.5:
            return x.flip(axis=1)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if _np_rng().rand() < 0.5:
            return x.flip(axis=0)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def forward(self, x):
        return x.astype("float32") * _np_rng().uniform(*self._args)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def forward(self, x):
        alpha = _np_rng().uniform(*self._args)
        xf = x.astype("float32")
        return xf * alpha + xf.mean() * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0, 1 - saturation), 1 + saturation)

    def forward(self, x):
        alpha = _np_rng().uniform(*self._args)
        xf = x.astype("float32")
        coef = _const([0.299, 0.587, 0.114], x).reshape((1, 1, 3))
        gray = (xf * coef).sum(axis=2, keepdims=True)
        return xf * alpha + gray * (1 - alpha)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        alpha = _np_rng().uniform(-self._hue, self._hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      dtype=np.float32)
        tyiq = np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]], dtype=np.float32)
        ityiq = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], dtype=np.float32)
        t = ityiq @ bt @ tyiq
        return x.astype("float32").dot(_const(t.T, x))


class RandomColorJitter(Block):
    """The non-zero jitters of brightness, contrast, saturation and hue,
    in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness > 0:
            self._transforms.append(RandomBrightness(brightness))
        if contrast > 0:
            self._transforms.append(RandomContrast(contrast))
        if saturation > 0:
            self._transforms.append(RandomSaturation(saturation))
        if hue > 0:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        for i in _np_rng().permutation(len(self._transforms)):
            x = self._transforms[i].forward(x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA colour noise of scale ``alpha``."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = _np_rng().normal(0, self._alpha, size=(3,)).astype(
            np.float32)
        rgb = self._eigvec @ (self._eigval * alpha)
        return x.astype("float32") + _const(rgb.reshape((1, 1, 3)), x)
