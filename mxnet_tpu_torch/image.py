"""Image pipeline: decode, resize, augmenters, ``ImageIter`` and
``ImageDetIter``; the port of ``mxnet_tpu/image.py``.

Decoding and augmentation run on the host, as in MXNet (its CPU
augmenter threads): an image is a CPU NDArray from decode to the end of
its augmenter list; an iterator stacks a batch and moves it to its own
context in one copy. The context is fixed when the iterator is made (the
current context: the card, unless a ``with mx.cpu():`` scope asks for the
host; without a card that raises).

Three parts are the port's own, since the card's machine has neither PIL
nor OpenCV:

* JPEG: the port's baseline codec (``_imgcodec``), equal to the pixels
  and bytes PIL gives; the host library on the card's context, the plain
  numpy version under ``mx.cpu()``;
* a PNG codec on the standard library's ``zlib``: the encoder writes
  filter 0 on every row; the decoder takes 8-bit gray, gray+alpha, RGB
  and RGBA, non-interlaced, with all five row filters, and gives the
  pixels PIL gives (gray from RGB by PIL's integer formula, for JPEG
  too);
* :func:`imresize` is ``jax.image.resize`` (the JAX package's resize) in
  numpy: the same antialiased separable kernels, an axis whose size does
  not change is left as it is (so a resize to the same size is the
  identity), and integer images are rounded and clipped back.

Random draws (shuffles, crops, flips, jitters, PCA noise) come from
:func:`mx.random.np_rng` in the JAX package's order, so one seed gives
the same batches in both.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from . import _imgcodec
from .base import MXNetError
from .context import cpu, current_context
from .io import DataBatch, DataDesc, DataIter
from .ndarray import ndarray as nd_mod
from .ndarray.ndarray import NDArray

__all__ = [
    "imdecode", "imencode", "imread", "imresize", "resize_short",
    "fixed_crop", "random_crop", "center_crop", "color_normalize",
    "random_size_crop", "Augmenter", "SequentialAug", "RandomOrderAug",
    "ResizeAug", "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
    "CenterCropAug", "HorizontalFlipAug", "CastAug", "BrightnessJitterAug",
    "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
    "ColorJitterAug", "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
    "CreateAugmenter", "ImageIter", "DetAugmenter", "DetBorrowAug",
    "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
    "DetForceResizeAug", "CreateDetAugmenter", "ImageDetIter", "scale_down",
]


def _np_rng():
    from . import random as _random

    return _random.np_rng()


def _host(src) -> np.ndarray:
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _to_nd(a) -> NDArray:
    """A host image as a CPU NDArray (decode and augmentation run on the
    host)."""
    a = np.ascontiguousarray(a)
    return nd_mod.array(a, ctx=cpu(), dtype=a.dtype)


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # color type -> samples a pixel
_PNG_COLOR = {v: k for k, v in _PNG_CHANNELS.items()}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _png_encode(img: np.ndarray) -> bytes:
    """8-bit PNG of an (H, W) or (H, W, C) uint8 image, C in 1..4, every
    row with filter 0."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if c not in _PNG_COLOR:
        raise MXNetError("imencode: %d channels (1 to 4 expected)" % c)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[c], 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind, line, prev, bpp):
    """One scanline's bytes from its filtered bytes (PNG spec 9.2)."""
    if kind == 0:
        return line
    if kind == 1:  # Sub: a running sum per sample, mod 256
        return (line.reshape(-1, bpp).cumsum(axis=0).reshape(-1)
                & 0xFF).astype(np.uint8)
    if kind == 2:  # Up
        return ((line.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
    if kind not in (3, 4):
        raise MXNetError("imdecode: bad PNG filter type %d" % kind)
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if kind == 3:  # Average
            cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
        else:  # Paeth
            c = up[x - bpp] if x >= bpp else 0
            cur[x] = (cur[x] + _paeth(a, b, c)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _png_decode(buf: bytes) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit, non-interlaced gray, gray+alpha,
    RGB or RGBA PNG."""
    if buf[:8] != _PNG_SIG:
        raise MXNetError("imdecode: neither a JPEG nor a PNG image (the "
                         "port's two codecs)")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise MXNetError("imdecode: PNG chunk %r fails its CRC" % tag)
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise MXNetError("imdecode: PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = header
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        raise MXNetError("imdecode: PNG of bit depth %d, color type %d, "
                         "interlace %d is not ported yet (8-bit gray, RGB, "
                         "RGBA, non-interlaced)" % (depth, color, interlace))
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise MXNetError("imdecode: PNG data of %d bytes for %dx%dx%d"
                         % (raw.size, h, w, c))
    raw = raw.reshape(h, w * c + 1)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, c)
    return out.reshape(h, w, c)


def decode_pixels(buf: bytes, flag=1, to_rgb=1, lib=None) -> np.ndarray:
    """JPEG or PNG bytes -> HWC uint8 numpy, as :func:`imdecode` converts
    them; ``lib`` picks the JPEG codec (None: by the current context)."""
    if buf[:2] == b"\xff\xd8":
        img = _imgcodec.decode(buf, lib=lib)
    else:
        img = _png_decode(buf)
    c = img.shape[2]
    if flag == 0:
        if c >= 3:  # PIL's RGB -> L: (R 19595 + G 38470 + B 7471) / 2^16
            rgb = img[..., :3].astype(np.int64)
            img = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470
                    + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
            img = img[..., None]
        else:
            img = img[..., :1]
    else:
        img = img[..., :3] if c >= 3 else np.repeat(img[..., :1], 3, axis=2)
        if not to_rgb:
            img = img[:, :, ::-1]
    return np.ascontiguousarray(img)


def imdecode(buf, flag=1, to_rgb=1, to_numpy=False):
    """Decode JPEG or PNG bytes to an HWC uint8 image (reference
    image.py:imdecode): ``flag=1`` gives RGB (BGR with ``to_rgb=0``),
    ``flag=0`` one gray channel, as PIL converts them. A CPU NDArray, or
    numpy with ``to_numpy``. JPEG goes through the codec the current
    context picks (the host library on the card, the plain version under
    ``mx.cpu()``)."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = decode_pixels(bytes(buf), flag, to_rgb)
    return img if to_numpy else _to_nd(img)


def imread(filename, flag=1, to_rgb=1, to_numpy=False):
    """Read and decode a JPEG or PNG file (reference image.py:imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb, to_numpy)


def imencode(img, fmt=".jpg", quality=95):
    """Encode an HWC (or HW) image: baseline JPEG at ``quality`` for
    '.jpg'/'.jpeg' (PIL's bytes, 4:2:0 for RGB; the codec the current
    context picks), PNG otherwise, as the JAX package."""
    img = _host(img).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if fmt in (".jpg", ".jpeg"):
        return _imgcodec.encode(img, quality)
    return _png_encode(img)


# ---------------------------------------------------------------------------
# resize: jax.image.resize in numpy
# ---------------------------------------------------------------------------


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos3(x):
    y = 3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0)
    safe = np.where(x != 0, np.pi ** 2 * x ** 2, 1.0)
    out = np.where(x > 1e-3, y / safe, 1.0)
    return np.where(x > 3.0, 0.0, out)


_KERNELS = {1: _triangle, 2: _keys_cubic, 3: _triangle, 4: _lanczos3}


def _weight_mat(m, n, kernel):
    """(m, n) float32 interpolation weights from m inputs to n outputs
    (jax/_src/image/scale.py compute_weight_mat, antialiased)."""
    f32 = np.float32
    inv_scale = 1.0 / (n / m)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    weights = kernel(x).astype(f32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], weights, 0).astype(f32)


def imresize(src, w, h, interp=1):
    """Resize an HWC image to (h, w) (reference image.py:imresize):
    0 nearest, 1 and 3 bilinear, 2 bicubic, 4 Lanczos-3, all antialiased
    when shrinking. An integer image keeps its dtype (rounded, clipped)."""
    arr = _host(src)
    in_dtype = arr.dtype
    out = arr.astype(np.float32)
    for axis, size in ((0, h), (1, w)):
        m = out.shape[axis]
        if m == size:
            continue
        if interp == 0:
            idx = np.floor((np.arange(size, dtype=np.float32) + 0.5)
                           * np.float32(m) / np.float32(size)).astype(int)
            out = np.take(out, idx, axis=axis)
            continue
        wm = _weight_mat(m, size, _KERNELS.get(interp, _triangle))
        out = np.moveaxis(np.tensordot(out, wm, axes=([axis], [0])), -1,
                          axis).astype(np.float32)
    if np.issubdtype(in_dtype, np.integer):
        info = np.iinfo(in_dtype)
        out = np.clip(np.round(out), info.min, info.max).astype(in_dtype)
    return _to_nd(out)


def resize_short(src, size, interp=2):
    """Resize so the shorter side is ``size``."""
    h, w = src.shape[0], src.shape[1]
    if h > w:
        return imresize(src, size, size * h // w, interp)
    return imresize(src, size * w // h, size, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _to_nd(_host(src)[y0:y0 + h, x0:x0 + w, :])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    """A random crop of ``size`` (w, h), resized if the image is smaller
    (reference image.py:random_crop): (image, (x0, y0, w, h))."""
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _np_rng().randint(0, w - new_w + 1)
    y0 = _np_rng().randint(0, h - new_h + 1)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0, y0 = (w - new_w) // 2, (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """A crop of random area (a fraction of the image's, drawn from
    ``area``) and aspect ratio (log-uniform in ``ratio``), resized to
    ``size``; ten tries, then the center crop (reference
    image.py:random_size_crop)."""
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    rng = _np_rng()
    for _ in range(10):
        target_area = rng.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(rng.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = rng.randint(0, w - new_w + 1)
            y0 = rng.randint(0, h - new_h + 1)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


# ---------------------------------------------------------------------------
# augmenters
# ---------------------------------------------------------------------------


class Augmenter(object):
    """Base augmenter (reference image.py:Augmenter): ``aug(src)`` -> the
    augmented image."""

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """The augmenters of ``ts`` in order."""

    def __init__(self, ts):
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """The augmenters of ``ts`` in an order shuffled at each call."""

    def __init__(self, ts):
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _np_rng().shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        self.p = p

    def __call__(self, src):
        if _np_rng().rand() < self.p:
            return _to_nd(_host(src)[:, ::-1])
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


_GRAY_COEF = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)


class BrightnessJitterAug(Augmenter):
    """Scale by 1 + U(-brightness, brightness)."""

    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _np_rng().uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    """Blend with the image's mean gray, weight 1 + U(-contrast,
    contrast)."""

    def __init__(self, contrast):
        self.contrast = contrast
        self.coef = _GRAY_COEF

    def __call__(self, src):
        alpha = 1.0 + _np_rng().uniform(-self.contrast, self.contrast)
        gray = (src * _to_nd(self.coef)).sum()
        gray = (3.0 * (1.0 - alpha) / float(np.prod(src.shape))) * gray
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    """Blend with each pixel's gray, weight 1 + U(-saturation,
    saturation)."""

    def __init__(self, saturation):
        self.saturation = saturation
        self.coef = _GRAY_COEF

    def __call__(self, src):
        alpha = 1.0 + _np_rng().uniform(-self.saturation, self.saturation)
        gray = (src * _to_nd(self.coef)).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    """Rotate the hue by U(-hue, hue) half-turns, in YIQ."""

    def __init__(self, hue):
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype=np.float32)

    def __call__(self, src):
        alpha = _np_rng().uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      dtype=np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return src.dot(_to_nd(t))


class ColorJitterAug(RandomOrderAug):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise (reference image.py:LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def __call__(self, src):
        alpha = _np_rng().normal(0, self.alphastd, size=(3,)).astype(
            np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return src + _to_nd(rgb.reshape((1, 1, 3)))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        self.mean = None if mean is None else _to_nd(
            np.asarray(mean, dtype=np.float32))
        self.std = None if std is None else _to_nd(
            np.asarray(std, dtype=np.float32))

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    """With probability ``p``, gray by (0.21, 0.72, 0.07) in every
    channel."""

    def __init__(self, p):
        self.p = p
        self.mat = np.array([[0.21, 0.21, 0.21],
                             [0.72, 0.72, 0.72],
                             [0.07, 0.07, 0.07]], dtype=np.float32)

    def __call__(self, src):
        if _np_rng().rand() < self.p:
            src = src.dot(_to_nd(self.mat))
        return src


_MEAN = np.array([123.68, 116.28, 103.53])
_STD = np.array([58.395, 57.12, 57.375])
_PCA_EIGVAL = np.array([55.46, 4.794, 1.148])
_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]])


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list (reference image.py:CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise MXNetError("CreateAugmenter: rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _MEAN
    if std is True:
        std = _STD
    if mean is not None and np.any(np.asarray(mean) > 0):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------


class ImageIter(DataIter):
    """Image iterator over a .rec, a .lst with image files, or a list
    (reference image.py:ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise MXNetError("ImageIter: give path_imgrec, path_imglist or "
                             "imglist")
        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise MXNetError("ImageIter: data_shape (1 or 3, H, W) "
                             "expected, got %s" % (data_shape,))
        self._ctx = current_context()
        self._lib = _imgcodec.use_library(self._ctx)  # the JPEG codec
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.path_root = path_root
        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            from . import recordio

            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(idx_path,
                                                         path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        elif path_imglist:
            entries = {}
            with open(path_imglist) as fin:
                for line in fin:
                    fields = line.strip().split("\t")
                    entries[int(fields[0])] = (
                        np.array(fields[1:-1], dtype=np.float32), fields[-1])
            self.imglist = entries
            self.seq = list(entries.keys())
        else:
            self.imglist = {
                i: (np.array(img[:-1], dtype=np.float32) if len(img) > 2
                    else np.float32(img[0]), img[-1])
                for i, img in enumerate(imglist)}
            self.seq = list(self.imglist.keys())
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                         "mean", "std", "brightness", "contrast",
                         "saturation", "hue", "pca_noise", "rand_gray",
                         "inter_method")})
        else:
            self.auglist = aug_list
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self.shuffle and self.seq is not None:
            _np_rng().shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """The next (label, encoded image bytes)."""
        from . import recordio

        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                header, img = recordio.unpack(self.imgrec.read_idx(idx))
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root or "", fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _batch(self, sample):
        """Fill one batch with ``sample()`` -> (CHW float32, label), the
        last batch padded by repeating its last sample."""
        data, labels = [], []
        pad = 0
        try:
            while len(data) < self.batch_size:
                chw, label = sample()
                data.append(chw)
                labels.append(label)
        except StopIteration:
            if not data:
                raise
            pad = self.batch_size - len(data)
            data += [data[-1]] * pad
            labels += [labels[-1]] * pad
        return DataBatch(
            [nd_mod.array(np.stack(data), ctx=self._ctx)],
            [nd_mod.array(np.asarray(labels, dtype=np.float32),
                          ctx=self._ctx)],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)

    def next(self):
        def sample():
            label, s = self.next_sample()
            img = _to_nd(decode_pixels(bytes(s), 1 if self.data_shape[0] == 3
                                       else 0, lib=self._lib))
            for aug in self.auglist:
                img = aug(img)
            return img.asnumpy().transpose(2, 0, 1).astype(np.float32), label

        return self._batch(sample)


# ---------------------------------------------------------------------------
# detection (reference python/mxnet/image/detection.py): labels ride the
# .rec header's array label as [header_width, object_width, (extra header),
# obj0_cls, obj0_xmin, obj0_ymin, obj0_xmax, obj0_ymax, obj1_cls, ...],
# coordinates normalized to [0, 1]
# ---------------------------------------------------------------------------


class DetAugmenter(object):
    """Transforms (image, label (N, 5+)) together."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only augmenter that keeps the geometry (cast, color)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Random horizontal flip of the image and its boxes."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _np_rng().rand() < self.p:
            src = _to_nd(_host(src)[:, ::-1])
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random crop keeping the boxes that stay covered by at least
    ``min_object_covered`` of their area (reference
    detection.py:DetRandomCropAug, as the JAX package simplifies it)."""

    def __init__(self, min_object_covered=0.3, min_crop_size=0.3,
                 max_crop_size=1.0, max_attempts=25):
        self.min_object_covered = min_object_covered
        self.min_crop_size = min_crop_size
        self.max_crop_size = max_crop_size
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = _host(src)
        h, w = arr.shape[:2]
        rng = _np_rng()
        for _ in range(self.max_attempts):
            scale = rng.uniform(self.min_crop_size, self.max_crop_size)
            cw, ch = int(w * scale), int(h * scale)
            if cw < 1 or ch < 1:
                continue
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            new_label = self._crop_boxes(label, x0 / w, y0 / h, cw / w,
                                         ch / h)
            if len(new_label):
                return _to_nd(arr[y0:y0 + ch, x0:x0 + cw]), new_label
        return src, label

    def _crop_boxes(self, label, cx, cy, cw, ch):
        out = []
        for row in label:
            _cls, xmin, ymin, xmax, ymax = row[:5]
            ix0, iy0 = max(xmin, cx), max(ymin, cy)
            ix1, iy1 = min(xmax, cx + cw), min(ymax, cy + ch)
            area = max(0.0, xmax - xmin) * max(0.0, ymax - ymin)
            inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
            if area <= 0 or inter / area < self.min_object_covered:
                continue
            new = np.array(row, dtype=np.float32)
            new[1] = (ix0 - cx) / cw
            new[2] = (iy0 - cy) / ch
            new[3] = (ix1 - cx) / cw
            new[4] = (iy1 - cy) / ch
            out.append(new)
        return np.asarray(out, dtype=np.float32).reshape(-1, label.shape[1])


class DetRandomPadAug(DetAugmenter):
    """Random expansion onto a ``pad_val`` canvas up to
    ``max_pad_scale``, boxes rescaled (reference
    detection.py:DetRandomPadAug)."""

    def __init__(self, max_pad_scale=2.0, pad_val=127):
        self.max_pad_scale = max_pad_scale
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _host(src)
        h, w = arr.shape[:2]
        rng = _np_rng()
        scale = rng.uniform(1.0, self.max_pad_scale)
        nw, nh = int(w * scale), int(h * scale)
        if nw <= w or nh <= h:
            return src, label
        x0 = rng.randint(0, nw - w + 1)
        y0 = rng.randint(0, nh - h + 1)
        canvas = np.full((nh, nw) + arr.shape[2:], self.pad_val, arr.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = arr
        label = label.copy()
        label[:, 1] = (label[:, 1] * w + x0) / nw
        label[:, 2] = (label[:, 2] * h + y0) / nh
        label[:, 3] = (label[:, 3] * w + x0) / nw
        label[:, 4] = (label[:, 4] * h + y0) / nh
        return _to_nd(canvas), label


class DetForceResizeAug(DetAugmenter):
    """Resize to an exact size; normalized boxes are unchanged."""

    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        return ForceResizeAug(self.size, self.interp)(src), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None, brightness=0,
                       contrast=0, saturation=0, min_object_covered=0.3,
                       max_attempts=25, pad_val=127, inter_method=2):
    """The detection augmenter list (reference
    detection.py:CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(
            min_object_covered=min_object_covered,
            max_attempts=max_attempts))
    if rand_pad > 0:
        auglist.append(DetRandomPadAug(pad_val=pad_val))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetForceResizeAug((data_shape[2], data_shape[1]),
                                     inter_method))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                   saturation)))
    if mean is not None or std is not None:
        if mean is True or mean is None:
            mean = _MEAN
        if std is True or std is None:
            std = _STD
        auglist.append(DetBorrowAug(CastAug()))
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator (reference detection.py:ImageDetIter): image
    batches plus object labels (batch, max_objects, object_width), short
    rows padded with -1 (no class), the layout MultiBoxTarget reads."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, shuffle=False,
                 aug_list=None, imglist=None, label_shape=None, **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_pad", "rand_mirror",
                         "mean", "std", "brightness", "contrast",
                         "saturation", "min_object_covered", "max_attempts",
                         "pad_val", "inter_method")})
        # the (image, label) augmenters run in next(); the base list is empty
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle, aug_list=[],
                         imglist=imglist)
        self.det_auglist = aug_list
        if label_shape is None:
            label_shape = self._estimate_label_shape()
        self.label_shape = tuple(label_shape)

    @staticmethod
    def _parse_label(label):
        """The flat detection label as (N, width) object rows."""
        raw = np.asarray(label, dtype=np.float32).ravel()
        if raw.size < 2:
            raise MXNetError("ImageDetIter: label too short for detection")
        header_width, obj_width = int(raw[0]), int(raw[1])
        if obj_width < 5:
            raise MXNetError("ImageDetIter: object width %d < 5" % obj_width)
        body = raw[header_width:]
        n = body.size // obj_width
        return body[:n * obj_width].reshape(n, obj_width)

    def _estimate_label_shape(self):
        """The most objects an image holds, and the widest object row."""
        max_count, width = 0, 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                parsed = self._parse_label(label)
                max_count = max(max_count, parsed.shape[0])
                width = max(width, parsed.shape[1])
        except StopIteration:
            pass
        self.reset()
        return (max(1, max_count), width)

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size,) + self.label_shape)]

    def next(self):
        def sample():
            label, s = self.next_sample()
            img = _to_nd(decode_pixels(bytes(s), 1 if self.data_shape[0] == 3
                                       else 0, lib=self._lib))
            parsed = self._parse_label(label)
            for aug in self.det_auglist:
                img, parsed = aug(img, parsed)
            full = np.full(self.label_shape, -1.0, dtype=np.float32)
            n = min(parsed.shape[0], self.label_shape[0])
            full[:n, :parsed.shape[1]] = parsed[:n]
            return img.asnumpy().transpose(2, 0, 1).astype(np.float32), full

        return self._batch(sample)

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.label_shape = tuple(label_shape)


def scale_down(src_size, size):
    """Clamp a crop size (w, h) to the image size, keeping its aspect
    (reference image.py:scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)
