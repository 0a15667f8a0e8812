"""The registry's tail: the port of ``mxnet_tpu/ops/misc_tail.py``.

Attention-score scaling (``_contrib_div_sqrt_dim``), the tutorial op
(``_contrib_quadratic``), functional slice assignment
(``_slice_assign``), the storage-keeping scatter ops (on a sparse input
they touch only the stored values, through the ex path), and the image
ops under their OpenCV names. The image ops run on the tensor's device
(resizing with ``image``'s antialiased kernels, the JAX package's
``jax.image.resize``), except decoding: ``_cvimdecode``/``_cvimread``
decode JPEG or PNG on the host with the port's own codecs (``image.py``;
the card's machine has no PIL), the JPEG codec picked by the output's
device, and put the pixels on that device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import REQUIRED, register, register_ex
from .sparse import SparseRep, csr_row_ids, densify

__all__ = []


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(attrs, x):
    """data / sqrt(data.shape[-1]) (reference transformer.cc:33)."""
    return x / float(np.sqrt(np.float32(x.shape[-1])))


@register("_contrib_quadratic",
          params={"a": (float, 0.0), "b": (float, 0.0), "c": (float, 0.0)},
          aliases=("_contrib_quadratic_function",))
def _quadratic(attrs, x):
    """a * x^2 + b * x + c (reference contrib/quadratic_op.cc)."""
    return attrs.a * x * x + attrs.b * x + attrs.c


def _assign_index(attrs, ndim):
    begin, end = tuple(attrs.begin), tuple(attrs.end)
    step = tuple(attrs.step) if attrs.step else (1,) * len(begin)
    if len(begin) != len(end) or len(step) != len(begin):
        raise MXNetError(
            "_slice_assign: begin/end/step lengths differ (%d/%d/%d)"
            % (len(begin), len(end), len(step)))
    idx = tuple(slice(b, e, s or 1) for b, e, s in zip(begin, end, step))
    return idx + (slice(None),) * (ndim - len(idx))


@register("_slice_assign",
          params={"begin": (tuple, REQUIRED), "end": (tuple, REQUIRED),
                  "step": (tuple, ())},
          inputs=("lhs", "rhs"), aliases=("_crop_assign",))
def _slice_assign(attrs, lhs, rhs):
    """lhs with lhs[begin:end:step] = rhs, as a new tensor (gradients
    reach both)."""
    out = lhs.clone()
    out[_assign_index(attrs, lhs.dim())] = rhs
    return out


@register("_slice_assign_scalar",
          params={"scalar": (float, 0.0), "begin": (tuple, REQUIRED),
                  "end": (tuple, REQUIRED), "step": (tuple, ())},
          inputs=("data",), aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(attrs, data):
    out = data.clone()
    out[_assign_index(attrs, data.dim())] = attrs.scalar
    return out


# ---------------------------------------------------------------------------
# storage-keeping scatter ops (reference elemwise_scatter_op.cc): the plain
# scalar ops on dense input; on sparse input only the stored values change
# and the result keeps the storage
# ---------------------------------------------------------------------------


def _scatter_scalar(name, fn):
    @register(name, params={"scalar": (float, 0.0)})
    def _dense(attrs, x, _fn=fn):
        return _fn(x, attrs.scalar)

    @register_ex(name)
    def _ex(attrs, x, _fn=fn):
        if not isinstance(x, SparseRep):
            return _fn(x, attrs.scalar)
        return SparseRep(x.stype, _fn(x.data, attrs.scalar), x.indices,
                         x.indptr, x.shape)


_scatter_scalar("_scatter_plus_scalar", lambda x, s: x + s)
_scatter_scalar("_scatter_minus_scalar", lambda x, s: x - s)


@register("_scatter_elemwise_div", inputs=("lhs", "rhs"))
def _scatter_elemwise_div_dense(attrs, lhs, rhs):
    return lhs / rhs


@register_ex("_scatter_elemwise_div")
def _scatter_elemwise_div_ex(attrs, lhs, rhs):
    """A sparse lhs over a dense rhs: only the stored values are divided
    and the result keeps lhs's storage."""
    if not isinstance(lhs, SparseRep):
        return lhs / (densify(rhs) if isinstance(rhs, SparseRep) else rhs)
    if isinstance(rhs, SparseRep):
        raise MXNetError("_scatter_elemwise_div expects a dense divisor")
    if lhs.stype == "row_sparse":
        denom = rhs.index_select(0, lhs.indices.to(torch.int64))
    else:
        denom = rhs[csr_row_ids(lhs), lhs.indices.to(torch.int64)]
    return SparseRep(lhs.stype, lhs.data / denom, lhs.indices, lhs.indptr,
                     lhs.shape)


# ---------------------------------------------------------------------------
# image ops (reference image_random.cc, image_io.cc)
# ---------------------------------------------------------------------------


@register("_image_to_tensor", aliases=("to_tensor",))
def _image_to_tensor(attrs, x):
    """HWC in [0, 255] -> CHW float32 in [0, 1]."""
    return torch.movedim(x.to(torch.float32) / 255.0, -1, -3)


def _float_tuple(v):
    if isinstance(v, str):
        body = v.strip().lstrip("([").rstrip(")]")
        return tuple(float(x) for x in body.split(",") if x.strip())
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


@register("_image_normalize",
          params={"mean": (_float_tuple, (0.0,)),
                  "std": (_float_tuple, (1.0,))},
          aliases=("image_normalize",))
def _image_normalize(attrs, x):
    """(x - mean) / std by channel of a CHW image; one value serves every
    channel."""
    c = x.shape[-3]
    mean = torch.tensor(attrs.mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(attrs.std, dtype=x.dtype, device=x.device)
    mean = mean.expand(c) if mean.numel() == 1 else mean
    std = std.expand(c) if std.numel() == 1 else std
    return (x - mean.reshape(c, 1, 1)) / std.reshape(c, 1, 1)


def resize_axis(x, axis, size, interp):
    """``x`` resized along ``axis`` to ``size`` as ``jax.image.resize``
    resizes (``image.py``'s kernels: 0 nearest, 1 and 3 bilinear, 2
    bicubic, 4 Lanczos-3, antialiased when shrinking); float32."""
    from ..image import _KERNELS, _triangle, _weight_mat

    m = x.shape[axis]
    if m == size:
        return x
    if interp == 0:
        idx = np.floor((np.arange(size, dtype=np.float32) + 0.5)
                       * np.float32(m) / np.float32(size)).astype(np.int64)
        return x.index_select(axis, torch.as_tensor(idx, device=x.device))
    wm = torch.as_tensor(_weight_mat(m, size, _KERNELS.get(interp,
                                                            _triangle)),
                         device=x.device)
    return torch.movedim(torch.tensordot(x, wm, dims=([axis], [0])), -1,
                         axis)


@register("_cvimresize", params={"w": (int, REQUIRED), "h": (int, REQUIRED),
                                 "interp": (int, 1)},
          aliases=("imresize",))
def _cvimresize(attrs, x):
    """Resize an HWC image to (h, w); an integer image is rounded and
    clipped back to its dtype."""
    out = x.to(torch.float32)
    out = resize_axis(resize_axis(out, 0, attrs.h, attrs.interp), 1,
                      attrs.w, attrs.interp)
    if not x.is_floating_point():
        info = torch.iinfo(x.dtype)
        out = torch.round(out).clamp(info.min, info.max).to(x.dtype)
    return out


def _border_index(n, lo, hi, mode):
    """The source index of each padded position along one axis, as
    ``np.pad``'s ``mode`` fills it."""
    return np.pad(np.arange(n), (lo, hi), mode=mode)


@register("_cvcopyMakeBorder",
          params={"top": (int, REQUIRED), "bot": (int, REQUIRED),
                  "left": (int, REQUIRED), "right": (int, REQUIRED),
                  "type": (int, 0), "value": (float, 0.0)},
          aliases=("copyMakeBorder",))
def _cv_copy_make_border(attrs, x):
    """Pad an HWC image: type 0 a constant border, 1 replicate, 2
    reflect, 3 wrap, 4 reflect-101 (OpenCV's border types)."""
    h, w = x.shape[0], x.shape[1]
    if attrs.type == 0:
        out = torch.full((h + attrs.top + attrs.bot,
                          w + attrs.left + attrs.right) + tuple(x.shape[2:]),
                         attrs.value, device=x.device).to(x.dtype)
        out[attrs.top:attrs.top + h, attrs.left:attrs.left + w] = x
        return out
    mode = {1: "edge", 2: "symmetric", 3: "wrap", 4: "reflect"}.get(
        attrs.type)
    if mode is None:
        raise MXNetError("_cvcopyMakeBorder: unsupported border type %d"
                         % attrs.type)
    rows = _border_index(h, attrs.top, attrs.bot, mode)
    cols = _border_index(w, attrs.left, attrs.right, mode)
    out = x.index_select(0, torch.as_tensor(rows, device=x.device))
    return out.index_select(1, torch.as_tensor(cols, device=x.device))


def _decode(raw: bytes, attrs, device):
    from ..image import decode_pixels

    img = decode_pixels(raw, attrs.flag, attrs.to_rgb,
                        lib=torch.device(device).type == "cuda")
    return torch.as_tensor(img, device=device)


@register("_cvimdecode", params={"flag": (int, 1), "to_rgb": (bool, True)},
          inputs=("buf",), aliases=("imdecode_op",))
def _cvimdecode(attrs, buf):
    """Decode a uint8 byte buffer (JPEG or PNG) to HWC uint8 pixels on the
    buffer's device: ``flag=0`` one gray channel, else RGB (BGR without
    ``to_rgb``). A host op, eager only, as every decode kernel."""
    raw = bytes(buf.detach().to(torch.uint8).cpu().numpy().tobytes())
    return _decode(raw, attrs, buf.device)


@register("_cvimread",
          params={"filename": (str, REQUIRED), "flag": (int, 1),
                  "to_rgb": (bool, True)}, inputs=())
def _cvimread(attrs):
    """Read and decode an image file (JPEG or PNG), onto ``ctx=`` or the
    current context."""
    from .tensor import out_device

    with open(attrs.filename, "rb") as f:
        raw = f.read()
    return _decode(raw, attrs, out_device(attrs))
