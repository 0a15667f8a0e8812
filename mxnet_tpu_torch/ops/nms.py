"""Greedy non-maximum suppression: the detection path's kernel and its
plain version.

The port of ``mxnet_tpu/ops/pallas_kernels.py:52-118`` (``nms_keep`` over
the Pallas ``_nms_kernel``). Where the JAX package runs one image per
call and vmaps over the batch (``detection.py:127-134``, ``:324-384``),
every function here takes the whole batch:

* ``boxes`` (B, N, 4) corner-format float32, already sorted by score
  (descending) within each image;
* ``cls`` (B, N) float32 class ids (-1 = no class);
* ``valid`` (B, N) bool;
* returns ``keep`` (B, N) bool: box i is kept when it is valid and no
  earlier kept box of the same class (any class under ``force_suppress``)
  overlaps it with IoU > ``overlap_thresh``.

Three entry points:

* :func:`nms_keep_reference` — the plain PyTorch version: the CPU path,
  and the kernel's oracle on the card;
* :func:`nms_keep_cuda` — the wrapper of the hand-written CUDA kernels
  ``ops/csrc/nms.cu``: CUDA tensors only, checked for dtype, shape and
  contiguity, three launches for the whole batch whose grids and
  workspaces follow from (B, N) alone (:func:`nms_plan`), raising on a
  CUDA error, and counted in ``nms_keep_cuda.launches`` (one a call);
* :func:`nms_keep` — the dispatcher the detection ops call: a CUDA tensor
  goes to the kernel, a CPU tensor to the plain version, a ``meta`` tensor
  (shape inference) gets an empty mask of the right shape, anything else
  raises. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import _build

__all__ = ["nms_keep", "nms_keep_cuda", "nms_keep_reference", "nms_plan",
           "CAP", "MAX_BOXES", "MAX_BATCH"]

#: the most boxes an image may hold: the scan keeps ceil(N / 64) words of
#: removed bits in 48 KB of shared memory
MAX_BOXES = 64 * 6144
#: the most images a call may hold: the mask pass's grid has one y per image
MAX_BATCH = 65535
#: an image of at most CAP valid boxes is finished in shared memory by the
#: block that compacts it; the kernel's kCap, checked at launch
CAP = 256
#: mask-pass blocks (of 8 warps, a quarter tile each) the plan aims for on
#: each SM, over the whole batch
_MASK_BLOCKS_PER_SM = 4
_MASK_WARPS = 8


class NmsPlan(NamedTuple):
    """What a call of the kernels needs, from (B, N) alone: ``words``
    64-box groups of an image, ``tiles`` = words (words + 1) / 2
    upper-triangle mask tiles of 64 words each an image (the mask
    workspace is (B, tiles * 64) int64), and ``mask_blocks`` blocks of 8
    warps an image in the mask pass's grid-stride loop over 4 words^2
    quarter-tile slots, one slot a warp."""
    words: int
    tiles: int
    mask_blocks: int


def nms_plan(b, n, sms):
    """The kernels' plan for B images of N boxes on a card of ``sms``
    streaming multiprocessors. No count of valid boxes enters it, so a
    call's grids and workspaces are fixed by shape (a CUDA graph can
    replay it on new boxes)."""
    words = (n + 63) // 64
    blocks = max(1, min(-(-4 * words * words // _MASK_WARPS),
                        _MASK_BLOCKS_PER_SM * sms // max(b, 1)))
    return NmsPlan(words, words * (words + 1) // 2, blocks)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(boxes, cls, valid):
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise MXNetError("nms_keep: boxes of shape (B, N, 4) expected, got %s"
                         % (tuple(boxes.shape),))
    bn = tuple(boxes.shape[:2])
    if tuple(cls.shape) != bn or tuple(valid.shape) != bn:
        raise MXNetError("nms_keep: cls %s and valid %s must be %s"
                         % (tuple(cls.shape), tuple(valid.shape), bn))
    for name, t in (("cls", cls), ("valid", valid)):
        if t.device != boxes.device:
            raise MXNetError("nms_keep: %s on %s, boxes on %s"
                             % (name, t.device, boxes.device))


def nms_keep_reference(boxes, cls, valid, overlap_thresh, force_suppress):
    """Plain PyTorch greedy NMS, the Pallas kernel's loop batched: for
    i = 0..N-1 in order, a kept box i clears every later box j it
    suppresses. The IoU keeps the kernel's order of operations. A box
    that is valid in no image suppresses nothing anywhere, so the loop
    visits only the indices valid in some image."""
    _check(boxes, cls, valid)
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    cls = cls.float()
    keep = valid.clone().bool()
    later = torch.arange(boxes.shape[1], device=boxes.device)
    for i in valid.any(dim=0).nonzero().flatten().tolist():
        keep_i = keep[:, i:i + 1]
        iw = (torch.minimum(x2, x2[:, i:i + 1])
              - torch.maximum(x1, x1[:, i:i + 1])).clamp_min(0.0)
        ih = (torch.minimum(y2, y2[:, i:i + 1])
              - torch.maximum(y1, y1[:, i:i + 1])).clamp_min(0.0)
        inter = iw * ih
        iou = inter / torch.clamp_min(area + area[:, i:i + 1] - inter, 1e-12)
        hit = (iou > overlap_thresh) & (later > i) & keep_i
        if not force_suppress:
            hit &= cls == cls[:, i:i + 1]
        keep &= ~hit
    return keep


def _bind(lib: ctypes.CDLL):
    fn = lib.nms_keep_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nms_keep_cuda(boxes, cls, valid, overlap_thresh, force_suppress):
    """The CUDA kernel on one batch: boxes (B, N, 4) and cls (B, N)
    float32, valid (B, N) bool, all contiguous on one card."""
    _check(boxes, cls, valid)
    if not boxes.is_cuda:
        raise MXNetError("nms_keep_cuda: CUDA tensors expected, got %s"
                         % (boxes.device,))
    if boxes.dtype != torch.float32 or cls.dtype != torch.float32:
        raise MXNetError("nms_keep_cuda: boxes and cls must be float32, got "
                         "%s / %s" % (boxes.dtype, cls.dtype))
    if valid.dtype != torch.bool:
        raise MXNetError("nms_keep_cuda: valid must be bool, got %s"
                         % (valid.dtype,))
    for name, t in (("boxes", boxes), ("cls", cls), ("valid", valid)):
        if not t.is_contiguous():
            raise MXNetError("nms_keep_cuda: %s must be contiguous" % name)
    b, n = boxes.shape[0], boxes.shape[1]
    if n > MAX_BOXES or b > MAX_BATCH:
        raise MXNetError("nms_keep_cuda: %d images of %d boxes, at most %d "
                         "of %d" % (b, n, MAX_BATCH, MAX_BOXES))
    dev = boxes.device
    keep = torch.empty((b, n), dtype=torch.bool, device=dev)
    if keep.numel() == 0:
        return keep
    plan = nms_plan(b, n, _sm_count(dev.index if dev.index is not None
                                    else torch.cuda.current_device()))
    # compacted indices of the valid boxes (B, N), then the counts (B,)
    comp = torch.empty(b * n + b, dtype=torch.int32, device=dev)
    # compacted boxes (B, N, 4), then their areas and classes (B, N, 2)
    cbox = torch.empty(b * n * 6, dtype=torch.float32, device=dev)
    # upper-triangle 64 x 64 tiles of the compacted boxes' bit mask, for
    # images above the cap; only tiles under the count are written or read
    mask = torch.empty((b, plan.tiles * 64), dtype=torch.int64, device=dev)
    fn = _bind(_build.load("nms"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(boxes.data_ptr(), cls.data_ptr(), valid.data_ptr(),
                 comp.data_ptr(), comp.data_ptr() + 4 * b * n,
                 cbox.data_ptr(), cbox.data_ptr() + 16 * b * n,
                 mask.data_ptr(), keep.data_ptr(), b, n,
                 float(overlap_thresh), int(bool(force_suppress)), CAP,
                 plan.mask_blocks, stream)
    if err == -1:
        raise MXNetError("nms_keep: the plan does not match the built kernel "
                         "(cap %d, %d mask blocks)" % (CAP, plan.mask_blocks))
    if err != 0:
        raise MXNetError("nms_keep kernel launch failed: CUDA error %d" % err)
    nms_keep_cuda.launches += 1
    return keep


#: kernel launches since the count was last set to 0
nms_keep_cuda.launches = 0


def nms_keep(boxes, cls, valid, overlap_thresh, force_suppress):
    """Keep mask of greedy NMS over score-sorted boxes, (B, N) bool: the
    kernel for CUDA tensors, the plain version for CPU tensors, an empty
    mask for ``meta`` tensors."""
    dev = boxes.device.type
    if dev == "cuda":
        return nms_keep_cuda(boxes.float().contiguous(),
                             cls.float().contiguous(),
                             valid.bool().contiguous(), overlap_thresh,
                             force_suppress)
    if dev == "cpu":
        return nms_keep_reference(boxes, cls, valid, overlap_thresh,
                                  force_suppress)
    if dev == "meta":
        _check(boxes, cls, valid)
        return torch.empty(tuple(boxes.shape[:2]), dtype=torch.bool,
                           device=boxes.device)
    raise MXNetError("nms_keep: no kernel for device %s (cuda, cpu or meta)"
                     % (boxes.device,))
