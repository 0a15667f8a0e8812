"""Vision / legacy operator tail: the port of ``mxnet_tpu/ops/vision.py``.

Reference ``src/operator/spatial_transformer.cc``, ``grid_generator.cc``,
``bilinear_sampler.cc``, ``correlation.cc``, ``roi_pooling.cc``,
``crop.cc``, ``src/operator/contrib/{fft,ifft,adaptive_avg_pooling,
bilinear_resize,proposal,psroi_pooling,deformable_*,count_sketch}`` and
``identity_attach_KL_sparse_reg.cc``, registered under the JAX package's
names, params, inputs and aliases. Every op is plain PyTorch on the
tensors' device, differentiable by torch autograd where the JAX op is by
``jax.vjp``, except:

* ``Proposal`` (aliases ``MultiProposal`` and the ``_contrib_`` names)
  runs its suppression through :func:`.nms.nms_keep`, the hand-written
  CUDA kernel on the card (no fallback), one call an image, and reads
  nothing back to the host;
* ``IdentityAttachKLSparseReg``'s backward is a ``torch.autograd.Function``
  (the JAX op's ``custom_vjp``).

Every division by a Python number is a true division on the card too
(``_common._div``): CUDA's scalar division is a multiply by the
reciprocal, whose last bit can move a RoI bin's edge.

Where the JAX op builds a full-map mask or sample tensor that XLA fuses
away (``ROIPooling``'s per-bin mask, the RoI gathers), the port works in
RoI chunks so that no intermediate passes about 2 GiB; each op states its
peak.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ._common import ROI_CHUNK, _clip, _div, _floats, _roi_batch
from .nms import nms_keep
from .registry import REQUIRED, register

__all__ = []

def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _neg_inf(t):
    return torch.full((), -np.inf, dtype=t.dtype, device=t.device)


def _linspace(start, stop, n, device):
    """``jnp.linspace(start, stop, n)`` in float32, by JAX's formula (a
    lerp of the ends, the last point exactly ``stop``)."""
    if n == 1:
        return torch.full((1,), float(start), dtype=torch.float32,
                          device=device)
    step = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    out = np.float32(start) * (np.float32(1) - step) \
        + np.float32(stop) * step
    return torch.from_numpy(out.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# bilinear sampling family (SpatialTransformer / GridGenerator /
# BilinearSampler, reference spatial_transformer-inl.h)
# ---------------------------------------------------------------------------


def _bilinear_sample(img, xs, ys):
    """Sample img (B, C, H, W) at float pixel coords xs/ys (B, ...) with
    zero padding outside (reference BilinearSamplerForward): (B, C, ...)."""
    b, c, h, w = img.shape
    pts = tuple(xs.shape[1:])
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    lx = (xs - x0).unsqueeze(1)
    ly = (ys - y0).unsqueeze(1)
    flat = img.reshape(b, c, h * w)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, 1, -1).expand(b, c, -1)
        v = torch.gather(flat, 2, idx).reshape((b, c) + pts)
        return torch.where(inside.unsqueeze(1), v, _zero(v))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1 - lx) + v01 * lx
    bot = v10 * (1 - lx) + v11 * lx
    return top * (1 - ly) + bot * ly


def _affine_grid(theta, h, w):
    """(B, 6) affine params -> (B, 2, H, W) normalized target coords
    (reference grid_generator.cc affine branch)."""
    dev = theta.device
    ys = _linspace(-1.0, 1.0, h, dev)
    xs = _linspace(-1.0, 1.0, w, dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    src = torch.stack([xg, yg, torch.ones_like(xg)], dim=0).reshape(3, -1)
    out = theta.reshape(-1, 2, 3).to(src.dtype) @ src
    return out.reshape(-1, 2, h, w)


@register("GridGenerator",
          params={"transform_type": (str, REQUIRED),
                  "target_shape": (tuple, (0, 0))})
def _grid_generator(attrs, data):
    """Sampling grids (reference grid_generator.cc): 'affine' takes (B, 6)
    params; 'warp' takes a (B, 2, H, W) flow added to the identity grid,
    normalized to [-1, 1]."""
    if attrs.transform_type == "affine":
        h, w = attrs.target_shape
        return _affine_grid(data, h, w)
    if attrs.transform_type == "warp":
        _, _, h, w = data.shape
        ys = torch.arange(h, dtype=torch.float32, device=data.device)
        xs = torch.arange(w, dtype=torch.float32, device=data.device)
        yg, xg = torch.meshgrid(ys, xs, indexing="ij")
        x_new = (data[:, 0] + xg) * (2.0 / max(w - 1, 1)) - 1.0
        y_new = (data[:, 1] + yg) * (2.0 / max(h - 1, 1)) - 1.0
        return torch.stack([x_new, y_new], dim=1)
    raise ValueError("unknown transform_type %r" % attrs.transform_type)


@register("BilinearSampler", inputs=("data", "grid"))
def _bilinear_sampler(attrs, data, grid):
    """Sample data (B, C, H, W) at grid (B, 2, Ho, Wo) in [-1, 1] coords
    (reference bilinear_sampler.cc; zero padding outside)."""
    _, _, h, w = data.shape
    xs = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    ys = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return _bilinear_sample(data, xs, ys)


@register("SpatialTransformer",
          params={"target_shape": (tuple, (0, 0)),
                  "transform_type": (str, REQUIRED),
                  "sampler_type": (str, REQUIRED)},
          inputs=("data", "loc"))
def _spatial_transformer(attrs, data, loc):
    """STN: the affine grid of ``loc`` and bilinear sampling (reference
    spatial_transformer.cc; only affine/bilinear exist there too)."""
    h, w = attrs.target_shape
    _, _, ih, iw = data.shape
    g = _affine_grid(loc, h, w)
    xs = (g[:, 0] + 1.0) * (iw - 1) / 2.0
    ys = (g[:, 1] + 1.0) * (ih - 1) / 2.0
    return _bilinear_sample(data, xs, ys)


# ---------------------------------------------------------------------------
# Correlation (FlowNet, reference correlation.cc)
# ---------------------------------------------------------------------------


@register("Correlation",
          params={"kernel_size": (int, 1), "max_displacement": (int, 1),
                  "stride1": (int, 1), "stride2": (int, 1),
                  "pad_size": (int, 0), "is_multiply": (bool, True)},
          inputs=("data1", "data2"))
def _correlation(attrs, data1, data2):
    """Correlation volume between two feature maps: for each displacement
    in a (2d/s2+1)^2 grid, the kernel-window mean of the per-channel
    product (or absolute difference). The JAX op's arithmetic: the second
    map rolled by the displacement (the wrap never reaches a selected
    window: centres start at kernel_size // 2 + max_displacement), a
    "SAME" k x k window sum, then the channel sum (the port sums the
    channels first; both are linear) over k*k*C."""
    b, c, h, w = data1.shape
    k, md = attrs.kernel_size, attrs.max_displacement
    s1, s2, pad = attrs.stride1, attrs.stride2, attrs.pad_size
    p1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
    ph, pw = h + 2 * pad, w + 2 * pad
    kr = k // 2
    out_h = (ph - 2 * (kr + md) + s1 - 1) // s1
    out_w = (pw - 2 * (kr + md) + s1 - 1) // s1
    base = kr + md  # first window centre
    ys = base + s1 * torch.arange(out_h, device=data1.device)
    xs = base + s1 * torch.arange(out_w, device=data1.device)
    norm = float(k * k * c)
    lo = (k - 1) // 2  # lax's "SAME" padding: the low side gets the floor
    planes = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            shifted = torch.roll(p2, (-dy, -dx), dims=(2, 3))
            # |x| as jnp.abs differentiates it: gradient 1 at 0
            diff = p1 - shifted
            prod = p1 * shifted if attrs.is_multiply \
                else torch.where(diff >= 0, diff, -diff)
            chan = prod.sum(dim=1)                      # (B, PH, PW)
            padded = torch.nn.functional.pad(chan, (lo, k - 1 - lo,
                                                    lo, k - 1 - lo))
            win = 0
            for i in range(k):
                for j in range(k):
                    win = win + padded[:, i:i + ph, j:j + pw]
            plane = _div(win, norm)
            planes.append(plane[:, ys][:, :, xs])
    return torch.stack(planes, dim=1)  # (B, D*D, out_h, out_w)


# ---------------------------------------------------------------------------
# ROIPooling / Crop
# ---------------------------------------------------------------------------


@register("ROIPooling",
          params={"pooled_size": (tuple, REQUIRED),
                  "spatial_scale": (float, REQUIRED)},
          inputs=("data", "rois"))
def _roi_pooling(attrs, data, rois):
    """Max-pool RoIs into a fixed grid with rounded bin edges (reference
    roi_pooling.cc, the Fast R-CNN op; ROIAlign is the non-rounded
    variant). Bin (py, px) of a RoI is the max over the rows
    [floor(py bin_h) + y1, ceil((py + 1) bin_h) + y1) and the columns
    likewise of its image; an empty bin is 0.

    Separable, where the JAX op masks the whole map once a bin: a max
    over each column bin's columns, ROI_CHUNK RoIs at a time, then over
    each row bin's rows. Peak for R RoIs on (B, C, H, W) fp32: two
    (ROI_CHUNK, C, H, W) blocks (the RoIs' images and one masked copy),
    plus (R, C, H, PW) column maxima and one masked copy of them; at
    Faster R-CNN's test shape (300 RoIs, (1, 512, 37, 62), 7 x 7) that is
    2 x 150 MB + 2 x 159 MB by count, 539 MB measured on an NVIDIA H100
    80GB HBM3 (700 W), against the 69 GB of one mask a bin."""
    ph, pw = attrs.pooled_size
    b, c, h, w = data.shape
    dev = data.device
    scale = attrs.spatial_scale
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    one = torch.ones((), dtype=rois.dtype, device=dev)
    rh = torch.maximum(y2 - y1 + 1, one)
    rw = torch.maximum(x2 - x1 + 1, one)
    bin_h = _div(rh, ph)
    bin_w = _div(rw, pw)
    py = torch.arange(ph, device=dev, dtype=rois.dtype)
    px = torch.arange(pw, device=dev, dtype=rois.dtype)
    hs = torch.floor(py[None] * bin_h[:, None]) + y1[:, None]   # (R, PH)
    he = torch.ceil((py[None] + 1) * bin_h[:, None]) + y1[:, None]
    ws = torch.floor(px[None] * bin_w[:, None]) + x1[:, None]   # (R, PW)
    we = torch.ceil((px[None] + 1) * bin_w[:, None]) + x1[:, None]
    ycoord = torch.arange(h, device=dev)
    xcoord = torch.arange(w, device=dev)
    ymask = (ycoord >= hs[..., None]) & (ycoord < he[..., None])  # (R,PH,H)
    xmask = (xcoord >= ws[..., None]) & (xcoord < we[..., None])  # (R,PW,W)
    bi = _roi_batch(rois, data)
    ninf = _neg_inf(data)
    cols = []
    for lo in range(0, rois.shape[0], ROI_CHUNK):
        img = data[bi[lo:lo + ROI_CHUNK]]                         # (r,C,H,W)
        xm = xmask[lo:lo + ROI_CHUNK, :, None, None, :]       # (r,PW,1,1,W)
        cols.append(torch.stack(
            [torch.where(xm[:, j], img, ninf).amax(dim=-1)
             for j in range(pw)], dim=-1))                        # (r,C,H,PW)
    if not cols:
        return data.new_zeros((0, c, ph, pw))
    colmax = torch.cat(cols, dim=0)
    out = torch.stack(
        [torch.where(ymask[:, i, None, :, None], colmax, ninf).amax(dim=2)
         for i in range(ph)], dim=2)                              # (R,C,PH,PW)
    return torch.where(torch.isfinite(out), out, _zero(out))


@register("Crop",
          params={"offset": (tuple, (0, 0)), "h_w": (tuple, (0, 0)),
                  "num_args": (int, REQUIRED), "center_crop": (bool, False)},
          inputs=lambda a: ["data", "crop_like"][:a["num_args"]])
def _crop(attrs, data, *rest):
    """Crop H/W to h_w (or to crop_like's shape), at offset or centred
    (reference crop.cc)."""
    if rest:
        th, tw = rest[0].shape[2], rest[0].shape[3]
    else:
        th, tw = attrs.h_w
    h, w = data.shape[2], data.shape[3]
    if attrs.center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = attrs.offset
    return data[:, :, oy:oy + th, ox:ox + tw]


# ---------------------------------------------------------------------------
# adaptive pooling / bilinear resize (reference contrib)
# ---------------------------------------------------------------------------


def _adaptive_matrix(in_size, out_size, device):
    """(out, in) averaging matrix with floor/ceil bin edges (reference
    adaptive_avg_pooling.cc bin convention)."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        start = int(np.floor(i * in_size / out_size))
        end = int(np.ceil((i + 1) * in_size / out_size))
        m[i, start:end] = 1.0 / (end - start)
    return torch.from_numpy(m).to(device)


@register("_contrib_AdaptiveAvgPooling2D",
          params={"output_size": (tuple, None)})
def _adaptive_avg_pool(attrs, data):
    """Pool to a fixed (Ho, Wo) whatever the input size; bins follow the
    reference floor/ceil convention, as two averaging matrices."""
    h, w = data.shape[2], data.shape[3]
    if not attrs.output_size:
        oh, ow = 1, 1
    elif len(attrs.output_size) == 1:
        oh = ow = attrs.output_size[0]
    else:
        oh, ow = attrs.output_size
    mh = _adaptive_matrix(h, oh, data.device).to(data.dtype)
    mw = _adaptive_matrix(w, ow, data.device).to(data.dtype)
    return torch.einsum("oh,bchw,pw->bcop", mh, data, mw)


@register("_contrib_BilinearResize2D",
          params={"height": (int, REQUIRED), "width": (int, REQUIRED)})
def _bilinear_resize(attrs, data):
    """Bilinear resize with align_corners=True (reference
    bilinear_resize.cc uses the caffe/align-corners convention)."""
    b, c, h, w = data.shape
    oh, ow = attrs.height, attrs.width
    ys = _linspace(0.0, h - 1, oh, data.device)
    xs = _linspace(0.0, w - 1, ow, data.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return _bilinear_sample(data, xg.expand(b, oh, ow), yg.expand(b, oh, ow))


# ---------------------------------------------------------------------------
# fft / ifft (reference contrib/fft.cc: interleaved real/imag packing)
# ---------------------------------------------------------------------------


@register("_contrib_fft", params={"compute_size": (int, 128)},
          aliases=("fft",))
def _fft(attrs, data):
    """FFT over the last axis; the complex result packed as interleaved
    [re, im], doubling the last dim (reference fft-inl.h)."""
    spec = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)) \
        .to(torch.float32)


@register("_contrib_ifft", params={"compute_size": (int, 128)},
          aliases=("ifft",))
def _ifft(attrs, data):
    """Inverse of _contrib_fft: interleaved complex -> UNNORMALIZED real
    inverse FFT (reference ifft-inl.h: out = ifft(in) * size)."""
    n = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (n, 2))
    spec = torch.complex(pairs[..., 0].float(), pairs[..., 1].float())
    return (torch.fft.ifft(spec, dim=-1).real * n).to(torch.float32)


# ---------------------------------------------------------------------------
# Proposal (RPN, reference contrib/proposal.cc)
# ---------------------------------------------------------------------------


def _gen_base_anchors(stride, scales, ratios):
    """(A, 4) base anchors centred on one stride cell (reference
    proposal.cc GenerateAnchors convention)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    cw = (base[0] + base[2]) / 2
    ch = (base[1] + base[3]) / 2
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    anchors = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cw - (wss - 1) / 2, ch - (hss - 1) / 2,
                            cw + (wss - 1) / 2, ch + (hss - 1) / 2])
    return np.asarray(anchors, np.float32)


def _proposal_anchors(attrs, h, w, device):
    """(H*W*A, 4) anchors of an (H, W) map, location-major."""
    stride = attrs.feature_stride
    base = torch.from_numpy(
        _gen_base_anchors(stride, attrs.scales, attrs.ratios)).to(device)
    shift_x = torch.arange(w, dtype=torch.float32, device=device) * stride
    shift_y = torch.arange(h, dtype=torch.float32, device=device) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 4)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


@register("Proposal",
          params={"rpn_pre_nms_top_n": (int, 6000),
                  "rpn_post_nms_top_n": (int, 300),
                  "threshold": (float, 0.7),
                  "rpn_min_size": (int, 16),
                  "scales": (_floats, (4.0, 8.0, 16.0, 32.0)),
                  "ratios": (_floats, (0.5, 1.0, 2.0)),
                  "feature_stride": (int, 16),
                  "output_score": (bool, False),
                  "iou_loss": (bool, False)},
          inputs=("cls_prob", "bbox_pred", "im_info"),
          num_outputs=lambda a: 2 if a["output_score"] else 1,
          aliases=("_contrib_Proposal", "_contrib_MultiProposal",
                   "MultiProposal"))
def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """RPN proposals (reference proposal.cc / multi_proposal.cc): anchor
    decode, clip to ``im_info``, the ``rpn_min_size * im_info[2]`` filter,
    pre-NMS top-N by a stable sort, NMS with ``force_suppress``
    (:func:`.nms.nms_keep`: the CUDA kernel on the card, one call an
    image), a stable compaction of the kept boxes, post-NMS top-N, padded
    with the top box. Output (B*post, 5) rois [batch_idx, x1, y1, x2, y2]
    (and (B*post, 1) scores with ``output_score``). A Python loop over
    the images, as the JAX op's; nothing is read back to the host."""
    b, twice_a, h, w = cls_prob.shape
    a = twice_a // 2
    dev = cls_prob.device
    anchors = _proposal_anchors(attrs, h, w, dev)
    n = anchors.shape[0]
    pre = min(attrs.rpn_pre_nms_top_n, n)
    post = attrs.rpn_post_nms_top_n
    if pre < post:
        raise MXNetError("Proposal: rpn_pre_nms_top_n %d (of %d anchors) is "
                         "below rpn_post_nms_top_n %d" % (pre, n, post))
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    no_cls = torch.full((1, pre), -1.0, dtype=torch.float32, device=dev)
    slots = torch.arange(post, device=dev)

    def one(probs, deltas, info):
        score = probs[a:].permute(1, 2, 0).reshape(-1)      # fg scores
        d = deltas.permute(1, 2, 0).reshape(-1, 4)
        cx = d[:, 0] * aw + ax
        cy = d[:, 1] * ah + ay
        nw = torch.exp(_clip(d[:, 2], -10, 10)) * aw
        nh = torch.exp(_clip(d[:, 3], -10, 10)) * ah
        x1 = _clip(cx - nw * 0.5, 0, info[1] - 1)
        y1 = _clip(cy - nh * 0.5, 0, info[0] - 1)
        x2 = _clip(cx + nw * 0.5, 0, info[1] - 1)
        y2 = _clip(cy + nh * 0.5, 0, info[0] - 1)
        min_size = attrs.rpn_min_size * info[2]
        keep_sz = ((x2 - x1 + 1) >= min_size) & ((y2 - y1 + 1) >= min_size)
        score = torch.where(keep_sz, score, _neg_inf(score))
        # jnp.argsort is stable: tied scores keep the anchors' order
        order = torch.argsort(-score, stable=True)[:pre]
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)[order]
        s_sorted = score[order]
        keep = nms_keep(boxes.detach()[None].contiguous(), no_cls,
                        torch.isfinite(s_sorted.detach())[None],
                        attrs.threshold, True)[0]
        # compact the kept boxes to the front (stable), take `post`, pad
        # with the top box (the reference pads by repeating)
        kept_first = torch.argsort((~keep).to(torch.uint8),
                                   stable=True)[:post]
        rows = boxes[kept_first]
        scores_out = s_sorted[kept_first]
        n_kept = torch.clamp_max(keep.sum(), post)
        live = slots < n_kept
        rows = torch.where(live[:, None], rows, boxes[0])
        scores_out = torch.where(live, scores_out, s_sorted[0])
        return rows, scores_out

    rois_list, score_list = [], []
    for i in range(b):
        rows, scores = one(cls_prob[i], bbox_pred[i], im_info[i])
        idx = torch.full((post, 1), float(i), dtype=rows.dtype, device=dev)
        rois_list.append(torch.cat([idx, rows], dim=-1))
        score_list.append(scores.reshape(-1, 1))
    rois = torch.cat(rois_list, dim=0)
    if attrs.output_score:
        return rois, torch.cat(score_list, dim=0)
    return rois


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the KL-sparsity penalty's gradient
    toward the target mean activation."""

    @staticmethod
    def forward(ctx, x, rho, penalty):
        ctx.save_for_backward(x)
        ctx.rho, ctx.penalty = rho, penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        rho_hat = torch.clamp(torch.mean(torch.sigmoid(x)), 1e-6, 1 - 1e-6)
        reg = ctx.penalty * (-ctx.rho / rho_hat
                             + (1 - ctx.rho) / (1 - rho_hat))
        return g + reg * torch.ones_like(x), None, None


@register("IdentityAttachKLSparseReg",
          params={"sparseness_target": (float, 0.1),
                  "penalty": (float, 0.001), "momentum": (float, 0.9)})
def _identity_kl_sparse(attrs, data):
    """Identity forward; backward adds a KL-sparsity penalty gradient
    toward the target mean activation (reference
    identity_attach_KL_sparse_reg.cc)."""
    return _KLSparseReg.apply(data, attrs.sparseness_target, attrs.penalty)


# ---------------------------------------------------------------------------
# Deformable ConvNets family (reference src/operator/contrib/
# deformable_convolution.cc, deformable_psroi_pooling.cc, psroi_pooling.cc)
# ---------------------------------------------------------------------------


def _deform_conv_inputs(attrs):
    return ["data", "offset", "weight"] if attrs.get("no_bias") else \
        ["data", "offset", "weight", "bias"]


@register("_contrib_DeformableConvolution",
          params={"kernel": (tuple, REQUIRED), "stride": (tuple, (1, 1)),
                  "dilate": (tuple, (1, 1)), "pad": (tuple, (0, 0)),
                  "num_filter": (int, REQUIRED), "num_group": (int, 1),
                  "num_deformable_group": (int, 1), "no_bias": (bool, False),
                  "workspace": (int, 1024), "layout": (str, "NCHW")},
          inputs=_deform_conv_inputs,
          aliases=("DeformableConvolution",))
def _deformable_convolution(attrs, data, offset, weight, bias=None):
    """Deformable convolution v1 (reference deformable_convolution-inl.h):
    each kernel tap samples the input at a learned offset by bilinear
    interpolation (zero outside), then an ordinary weighted reduction runs
    over the taps. offset: (B, 2*KH*KW*num_deformable_group, OH, OW),
    ordered (dy, dx) per tap. One image at a time: the peak is that
    image's (C, KH*KW, OH, OW) samples, five times (four taps and their
    sum), where the JAX op holds the whole batch's."""
    kh, kw = attrs.kernel
    sh, sw = attrs.stride
    dh, dw = attrs.dilate
    ph, pw = attrs.pad
    b, c, h, w = data.shape
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    ndg = attrs.num_deformable_group
    kk = kh * kw
    dev = data.device
    off = offset.reshape(b, ndg, kk, 2, oh, ow)
    base_y = (torch.arange(oh, device=dev) * sh - ph)[:, None]    # (OH, 1)
    base_x = (torch.arange(ow, device=dev) * sw - pw)[None, :]    # (1, OW)
    ky = torch.tensor([k // kw for k in range(kk)], device=dev)
    kx = torch.tensor([k % kw for k in range(kk)], device=dev)
    tap_y = (base_y[None] + (ky * dh)[:, None, None]).to(data.dtype)
    tap_x = (base_x[None] + (kx * dw)[:, None, None]).to(data.dtype)
    cg = c // ndg
    ng = attrs.num_group
    wg = weight.reshape(ng, attrs.num_filter // ng, (c // ng) * kk)
    outs = []
    for i in range(b):
        ys = tap_y[None] + off[i, :, :, 0]                  # (ndg,K,OH,OW)
        xs = tap_x[None] + off[i, :, :, 1]
        y0 = torch.floor(ys)
        x0 = torch.floor(xs)
        fy = ys - y0
        fx = xs - x0
        img = data[i].reshape(ndg, cg, h * w)

        def tap(yi, xi):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            yc = yi.clamp(0, h - 1).long()
            xc = xi.clamp(0, w - 1).long()
            idx = (yc * w + xc).reshape(ndg, 1, -1).expand(ndg, cg, -1)
            v = torch.gather(img, 2, idx).reshape(ndg, cg, kk, oh, ow)
            return torch.where(valid[:, None], v, _zero(v))

        wy0, wx0 = (1 - fy)[:, None], (1 - fx)[:, None]
        wy1, wx1 = fy[:, None], fx[:, None]
        sampled = (tap(y0, x0) * (wy0 * wx0) + tap(y0, x0 + 1) * (wy0 * wx1)
                   + tap(y0 + 1, x0) * (wy1 * wx0)
                   + tap(y0 + 1, x0 + 1) * (wy1 * wx1))      # (ndg,Cg,K,OH,OW)
        cols = sampled.reshape(ng, (c // ng) * kk, oh * ow)
        outs.append(torch.bmm(wg, cols).reshape(attrs.num_filter, oh, ow))
    out = torch.stack(outs, dim=0)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def _bin_groups(p, group):
    return [min(i * group // p, group - 1) for i in range(p)]


@register("_contrib_PSROIPooling",
          params={"spatial_scale": (float, REQUIRED),
                  "output_dim": (int, REQUIRED),
                  "pooled_size": (int, REQUIRED),
                  "group_size": (int, 0)},
          inputs=("data", "rois"),
          aliases=("PSROIPooling",))
def _psroi_pooling(attrs, data, rois):
    """Position-sensitive RoI average pooling (reference psroi_pooling.cc,
    R-FCN): bin (i, j) of output channel c pools from input channel
    c*group^2 + i*group + j, so each spatial bin looks at its own score
    map. A bin's mask is the outer product of a row and a column mask, so
    the masked sum is a contraction of the bin's score map with both,
    ROI_CHUNK RoIs at a time: the peak is (ROI_CHUNK, P, P, output_dim, H,
    W), the chunk's bin maps."""
    group = attrs.group_size or attrs.pooled_size
    p = attrs.pooled_size
    odim = attrs.output_dim
    _b, c, h, w = data.shape
    dev = data.device
    scale = attrs.spatial_scale
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale) + 1.0
    y2 = torch.round(rois[:, 4] * scale) + 1.0
    tenth = torch.full((), 0.1, dtype=rois.dtype, device=dev)
    rh = torch.maximum(y2 - y1, tenth)
    rw = torch.maximum(x2 - x1, tenth)
    bh, bw = _div(rh, p), _div(rw, p)
    pi = torch.arange(p, device=dev, dtype=rois.dtype)
    hs = y1[:, None] + pi[None] * bh[:, None]                    # (R, P)
    he = y1[:, None] + (pi[None] + 1) * bh[:, None]
    ws = x1[:, None] + pi[None] * bw[:, None]
    we = x1[:, None] + (pi[None] + 1) * bw[:, None]
    ycoord = torch.arange(h, dtype=torch.float32, device=dev)
    xcoord = torch.arange(w, dtype=torch.float32, device=dev)
    ym = ((ycoord >= torch.floor(hs)[..., None])
          & (ycoord < torch.ceil(he)[..., None]))                 # (R, P, H)
    xm = ((xcoord >= torch.floor(ws)[..., None])
          & (xcoord < torch.ceil(we)[..., None]))                 # (R, P, W)
    area = torch.clamp_min(ym.sum(-1)[:, :, None] * xm.sum(-1)[:, None, :],
                           1).to(data.dtype)                      # (R, P, P)
    gy = torch.tensor(_bin_groups(p, group), device=dev)
    gx = torch.tensor(_bin_groups(p, group), device=dev)
    chans = (torch.arange(odim, device=dev)[None, None, :] * group * group
             + gy[:, None, None] * group + gx[None, :, None])     # (P, P, O)
    bi = _roi_batch(rois, data)
    ymf, xmf = ym.to(data.dtype), xm.to(data.dtype)
    outs = []
    for lo in range(0, rois.shape[0], ROI_CHUNK):
        sl = slice(lo, lo + ROI_CHUNK)
        maps = data[bi[sl]][:, chans]                         # (r,P,P,O,H,W)
        outs.append(torch.einsum("rpqoyx,rpy,rqx->ropq", maps, ymf[sl],
                                 xmf[sl]))
    if not outs:
        return data.new_zeros((0, odim, p, p))
    return torch.cat(outs, dim=0) / area[:, None]


@register("_contrib_DeformablePSROIPooling",
          params={"spatial_scale": (float, REQUIRED),
                  "output_dim": (int, REQUIRED),
                  "group_size": (int, REQUIRED),
                  "pooled_size": (int, REQUIRED),
                  "part_size": (int, 0),
                  "sample_per_part": (int, 1),
                  "trans_std": (float, 0.0),
                  "no_trans": (bool, False)},
          inputs=lambda a: ["data", "rois"]
          + ([] if a.get("no_trans") else ["trans"]),
          aliases=("DeformablePSROIPooling",))
def _deformable_psroi_pooling(attrs, data, rois, trans=None):
    """Deformable position-sensitive RoI pooling (reference
    deformable_psroi_pooling.cc, Deformable R-FCN): PSROIPooling whose bin
    (py, px) is shifted by a learned offset ``trans[r, 2k:2k+2, py', px']
    * trans_std * (roi w, h)``, class-aware when trans carries
    ``2*num_classes`` channels (class k owns output channels
    ``[k*output_dim/num_classes, ...)``), and sampled bilinearly at
    ``sample_per_part``^2 points whose window is [-0.5, size - 0.5] with
    edge clamping. Every sample of every RoI at once: the peak is a few
    (R, output_dim, P, P, spp, spp) tensors, no feature map copied."""
    p = attrs.pooled_size
    group = attrs.group_size or p
    part = attrs.part_size or p
    spp = attrs.sample_per_part
    odim = attrs.output_dim
    _b, c, h, w = data.shape
    dev, dt = data.device, data.dtype
    r = rois.shape[0]
    scale = attrs.spatial_scale
    # the reference's half-pixel RoI corners (round - 0.5 semantics)
    x1 = torch.round(rois[:, 1]) * scale - 0.5
    y1 = torch.round(rois[:, 2]) * scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    tenth = torch.full((), 0.1, dtype=rois.dtype, device=dev)
    rw = torch.maximum(x2 - x1, tenth)
    rh = torch.maximum(y2 - y1, tenth)
    bw, bh = _div(rw, p), _div(rh, p)
    sub_w, sub_h = _div(bw, spp), _div(bh, spp)
    part_of = torch.tensor([min(i * part // p, part - 1) for i in range(p)],
                           device=dev)
    gsel = torch.tensor(_bin_groups(p, group), device=dev)
    chans = (torch.arange(odim, device=dev)[:, None, None] * group * group
             + gsel[None, :, None] * group + gsel[None, None, :])  # (O, P, P)
    if attrs.no_trans or trans is None:
        dx = dy = torch.zeros((r, odim, p, p), dtype=dt, device=dev)
    else:
        n_cls = max(1, trans.shape[1] // 2)
        if odim % n_cls:
            raise MXNetError(
                "DeformablePSROIPooling: output_dim %d not divisible by "
                "num_classes %d (trans has %d channels)"
                % (odim, n_cls, trans.shape[1]))
        class_of = torch.arange(odim, device=dev) // (odim // n_cls)
        tsel = trans[:, :, part_of][:, :, :, part_of]            # (R,2n,P,P)
        dx = tsel[:, class_of * 2] * attrs.trans_std \
            * rw[:, None, None, None]
        dy = tsel[:, class_of * 2 + 1] * attrs.trans_std \
            * rh[:, None, None, None]
    pi = torch.arange(p, device=dev, dtype=dt)
    si = torch.arange(spp, device=dev, dtype=dt) + 0.5
    # (R, O, P, P, spp, 1) rows and (R, O, P, P, 1, spp) columns, summed
    # in the JAX op's order
    sy = ((y1[:, None, None, None] + pi[None, None, :, None]
           * bh[:, None, None, None] + dy)[..., None, None]
          + si[:, None] * sub_h[:, None, None, None, None, None])
    sx = ((x1[:, None, None, None] + pi[None, None, None, :]
           * bw[:, None, None, None] + dx)[..., None, None]
          + si[None, :] * sub_w[:, None, None, None, None, None])
    sy, sx = torch.broadcast_tensors(sy, sx)
    ok = (sy >= -0.5) & (sy <= h - 0.5) & (sx >= -0.5) & (sx <= w - 0.5)
    yc = _clip(sy, 0.0, h - 1.0)
    xc = _clip(sx, 0.0, w - 1.0)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    wy1 = yc - y0
    wx1 = xc - x0
    y0i = y0.long()
    x0i = x0.long()
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    bi = _roi_batch(rois, data)
    plane = ((bi[:, None, None, None] * c + chans[None]) * h)[..., None, None]
    flat = data.reshape(-1)

    def at(yi, xi):
        return flat[(plane + yi) * w + xi]

    v = (at(y0i, x0i) * (1 - wy1) * (1 - wx1)
         + at(y1i, x0i) * wy1 * (1 - wx1)
         + at(y0i, x1i) * (1 - wy1) * wx1
         + at(y1i, x1i) * wy1 * wx1)
    v = torch.where(ok, v, _zero(v))
    acc = v.sum(dim=(-2, -1))
    cnt = ok.to(dt).sum(dim=(-2, -1))
    return acc / torch.clamp_min(cnt, 1.0)


@register("_contrib_count_sketch",
          params={"out_dim": (int, REQUIRED),
                  "processing_batch_size": (int, 32)},
          inputs=("data", "h", "s"),
          aliases=("count_sketch",))
def _count_sketch(attrs, data, h, s):
    """Count-sketch projection (reference count_sketch.cc, used by compact
    bilinear pooling): out[b, h[i]] += s[i] * data[b, i], a scatter-add
    over hashed feature indices (``index_add_``; on the card its float
    atomics add repeated indices in another order than the CPU)."""
    b = data.shape[0]
    hh = h.reshape(-1).long()
    ss = s.reshape(-1).to(data.dtype)
    out = torch.zeros((b, attrs.out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(1, hh, data * ss[None, :])

