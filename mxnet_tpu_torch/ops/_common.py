"""Helpers shared by the op modules: attribute parsing, device-exact
scalar arithmetic and the RoI ops' chunking."""
from __future__ import annotations

import torch

#: RoIs a chunk in the RoI ops (``ROIPooling``, ``ROIAlign``,
#: ``PSROIPooling``): each op states the peak this gives
ROI_CHUNK = 32


def _floats(v):
    """A float tuple attribute from a string, a number or a sequence."""
    if isinstance(v, str):
        s = v.strip().lstrip("([").rstrip(")]")
        return tuple(float(x) for x in s.split(",") if x.strip())
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _div(x, d):
    """``x / d`` for a Python number ``d`` as a true division on every
    device: a CUDA kernel divides by a Python scalar as a multiply by its
    reciprocal, one float32 step off the quotient at times, which moves a
    bin edge across a floor or ceil (the CPU and XLA divide)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    """``jnp.clip`` (maximum, then minimum): a value on a bound splits its
    gradient between the two sides as in JAX."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(lo, x), hi)


def _roi_batch(rois, data):
    """Each RoI's image index (column 0), clamped into the batch as an
    XLA gather clamps an index."""
    return rois[:, 0].long().clamp(0, data.shape[0] - 1)
