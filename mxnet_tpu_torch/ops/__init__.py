"""mxnet_tpu_torch.ops — kernels written by hand for Hopper, each beside
its plain PyTorch version.

* :mod:`.paged_attention` — ragged paged decode attention (CUDA C++,
  ``csrc/paged_attention.cu``), replacing the Pallas ``_paged_kernel``,
  and the speculative verify step's multi-query version (CUDA C++,
  ``csrc/paged_spec_attention.cu``), replacing ``_paged_spec_kernel``.

Kernels are built by :mod:`._build` at first use, never at import.
"""
from __future__ import annotations

from . import paged_attention

__all__ = ["paged_attention"]
