"""mxnet_tpu_torch.ops — kernels written by hand for Hopper, each beside
its plain PyTorch version.

* :mod:`.paged_attention` — ragged paged decode attention (CUDA C++,
  ``csrc/paged_attention.cu``), replacing the Pallas ``_paged_kernel``,
  and the speculative verify step's multi-query version (CUDA C++,
  ``csrc/paged_spec_attention.cu``), replacing ``_paged_spec_kernel``.
* :mod:`.flash_attention` — the fused attention forward of the training
  path (CUDA C++, ``csrc/flash_attention.cu``), replacing the Pallas
  ``_flash_kernel``, under the registered op ``_contrib_flash_attention``.
* :mod:`.nms` — greedy non-maximum suppression of the detection path
  (CUDA C++, ``csrc/nms.cu``), replacing the Pallas ``_nms_kernel``; the
  detection ops of :mod:`.detection` call it.

:mod:`.registry` holds the op registry; :mod:`.tensor`, :mod:`.nn`,
:mod:`.random_ops`, :mod:`.optimizer_ops` (the fused optimizer updates),
:mod:`.control_flow` (``_foreach``, ``_while_loop``, ``_cond``),
:mod:`.detection`, :mod:`.linalg` (``torch.linalg``), :mod:`.misc_tail`
and :mod:`.sparse` (the storage-type path of sparse NDArrays) register
the plain PyTorch ops
(the ``RNN`` op of :mod:`.nn` runs on cuDNN through torch on the card).

Kernels are built by :mod:`._build` at first use, never at import.
The ``Custom`` op of :mod:`mxnet_tpu_torch.operator` is registered here
too, so that ``nd.Custom`` and ``sym.Custom`` are generated.
"""
from __future__ import annotations

from . import (control_flow, detection, flash_attention, linalg, misc_tail,
               nms, nn, optimizer_ops, paged_attention, random_ops, registry,
               sparse, tensor)

__all__ = ["control_flow", "detection", "flash_attention", "linalg",
           "misc_tail", "nms", "nn", "optimizer_ops", "paged_attention",
           "random_ops", "registry", "sparse", "tensor"]

from .. import operator as _operator  # noqa: E402,F401  (registers Custom)
