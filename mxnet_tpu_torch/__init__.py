"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, for one NVIDIA H100. The layout
mirrors ``mxnet_tpu`` (``serving/``, ``ops/``, ``telemetry/``,
``resilience/``) so each module's counterpart is easy to find; the code
inside is plain PyTorch. Every TPU kernel on a ported path is a kernel
written by hand for Hopper (``ops/csrc/``), built with ``nvcc`` at first
use.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``mxnet_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``; with no card and no such request they raise
:class:`MXNetError`.

Ported so far: the decode-serving plane (``serving.DecodeEngine`` over
``serving.TinyDecoder``) with the paged-attention kernel
(``ops.paged_attention``).
"""
from __future__ import annotations

from .base import MXNetError, fetch_host, get_env, resolve_device

__all__ = ["MXNetError", "fetch_host", "get_env", "resolve_device"]
