"""Device contexts: ``mx.cpu()``, ``mx.gpu()``: the port of
``mxnet_tpu/context.py``.

A :class:`Context` names a ``torch.device``; ``with ctx:`` makes it the
default for arrays and parameters created inside the block, as in MXNet.

Two departures from the JAX package, both from the port's rule that its
entry points run on the card unless the caller asks for the CPU and never
fall back quietly:

* the default context is the card, ``gpu(LOCAL_RANK % cards)`` (the
  rank's own card in a job the launcher started, else ``gpu(0)``), where
  MXNet's (and the JAX
  package's, ``mxnet_tpu/context.py:66``, ``:142``) is ``cpu(0)``; with
  no card, :func:`current_context` raises unless a ``with mx.cpu():``
  scope is active;
* :func:`gpu` raises when there is no card, where
  ``mxnet_tpu/context.py:81`` quietly resolves to the host, and
  ``gpu(i)`` raises beyond the cards present, where the JAX package
  aliases ``i`` modulo the devices (``:85``);
* :func:`tpu` names the card: ``tpu(i)`` is ``gpu(i)`` and
  :func:`num_tpus` is :func:`num_gpus`.

Several contexts in one process: every ``cpu(i)`` is the host
(``torch.device("cpu")``), and an array made for ``cpu(i)`` keeps its
``i`` (``NDArray.context``), so a parameter's copy on ``cpu(1)`` is the
one a batch on ``cpu(1)`` trains; ``gpu(i)`` is card ``i``. On a machine
with one card the layouts of several contexts are several ``cpu(i)``, or
the card beside the host.
"""
from __future__ import annotations

import os
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_gpus",
           "num_tpus"]


class Context:
    """Execution device: ``Context('gpu', 0)`` is CUDA device 0."""

    # dev_type codes kept for .params compat (reference context.py
    # devtype2str), the JAX package's table; this port makes only cpu
    # and gpu contexts
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared",
                   6: "tpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in ("cpu", "gpu"):
            raise MXNetError("unknown device type %r (cpu or gpu)"
                             % (device_type,))
        if device_type == "gpu" and device_id >= num_gpus():
            raise MXNetError(
                "gpu(%d) asked for but %s: use mx.cpu() to run on the CPU "
                "explicitly" % (device_id, "no CUDA device is available"
                                if not num_gpus() else
                                "only %d CUDA devices exist" % num_gpus()))
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    @property
    def device_typeid(self) -> int:
        return self.devstr2type[self.device_type]

    def empty_cache(self):
        """Return the caching allocator's unused blocks on this card to
        the device (reference ``Context.empty_cache``); a no-op for the
        CPU."""
        if self.device_type == "gpu":
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        # a stack a thread: one context object may be entered again inside
        # its own scope, or by several threads at once
        stack = getattr(self._default_ctx, "stack", None)
        if stack is None:
            stack = self._default_ctx.stack = []
        stack.append(self)
        return self

    def __exit__(self, *args):
        self._default_ctx.stack.pop()


def from_device(device: torch.device) -> Context:
    """The context of a tensor's device."""
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    if device.type == "cpu":
        return Context("cpu", 0)
    raise MXNetError("unsupported device %s (cuda or cpu)" % (device,))


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA device ``device_id``; raises when there is no such card."""
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The accelerator of the JAX package's name: here the card, ``gpu(
    device_id)`` (raises as :func:`gpu` does)."""
    return gpu(device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus() -> int:
    """The accelerators of the JAX package's name: the cards."""
    return num_gpus()


def current_context() -> Context:
    """The innermost ``with ctx:`` scope's context, else the card:
    ``gpu(LOCAL_RANK % cards)`` (raises when there is no card)."""
    stack = getattr(Context._default_ctx, "stack", None)
    if stack:
        return stack[-1]
    n = num_gpus()
    return gpu(int(os.environ.get("LOCAL_RANK", 0)) % n if n else 0)
