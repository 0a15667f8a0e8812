"""Torch interop: run torch modules and functions inside the framework,
the port of ``mxnet_tpu/contrib/torch_bridge.py`` (reference
``plugin/torch/``).

A ``torch.nn.Module`` or torch function runs under the tape as an
:class:`~mxnet_tpu_torch.autograd.Function` whose backward calls
``torch.autograd.grad``, so gradients flow through mixed graphs and into
the torch module's own parameters (for a torch optimizer). Where the JAX
package copies each input to a host tensor and back, here the torch
callable runs on the NDArray's own tensor, on its own device: the bridge
is close to an identity.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["TorchFunction", "TorchBlock"]


class TorchFunction(autograd.Function):
    """Run a torch callable under the tape. ``trainable_params`` (torch
    tensors) receive gradients too, accumulated in their ``.grad`` the
    usual torch way."""

    def __init__(self, fn, trainable_params: Optional[List] = None):
        super().__init__()
        self._fn = fn
        self._params = list(trainable_params or [])

    def forward(self, *inputs):
        tins = []
        for i in inputs:
            t = i._data.detach()
            if t.is_floating_point():  # int inputs (ids) take no grad
                t.requires_grad_(True)
            tins.append(t)
        with torch.enable_grad():
            touts = self._fn(*tins)
        single = torch.is_tensor(touts)
        touts_t = (touts,) if single else tuple(touts)
        self.save_for_backward(tins, touts_t)
        outs = [NDArray(t.detach()) for t in touts_t]
        return outs[0] if single else outs

    def backward(self, *output_grads):
        tins, touts = self.saved_tensors
        diff_ins = [t for t in tins if t.requires_grad]
        grads = torch.autograd.grad(
            touts, tuple(diff_ins) + tuple(self._params),
            [g._data for g in output_grads], allow_unused=True)
        by_input = dict(zip(map(id, diff_ins), grads[:len(diff_ins)]))
        for p, g in zip(self._params, grads[len(diff_ins):]):
            if g is not None:
                p.grad = g if p.grad is None else p.grad + g
        out = []
        for t in tins:
            g = by_input.get(id(t))
            # a non-differentiable (int ids) or unused input gets zeros
            out.append(NDArray(torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device)
                               if g is None else g.float()))
        return out


class TorchBlock(object):
    """Wrap a ``torch.nn.Module`` as a callable block (reference
    ``mxnet.th`` module wrappers): forward and backward run through
    :class:`TorchFunction`, and the module's parameters gather gradients
    in their ``.grad`` for a torch optimizer to step."""

    def __init__(self, module):
        if not isinstance(module, torch.nn.Module):
            raise MXNetError("TorchBlock wraps a torch.nn.Module")
        self.module = module

    def torch_parameters(self):
        return list(self.module.parameters())

    def zero_grad(self):
        for p in self.torch_parameters():
            p.grad = None

    def __call__(self, *inputs):
        fn = TorchFunction(self.module, self.torch_parameters())
        return fn(*inputs)
