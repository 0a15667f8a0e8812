"""Optimizers: the port of ``mxnet_tpu/optimizer.py``'s protocol, with
``SGD`` and ``Adam``.

As in the JAX package an optimizer is two pieces: a host-side scalar
prologue :meth:`Optimizer._host_scalars` (per-index lr/wd multipliers and
schedule transforms such as Adam's bias correction, computed in Python)
and a per-parameter kernel :meth:`Optimizer._leaf_step`
``(w, g, state, t, lr, wd) -> (new_w, new_state)`` on tensors.

Departure: :meth:`Optimizer.update` runs the kernel per parameter and
writes the new weight and state into the existing tensors in place,
under ``torch.no_grad()``, where the JAX package jits it and rebinds new
buffers. The fused ``_foreach`` apply over all parameters (the JAX
package's ``fastpath``) is not ported yet. The other optimizers of the
JAX module are not ported yet: :func:`create` raises for them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .base import MXNetError

__all__ = ["Optimizer", "register", "create", "get_updater", "Updater",
           "SGD", "Adam"]


def _tensor(x):
    return getattr(x, "_data", x)


class Optimizer(object):
    """Base optimizer: registry, per-index lr/wd multipliers, update
    counting and the generic per-parameter :meth:`update`."""

    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise MXNetError("Cannot find optimizer %s (not ported yet?)" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        if lr_scheduler is not None:
            raise MXNetError("lr_scheduler is not ported yet")
        if multi_precision:
            raise MXNetError("multi_precision is not ported yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}
        self.lr_mult = {}
        self.wd_mult = {}
        self.set_wd_mult({})

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        """Optimizer state for one parameter (None / tensor / tuple)."""
        return None

    # -- the update protocol ----------------------------------------------
    def _host_scalars(self, index):
        """``(lr, wd)`` for this parameter's update, after
        :meth:`_update_count`."""
        return self._get_lr(index), self._get_wd(index)

    def _leaf_step(self, w, g, state, t, lr, wd):
        """Per-parameter kernel on tensors: ``(new_w, new_state)``."""
        raise NotImplementedError("%s does not implement _leaf_step"
                                  % self.__class__.__name__)

    def update(self, index, weight, grad, state):
        """Apply one parameter's update in place; returns the new state."""
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._host_scalars(index)
        w = _tensor(weight)
        with torch.no_grad():
            new_w, new_state = self._leaf_step(w, _tensor(grad), state, t,
                                               lr, wd)
            w.copy_(new_w)
            if state is not None:
                for s, n in zip(_as_tuple(state), _as_tuple(new_state)):
                    s.copy_(n)
        return state

    # -- lr / wd plumbing -------------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- gradient prologues (traced into the kernel in the JAX package) ---
    def _preprocess(self, grad, weight, wd):
        """rescale -> clip -> + wd * weight (the sgd family)."""
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        return grad + wd * weight

    def _preprocess_wd_in_clip(self, grad, weight, wd):
        """rescale -> + wd * weight -> clip (the adam family)."""
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clamp(-self.clip_gradient, self.clip_gradient)
        return grad


def _as_tuple(state):
    return state if isinstance(state, tuple) else (state,)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(_tensor(weight))

    def _leaf_step(self, w, g, state, t, lr, wd):
        g = self._preprocess(g, w, wd)
        if state is None:
            return w - lr * g, None
        m = self.momentum * state - lr * g
        return w + m, m


@register
class Adam(Optimizer):
    """Adam; the bias correction is a host-side transform of the learning
    rate (``mxnet_tpu/optimizer.py:664-676``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _host_scalars(self, index):
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr = lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        return lr, self._get_wd(index)

    def _leaf_step(self, w, g, state, t, lr, wd):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m, v = state
        g = self._preprocess_wd_in_clip(g, w, wd)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return w - lr * m / (torch.sqrt(v) + eps), (m, v)


class Updater(object):
    """Applies an optimizer to (index, grad, weight) triples and owns the
    per-index state."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
