"""Optimizers: the port of ``mxnet_tpu/optimizer.py``, all 17 of its
registered names.

As in the JAX package an optimizer is two pieces: a host-side scalar
prologue :meth:`Optimizer._host_scalars` (per-index lr/wd multipliers,
schedule transforms such as Adam's bias correction, and the extra scalars
a kernel takes, Nadam's momentum schedule, all computed in Python) and a
kernel :meth:`Optimizer._leaf_step`. Here the kernel runs over
*lists* of parameters, written with ``torch._foreach_*`` ops that update
the weights and states in place: ``fastpath.fused_apply`` calls it once
over every parameter, and :meth:`Optimizer.update`, the per-parameter
path, calls the same function with one-element lists, so the two paths
are equal bit for bit (the JAX package gets that by sharing its
per-parameter ``_leaf_step`` between them). :meth:`Optimizer.pure_step`
is the same kernel with the learning rate and step count as 0-d device
tensors: ``parallel.TrainStep`` captures it inside a CUDA graph. Every
class has one where the JAX class has one (all but ``SGLD`` and
``Nadam``, whose prologue is a host recurrence or a host stream).

``multi_precision`` keeps a float32 master copy of every float16 or
bfloat16 weight (:func:`create_state_multi_precision`,
:meth:`Optimizer.update_multi_precision`, ``mxnet_tpu/optimizer.py:
58-110``): the kernel steps the master with the float32-cast gradient,
and the weight is the master cast back. The states are float32 too
(created from the master, as the reference MXNet's are).

Where a float16 or bfloat16 step meets the learning rate the kernel
promotes it to float32 first (:meth:`Optimizer._scale_lr`): JAX computes
``lr * g`` in float32 when ``lr`` is a float32 array, as it is in every
JAX update path, and a 0-d float32 tensor would not promote a bfloat16
tensor in torch.

``Updater.get_states``/``set_states`` serialize the states as the JAX
package does (``mxnet_tpu/optimizer.py:913-966``): a pickle of ``{index:
state}``, each state an array, a tuple, None, or ``(master, base)``
under ``multi_precision``, optionally with the optimizer. The arrays are
numpy, taken from the card in one batched transfer, and the optimizer
pickles without its caches and its ``param_dict`` (live Parameters), so
a states file holds numpy and plain Python only and loads without a
card; a states file without the optimizer loads in either package.
``set_states`` copies each array into the live state tensor of its
shape, cast to its dtype, so a captured step holding the tensor replays
with it; a state with no live tensor of its shape gets a new one. It
unpickles numpy, plain builtins and this package's classes only, so a
JAX ``Trainer.save_states`` file, which names the JAX optimizer's class,
is refused with an ``MXNetError``.

Departures: the weights and states are written in place, under
``torch.no_grad()``, where the JAX package rebinds new buffers, so a
bfloat16 weight updated without ``multi_precision`` stays bfloat16 (the
JAX update hands back a float32 one). ``SGLD`` draws its noise from the
port's generator of the weight's device (``random.generator``), in
parameter order, so its numbers differ from the JAX draws (a kept
deviation, as for the samplers); the fused and per-parameter paths draw
alike.
"""
from __future__ import annotations

import io
import math
import pickle
from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .telemetry import OPT_DISPATCHES

__all__ = ["Optimizer", "register", "create", "get_updater", "Updater",
           "SGD", "NAG", "Signum", "SignSGD", "FTML", "DCASGD", "SGLD",
           "LBSGD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "ensure_mp_state"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _tensor(x):
    return getattr(x, "_data", x)


def _is_mp_dtype(dtype):
    """Dtypes that keep a float32 master copy under ``multi_precision``:
    float16 and bfloat16."""
    return dtype in _LOW_PRECISION


def _structure(state):
    """A state's layout: None, "tensor", or a tuple of layouts."""
    if isinstance(state, (tuple, list)):
        return tuple(_structure(s) for s in state)
    return None if state is None else "tensor"


def _base_state_structure(optimizer, index, weight):
    """The layout ``create_state`` gives this weight, from a meta tensor
    (no memory), cached per (shape, dtype) on the optimizer."""
    w = _tensor(weight)
    cache = optimizer.__dict__.setdefault("_state_struct_cache", {})
    key = (tuple(w.shape), w.dtype)
    if key not in cache:
        cache[key] = _structure(optimizer.create_state(
            index, torch.empty(w.shape, dtype=w.dtype, device="meta")))
    return cache[key]


def _is_mp_pair(optimizer, index, weight, state):
    """Whether ``state`` is a ``(float32 master, base state)`` pair for
    this weight, the layout :meth:`Optimizer.create_state_multi_precision`
    makes. Adam's plain ``(m, v)`` is also a pair of float32 tensors of the
    weight's shape; it is told apart by its layout: in a true pair the
    second element has ``create_state``'s layout and the whole does not."""
    w = _tensor(weight)
    if not (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[0], torch.Tensor)
            and state[0].dtype == torch.float32
            and tuple(state[0].shape) == tuple(w.shape)):
        return False
    expected = _base_state_structure(optimizer, index, weight)
    second = _structure(state[1])
    if _structure(state) == expected and second != expected:
        return False  # the state is a plain create_state tuple
    return second == expected


def ensure_mp_state(optimizer, index, weight, state):
    """Adopt the master layout for a low-precision weight whose state
    predates it (a run resumed onto weights cast after their states were
    made): the current weight becomes the master, the state the base.
    Unchanged when ``multi_precision`` does not apply or the state is a
    pair already."""
    w = _tensor(weight)
    if not (optimizer.multi_precision and _is_mp_dtype(w.dtype)):
        return state
    if _is_mp_pair(optimizer, index, weight, state):
        return state
    return (w.detach().to(torch.float32, copy=True), state)


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
        raise MXNetError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
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

    def create_state_multi_precision(self, index, weight):
        """A float16 or bfloat16 weight under ``multi_precision`` gets
        ``(float32 master, state)``, the state made from the master;
        any other weight its plain state."""
        w = _tensor(weight)
        if self.multi_precision and _is_mp_dtype(w.dtype):
            master = w.detach().to(torch.float32, copy=True)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- the update protocol ----------------------------------------------
    def _host_scalars(self, index):
        """``(lr, wd, extras)`` for this parameter's update, after
        :meth:`_update_count`: ``extras`` is a tuple of the further
        numbers the kernel takes (Nadam's schedule), empty for most."""
        return self._get_lr(index), self._get_wd(index), ()

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        """The kernel over parallel lists: weight tensors ``ws`` and their
        states updated in place from gradients ``gs``; ``ts`` and ``lrs``
        are per-parameter Python numbers (or 0-d float32 device tensors
        holding them: ``trainplane`` captures the kernel so), ``wds``
        Python numbers, ``lr_scale`` an optional 0-d device tensor
        multiplying every learning rate, and ``extras`` the per-parameter
        tuples of :meth:`_host_scalars` (numbers or 0-d tensors)."""
        raise NotImplementedError("%s does not implement _leaf_step"
                                  % self.__class__.__name__)

    #: True where :meth:`_host_scalars` moves optimizer state or draws
    #: from a stream (Nadam's ``m_schedule``, SGLD's noise): the order of
    #: its calls is then observable (``fastpath.supports``).
    _host_scalars_stateful = False

    @property
    def fastpath_capable(self):
        """Whether ``fastpath.fused_apply`` can fold this optimizer's whole
        update into one call of its list kernel."""
        return type(self)._leaf_step is not Optimizer._leaf_step

    def pure_step(self, ws, gs, states, t, lr, lr_mults, wds):
        """The kernel as ``parallel.TrainStep`` captures it: ``t`` (the
        1-based step count) and ``lr`` are 0-d float32 device tensors, so
        one CUDA graph serves every step; parameter ``i``'s learning rate
        is ``lr * lr_mults[i]``. Optimizers with no schedule work alias it
        to :meth:`_pure_leaf`; Adam computes its bias correction from
        ``t`` on the device."""
        raise MXNetError(
            "%s does not implement pure_step; it cannot be captured in a "
            "train step - use Trainer/Updater instead"
            % self.__class__.__name__)

    def _pure_leaf(self, ws, gs, states, t, lr, lr_mults, wds):
        """:meth:`pure_step` for a kernel with no host schedule work: the
        kernel itself, every count ``t`` and the learning rate scaled by
        ``lr``."""
        self._leaf_step(ws, gs, states, [t] * len(ws), list(lr_mults), wds,
                        lr_scale=lr)

    def update(self, index, weight, grad, state):
        """Apply one parameter's update in place: the list kernel over
        one-element lists. Returns the state."""
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd, extras = self._host_scalars(index)
        OPT_DISPATCHES.inc(path="perparam")
        with torch.no_grad():
            self._leaf_step([_tensor(weight)], [_tensor(grad)], [state], [t],
                            [lr], [wd], extras=[extras])
        return state

    def update_multi_precision(self, index, weight, grad, state):
        """A float16 or bfloat16 weight under ``multi_precision``: the
        update steps the float32 master with the float32-cast gradient,
        then the weight becomes the master cast back. Any other weight:
        :meth:`update`. Returns the state."""
        w = _tensor(weight)
        if self.multi_precision and _is_mp_dtype(w.dtype):
            master, base = ensure_mp_state(self, index, weight, state)
            base = self.update(index, master,
                               _tensor(grad).to(torch.float32), base)
            with torch.no_grad():
                w.copy_(master)
            return (master, base)
        return self.update(index, weight, grad, state)

    def __getstate__(self):
        """What a states file keeps: plain Python. The state-layout cache
        and ``param_dict`` (live Parameters holding tensors) are dropped;
        ``Trainer.load_states`` reattaches its own parameters
        (``mxnet_tpu/optimizer.py:407-412``)."""
        st = self.__dict__.copy()
        st.pop("_state_struct_cache", None)
        st["param_dict"] = {}
        return st

    # -- lr / wd plumbing -------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined.")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers by index or name."""
        self.lr_mult = dict(args_lr_mult)

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

    def sync_num_update(self, t):
        """Advance the step counter to ``t`` when a captured train step
        (``parallel.TrainStep``) interleaves with eager updates: every
        per-index count, and the count an index not seen yet starts from,
        move up to ``t``, so the next eager update continues at ``t + 1``
        (``mxnet_tpu/optimizer.py:316``)."""
        t = int(t)
        self.num_update = max(self.num_update, t)
        self.begin_num_update = max(self.begin_num_update, t)
        for idx in self._index_update_count:
            self._index_update_count[idx] = max(
                self._index_update_count[idx], t)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
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

    # -- gradient prologues, over lists -----------------------------------
    def _preprocess(self, gs, ws, wds):
        """rescale -> clip -> + wd * weight (the sgd family); new tensors,
        the gradients are not written."""
        gs = torch._foreach_mul(gs, self.rescale_grad)
        self._clip(gs)
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        return gs

    def _preprocess_wd_in_clip(self, gs, ws, wds):
        """rescale -> + wd * weight -> clip (the adam family)."""
        gs = torch._foreach_mul(gs, self.rescale_grad)
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        self._clip(gs)
        return gs

    def _preprocess_no_wd(self, gs):
        """rescale -> clip; the weight decay is applied at the update
        (AdaGrad, AdaDelta, DCASGD)."""
        gs = torch._foreach_mul(gs, self.rescale_grad)
        self._clip(gs)
        return gs

    def _clip(self, gs):
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(gs, -self.clip_gradient)
            torch._foreach_clamp_max_(gs, self.clip_gradient)

    @staticmethod
    def _scale_lr(xs, lrs, lr_scale):
        """``x_i * lr_i`` (and ``* lr_scale`` if given), in place on a
        float32 ``x_i``. A float16 or bfloat16 ``x_i`` is promoted to
        float32 first, where JAX promotes ``lr * g``. Returns the list."""
        xs = [x.to(torch.float32) if x.dtype in _LOW_PRECISION else x
              for x in xs]
        torch._foreach_mul_(xs, lrs)
        if lr_scale is not None:
            torch._foreach_mul_(xs, lr_scale)
        return xs


def _eff_lrs(lrs, lr_scale):
    """The per-parameter learning rates with ``lr_scale`` folded in."""
    if lr_scale is None:
        return list(lrs)
    return [lr * lr_scale for lr in lrs]


def _sqrt(x):
    return x.sqrt() if isinstance(x, torch.Tensor) else math.sqrt(x)


def _one_minus_pow(b, t):
    """``1 - b ** t`` for a count ``t`` that is a number or a 0-d
    tensor."""
    if isinstance(t, torch.Tensor):
        return 1.0 - torch.pow(b, t)
    return 1.0 - b ** t


def _copy_all(dsts, srcs):
    for d, s in zip(dsts, srcs):
        d.copy_(s)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum: ``m = momentum * m - lr * g`` then
    ``w += m`` (MXNet's form, not ``torch.optim.SGD``'s)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(_tensor(weight))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        step = self._scale_lr(self._preprocess(gs, ws, wds), lrs, lr_scale)
        if states[0] is None:
            torch._foreach_sub_(ws, step)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, step)
        torch._foreach_add_(ws, states)

    def pure_step(self, ws, gs, states, t, lr, lr_mults, wds):
        self._leaf_step(ws, gs, states, None, lr_mults, wds, lr_scale=lr)


@register
class Adam(Optimizer):
    """Adam; the bias correction is a host-side transform of the learning
    rate (``mxnet_tpu/optimizer.py:664-676``), computed on the device from
    the step count in :meth:`pure_step`."""

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
        return lr, self._get_wd(index), ()

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        b1, b2 = self.beta1, self.beta2
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        gs = self._preprocess_wd_in_clip(gs, ws, wds)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        step = self._scale_lr(torch._foreach_div(ms, denom), lrs, lr_scale)
        torch._foreach_sub_(ws, step)

    def pure_step(self, ws, gs, states, t, lr, lr_mults, wds):
        b1, b2 = self.beta1, self.beta2
        scale = lr * torch.sqrt(1.0 - torch.pow(b2, t)) \
            / (1.0 - torch.pow(b1, t))
        self._leaf_step(ws, gs, states, None, lr_mults, wds, lr_scale=scale)


@register
class Test(Optimizer):
    """The debug optimizer: ``w -= lr * g * rescale_grad``; the state is a
    zero tensor that no step reads (``mxnet_tpu/optimizer.py:420``)."""

    def create_state(self, index, weight):
        return torch.zeros_like(_tensor(weight))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        step = torch._foreach_mul(gs, self.rescale_grad)
        torch._foreach_sub_(ws, self._scale_lr(step, lrs, lr_scale))

    pure_step = Optimizer._pure_leaf


@register
class ccSGD(SGD):  # noqa: N801 - MXNet's name
    """The deprecated alias of SGD."""


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD: ``m = momentum * m + g`` then ``w -= lr
    * (momentum * m + g)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(_tensor(weight))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        lrs = _eff_lrs(lrs, lr_scale)
        gs = self._preprocess(gs, ws, wds)
        if states[0] is None:
            torch._foreach_sub_(ws, self._scale_lr(gs, lrs, None))
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_add_(states, gs)
        ahead = torch._foreach_mul(states, self.momentum)
        torch._foreach_add_(ahead, gs)
        torch._foreach_sub_(ws, self._scale_lr(ahead, lrs, None))

    pure_step = Optimizer._pure_leaf


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w -= lr / 2 * g`` plus
    normal noise of variance ``lr``, drawn from the port's generator of
    the weight's device, one draw a parameter in parameter order."""

    _host_scalars_stateful = True  # draws from the device's stream

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        from .random import generator

        lrs = _eff_lrs(lrs, lr_scale)
        gs = self._preprocess(gs, ws, wds)
        half = self._scale_lr(gs, [lr / 2 for lr in lrs], None)
        torch._foreach_sub_(ws, half)
        for w, lr in zip(ws, lrs):
            noise = torch.randn(w.shape, generator=generator(w.device),
                                device=w.device, dtype=w.dtype)
            w.add_(noise * _sqrt(lr))


@register
class SignSGD(Optimizer):
    """``w -= lr * (sign(g) + wd * w)`` on the rescaled, clipped
    gradient."""

    def _sign_step(self, ws, gs, lrs, wds):
        gs = torch._foreach_mul(gs, self.rescale_grad)
        self._clip(gs)
        step = torch._foreach_sign(gs)
        torch._foreach_add_(step, torch._foreach_mul(ws, wds))
        torch._foreach_sub_(ws, self._scale_lr(step, lrs, None))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        self._sign_step(ws, gs, _eff_lrs(lrs, lr_scale), wds)

    pure_step = Optimizer._pure_leaf


@register
class Signum(SignSGD):
    """Sign of the momentum: ``m = momentum * m - (1 - momentum) * g``
    then ``w += lr * sign(m) - lr * wd_lh * w``; without momentum,
    SignSGD's step."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(_tensor(weight))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        lrs = _eff_lrs(lrs, lr_scale)
        if states[0] is None:
            self._sign_step(ws, gs, lrs, wds)
            return
        gs = self._preprocess(gs, ws, wds)
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_add_(states, gs, alpha=-(1 - self.momentum))
        decay = None
        if self.wd_lh:
            decay = self._scale_lr(torch._foreach_mul(ws, self.wd_lh), lrs,
                                   None)
        torch._foreach_add_(ws, self._scale_lr(torch._foreach_sign(states),
                                               lrs, None))
        if decay is not None:
            torch._foreach_sub_(ws, decay)


@register
class FTML(Optimizer):
    """Follow the Moving Leader; the bias corrections come from each
    parameter's count."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w),
                torch.zeros_like(w))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        b1, b2 = self.beta1, self.beta2
        lrs = _eff_lrs(lrs, lr_scale)
        ds = [s[0] for s in states]
        vs = [s[1] for s in states]
        zs = [s[2] for s in states]
        gs = self._preprocess_wd_in_clip(gs, ws, wds)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        d_t = torch._foreach_div(vs, [_one_minus_pow(b2, t) for t in ts])
        torch._foreach_sqrt_(d_t)
        torch._foreach_add_(d_t, self.epsilon)
        torch._foreach_mul_(d_t, [_one_minus_pow(b1, t) / lr
                                  for t, lr in zip(ts, lrs)])
        sigma = torch._foreach_sub(d_t, torch._foreach_mul(ds, b1))
        torch._foreach_mul_(zs, b1)
        torch._foreach_add_(zs, gs, alpha=1 - b1)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, ws))
        _copy_all(ds, d_t)
        new_w = torch._foreach_div(zs, d_t)
        torch._foreach_neg_(new_w)
        _copy_all(ws, new_w)

    pure_step = Optimizer._pure_leaf


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the step adds ``lamda * g * g * (w -
    previous w)``; the state keeps the weight before the step."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        w = _tensor(weight)
        if self.momentum == 0.0:
            return (None, w.detach().clone())
        return (torch.zeros_like(w), w.detach().clone())

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        lrs = _eff_lrs(lrs, lr_scale)
        moms = [s[0] for s in states]
        prevs = [s[1] for s in states]
        gs = self._preprocess_no_wd(gs)
        comp = torch._foreach_mul(gs, self.lamda)
        torch._foreach_mul_(comp, gs)
        torch._foreach_mul_(comp, torch._foreach_sub(ws, prevs))
        term = torch._foreach_add(gs, torch._foreach_mul(ws, wds))
        torch._foreach_add_(term, comp)
        step = self._scale_lr(term, lrs, None)
        _copy_all(prevs, ws)
        if moms[0] is None:
            torch._foreach_sub_(ws, step)
            return
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, step)
        torch._foreach_add_(ws, moms)

    pure_step = Optimizer._pure_leaf


@register
class LBSGD(Optimizer):
    """Large-batch SGD with the LARS layer-wise rate ``|w| / (|g| +
    1e-9)`` (1 where a norm is 0), the JAX package's simplified core."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(_tensor(weight))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        lrs = _eff_lrs(lrs, lr_scale)
        gs = self._preprocess(gs, ws, wds)
        wnorms = torch._foreach_norm(ws)
        gnorms = torch._foreach_norm(gs)
        eff = [lr * torch.where((wn > 0) & (gn > 0), wn / (gn + 1e-9),
                                torch.ones_like(wn))
               for lr, wn, gn in zip(lrs, wnorms, gnorms)]
        step = self._scale_lr(gs, eff, None)
        if states[0] is None:
            torch._foreach_sub_(ws, step)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, step)
        torch._foreach_add_(ws, states)

    pure_step = Optimizer._pure_leaf


@register
class AdaGrad(Optimizer):
    """AdaGrad: ``h += g * g``, ``w -= lr * (g / sqrt(h + eps) + wd *
    w)``; the weight decay stays out of the history."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(_tensor(weight))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        gs = self._preprocess_no_wd(gs)
        torch._foreach_addcmul_(states, gs, gs)
        den = torch._foreach_add(states, self.float_stable_eps)
        torch._foreach_sqrt_(den)
        step = torch._foreach_div(gs, den)
        torch._foreach_add_(step, torch._foreach_mul(ws, wds))
        torch._foreach_sub_(ws, self._scale_lr(step, lrs, lr_scale))

    pure_step = Optimizer._pure_leaf


@register
class RMSProp(Optimizer):
    """RMSProp, plain (state ``(n,)``) or centered after Graves (state
    ``(n, mean g, delta)``), with optional ``clip_weights``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        w = _tensor(weight)
        if self.centered:
            return (torch.zeros_like(w), torch.zeros_like(w),
                    torch.zeros_like(w))
        return (torch.zeros_like(w),)

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        g1 = self.gamma1
        gs = self._preprocess_wd_in_clip(gs, ws, wds)
        ns = [s[0] for s in states]
        torch._foreach_mul_(ns, g1)
        torch._foreach_addcmul_(ns, gs, gs, value=1 - g1)
        if len(states[0]) == 1:
            den = torch._foreach_add(ns, self.epsilon)
            torch._foreach_sqrt_(den)
            step = self._scale_lr(torch._foreach_div(gs, den), lrs,
                                  lr_scale)
            torch._foreach_sub_(ws, step)
        else:
            mgs = [s[1] for s in states]
            deltas = [s[2] for s in states]
            torch._foreach_mul_(mgs, g1)
            torch._foreach_add_(mgs, gs, alpha=1 - g1)
            den = torch._foreach_sub(ns, torch._foreach_mul(mgs, mgs))
            torch._foreach_add_(den, self.epsilon)
            torch._foreach_sqrt_(den)
            step = self._scale_lr(torch._foreach_div(gs, den), lrs,
                                  lr_scale)
            torch._foreach_mul_(deltas, self.gamma2)
            torch._foreach_sub_(deltas, step)
            torch._foreach_add_(ws, deltas)
        if self.clip_weights:
            torch._foreach_clamp_min_(ws, -self.clip_weights)
            torch._foreach_clamp_max_(ws, self.clip_weights)

    pure_step = Optimizer._pure_leaf


@register
class AdaDelta(Optimizer):
    """AdaDelta; no learning rate, the weight decay applied at the
    update."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        rho, eps = self.rho, self.epsilon
        gs = self._preprocess_no_wd(gs)
        acc_g = [s[0] for s in states]
        acc_d = [s[1] for s in states]
        torch._foreach_mul_(acc_g, rho)
        torch._foreach_addcmul_(acc_g, gs, gs, value=1 - rho)
        delta = torch._foreach_add(acc_d, eps)
        torch._foreach_sqrt_(delta)
        den = torch._foreach_add(acc_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(delta, den)
        torch._foreach_mul_(delta, gs)
        torch._foreach_mul_(acc_d, rho)
        torch._foreach_addcmul_(acc_d, delta, delta, value=1 - rho)
        torch._foreach_add_(delta, torch._foreach_mul(ws, wds))
        torch._foreach_sub_(ws, delta)

    pure_step = Optimizer._pure_leaf


@register
class Ftrl(Optimizer):
    """FTRL-proximal; state ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        l1, beta = self.lamda1, self.beta
        lrs = _eff_lrs(lrs, lr_scale)
        gs = self._preprocess_no_wd(gs)
        zs = [s[0] for s in states]
        ns = [s[1] for s in states]
        gg = torch._foreach_mul(gs, gs)
        sigma = torch._foreach_add(ns, gg)
        torch._foreach_sqrt_(sigma)
        torch._foreach_sub_(sigma, torch._foreach_sqrt(ns))
        torch._foreach_div_(sigma, lrs)
        torch._foreach_add_(zs, gs)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, ws))
        torch._foreach_add_(ns, gg)
        for w, z, n, lr, wd in zip(ws, zs, ns, lrs, wds):
            shrunk = -(z - torch.sign(z) * l1) / ((beta + n.sqrt()) / lr + wd)
            w.copy_(torch.where(z.abs() > l1, shrunk,
                                torch.zeros_like(shrunk)))

    pure_step = Optimizer._pure_leaf


@register
class Adamax(Optimizer):
    """AdaMax: the infinity-norm Adam; the bias correction ``lr / (1 -
    beta1 ** t)`` is a host-side transform of the learning rate."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def _host_scalars(self, index):
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        return lr, self._get_wd(index), ()

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        b1, b2 = self.beta1, self.beta2
        gs = self._preprocess_wd_in_clip(gs, ws, wds)
        ms = [s[0] for s in states]
        us = [s[1] for s in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(us, b2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        den = torch._foreach_add(us, 1e-8)
        step = self._scale_lr(torch._foreach_div(ms, den), lrs, lr_scale)
        torch._foreach_sub_(ws, step)

    def pure_step(self, ws, gs, states, t, lr, lr_mults, wds):
        scale = lr / (1.0 - torch.pow(self.beta1, t))
        self._leaf_step(ws, gs, states, None, lr_mults, wds, lr_scale=scale)


@register
class Nadam(Optimizer):
    """Nesterov Adam. The momentum schedule is a host recurrence
    (``m_schedule`` multiplies up at every prologue call), so its four
    numbers reach the kernel as :meth:`_host_scalars`' extras."""

    _host_scalars_stateful = True  # m_schedule multiplies up per call

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _host_scalars(self, index):
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (
            1.0 - 0.5 * (0.96 ** (t * self.schedule_decay)))
        momentum_t_1 = self.beta1 * (
            1.0 - 0.5 * (0.96 ** ((t + 1) * self.schedule_decay)))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        return (self._get_lr(index), self._get_wd(index),
                (momentum_t, momentum_t_1, self.m_schedule,
                 m_schedule_next))

    def _leaf_step(self, ws, gs, states, ts, lrs, wds, lr_scale=None,
                   extras=None):
        b1, b2 = self.beta1, self.beta2
        mts = [e[0] for e in extras]
        mt1s = [e[1] for e in extras]
        ms_now = [e[2] for e in extras]
        ms_next = [e[3] for e in extras]
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        gs = self._preprocess_wd_in_clip(gs, ws, wds)
        g_prime = torch._foreach_div(gs, [1.0 - x for x in ms_now])
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1.0 - b1)
        m_prime = torch._foreach_div(ms, [1.0 - x for x in ms_next])
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
        v_prime = torch._foreach_div(vs, [_one_minus_pow(b2, t)
                                          for t in ts])
        torch._foreach_mul_(g_prime, [1.0 - x for x in mts])
        torch._foreach_mul_(m_prime, mt1s)
        torch._foreach_add_(g_prime, m_prime)
        torch._foreach_sqrt_(v_prime)
        torch._foreach_add_(v_prime, self.epsilon)
        step = self._scale_lr(torch._foreach_div(g_prime, v_prime), lrs,
                              lr_scale)
        torch._foreach_sub_(ws, step)


class Updater(object):
    """Applies an optimizer to (index, grad, weight) triples and owns the
    per-index state (``mxnet_tpu/optimizer.py:890-910``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.states[index] = self.optimizer.update_multi_precision(
            index, weight, grad, self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states as bytes: a pickle of ``{index: state}`` with numpy
        leaves (one batched transfer from the card), and with
        ``dump_optimizer`` the pair ``(states, optimizer)``."""
        from .base import fetch_host

        leaves = [t for s in self.states.values() for t in _state_leaves(s)]
        it = iter(fetch_host(leaves))
        host = {k: _rebuild_state(s, it) for k, s in self.states.items()}
        return pickle.dumps((host, self.optimizer) if dump_optimizer
                            else host)

    def sync_state_context(self, state, context):
        """Reference ``Updater.sync_state_context``: the state as it is,
        as in the JAX package (a state lives where its weight lives)."""
        return state

    def set_states(self, states, device=None):
        """Restore :meth:`get_states` bytes (of either package). A state
        array goes into the live state tensor of the same index and place
        when it has that shape (copied in place, cast to its dtype), else
        into a new tensor on ``device`` (by default the live state's
        device, else the current context). A pickled optimizer replaces
        this one."""
        from .context import current_context
        from .ndarray.io_utils import device_arrays

        obj = _StatesUnpickler(io.BytesIO(states)).load()
        if isinstance(obj, tuple) and len(obj) == 2:
            obj, self.optimizer = obj
        live = self.states
        pairs = [pair for k, v in obj.items()
                 for pair in _state_pairs(live.get(k), v)]
        if device is None:
            device = next((t.device for t, _ in pairs if t is not None),
                          None)
        if device is None:
            device = current_context().torch_device()
        tensors = iter(device_arrays([a for _, a in pairs], device))
        restored = []
        with torch.no_grad():
            for old, _ in pairs:
                new = next(tensors)
                if old is None:
                    restored.append(new)
                else:
                    old.copy_(new)
                    restored.append(old)
        it = iter(restored)
        self.states = {k: _rebuild_state(v, it) for k, v in obj.items()}


_PLAIN_BUILTINS = frozenset((
    "bool", "int", "float", "complex", "str", "bytes", "bytearray", "tuple",
    "list", "dict", "set", "frozenset", "slice", "range"))


class _StatesUnpickler(pickle.Unpickler):
    """Unpickles what a states file of the port may name: numpy (and
    ml_dtypes' numpy types), plain builtins and this package's classes. A
    JAX ``Trainer.save_states`` file names the JAX optimizer's class, and
    is refused here without importing the JAX package."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top in ("numpy", "ml_dtypes", "mxnet_tpu_torch") or (
                module == "builtins" and name in _PLAIN_BUILTINS):
            return super().find_class(module, name)
        raise MXNetError(
            "the states file names %s.%s: a states file of this package "
            "holds numpy, plain Python and its own optimizer only, and a "
            "Trainer.save_states file loads only in the package that wrote "
            "it" % (module, name))


def _state_leaves(state):
    """A state's tensors, depth first."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _state_leaves(s)]
    return [state]


def _rebuild_state(state, values):
    """``state``'s layout with its leaves taken in order from ``values``
    (tuples stay tuples, lists lists, None None)."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_rebuild_state(s, values) for s in state)
    return next(values)


def _state_pairs(live, saved):
    """``(live tensor or None, saved array)`` for each array of a saved
    state, depth first: the live tensor at the same place when it has the
    array's shape."""
    if saved is None:
        return []
    if isinstance(saved, (tuple, list)):
        same = isinstance(live, (tuple, list)) and len(live) == len(saved)
        return [p for i, s in enumerate(saved)
                for p in _state_pairs(live[i] if same else None, s)]
    keep = isinstance(live, torch.Tensor) and \
        tuple(live.shape) == tuple(np.shape(saved))
    return [(live if keep else None, saved)]


def get_updater(optimizer):
    return Updater(optimizer)
