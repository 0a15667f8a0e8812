"""Weight initializers: the port of ``mxnet_tpu/initializer.py`` (the
registry, name-suffix dispatch, ``Zero``, ``One``, ``Uniform``, ``Normal``
and ``Xavier``).

Initialization is host-side numpy drawn from :func:`random.np_rng`, in
the order the JAX package draws, so a seed gives bit-identical weights in
both packages; the result is written into the parameter's NDArray. The
other initializers of the JAX module are not ported yet.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .base import MXNetError, np_dtype

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Uniform", "Normal", "Xavier"]

_INIT_REGISTRY = {}


class InitDesc(str):
    """Parameter name plus attrs (``__init__`` overrides the dispatch)."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer) or callable(name):
        return name
    key = str(name).lower()
    if key not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r (not ported yet?)" % (name,))
    return _INIT_REGISTRY[key](**kwargs)


class Initializer(object):
    """Base initializer: ``init(desc, arr)`` fills ``arr`` by the name's
    suffix — ``weight`` by :meth:`_init_weight`, ``bias``/``beta`` and a
    moving (running) mean with 0, ``gamma`` and a moving variance with
    1 — unless ``desc.attrs['__init__']`` names an
    initializer for this parameter."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            create(klass, **kwargs)._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias") or desc.endswith("beta"):
            self._set(arr, np.zeros(self._shape(arr)))
        elif desc.endswith("gamma"):
            self._set(arr, np.ones(self._shape(arr)))
        elif desc.endswith("running_mean") or desc.endswith("moving_mean"):
            self._set(arr, np.zeros(self._shape(arr)))
        elif desc.endswith("running_var") or desc.endswith("moving_var"):
            self._set(arr, np.ones(self._shape(arr)))
        else:
            raise MXNetError(
                "Unknown initialization pattern for %s. Default "
                "initialization is limited to weight/bias/gamma/beta; set "
                "Parameter init explicitly for other names." % desc)

    @staticmethod
    def _set(arr, value):
        """Write ``value`` into NDArray ``arr``, cast to its dtype by numpy
        (round to nearest, as the JAX package's cast)."""
        t = arr._data
        host = np.asarray(value)
        if t.dtype == torch.bfloat16:
            new = torch.from_numpy(np.ascontiguousarray(host, np.float32))
        else:
            new = torch.from_numpy(np.ascontiguousarray(
                host, np.dtype(np_dtype(t.dtype))))
        arr._data = new.to(device=t.device, dtype=t.dtype)

    @staticmethod
    def _shape(arr):
        return tuple(arr.shape)

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override _init_weight")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, np.zeros(self._shape(arr)))


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, np.ones(self._shape(arr)))


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        from . import random as _random

        self._set(arr, _random.np_rng().uniform(-self.scale, self.scale,
                                                self._shape(arr)))


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        from . import random as _random

        self._set(arr, _random.np_rng().normal(0, self.sigma,
                                               self._shape(arr)))


@register
class Xavier(Initializer):
    """Xavier/Glorot init (``mxnet_tpu/initializer.py:241-267``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        from . import random as _random

        shape = self._shape(arr)
        if len(shape) < 2:
            raise MXNetError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, _random.np_rng().uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            self._set(arr, _random.np_rng().normal(0, scale, shape))
        else:
            raise MXNetError("Unknown random type")
