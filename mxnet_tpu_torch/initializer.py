"""Weight initializers: the port of ``mxnet_tpu/initializer.py`` (the
registry, name-suffix dispatch, the ``__init__`` attribute that names a
parameter's own initializer, and all fifteen classes: ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``FusedRNN``, ``Load`` and
``Mixed``).

Initialization is host-side numpy drawn from :func:`random.np_rng`, in
the order the JAX package draws, so a seed gives bit-identical weights in
both packages; the result is written into the parameter's NDArray (or,
for a numpy array, into the array itself).
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np
import torch

from .base import MXNetError, np_dtype

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "FusedRNN", "Load", "Mixed"]

_INIT_REGISTRY = {}


class InitDesc(str):
    """Parameter name plus attrs (``__init__`` overrides the dispatch);
    ``global_init`` is the initializer that dispatched it."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
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
    suffix (``mxnet_tpu/initializer.py:74-109``) — ``weight`` by
    :meth:`_init_weight`, a fused RNN's ``parameters`` from U(-0.07,
    0.07), ``bias``/``beta``, a moving mean, ``min``/``max`` and an RNN
    ``state`` with 0, ``gamma`` and a moving variance with 1 — unless
    ``desc.attrs['__init__']`` names an initializer for this parameter,
    which then fills it whatever its name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        """With ``verbose``, log each array this initializer fills: its
        name and ``print_func`` of its values as a host numpy array (by
        default their root mean square)."""
        self._verbose = verbose
        self._print_func = print_func or (
            lambda x: np.linalg.norm(np.asarray(x))
            / np.sqrt(np.asarray(x).size))
        return self

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            create(klass, **kwargs)._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("parameters"):
            # a fused RNN's packed 1-d vector: shape-aware initializers
            # cannot apply, so a small uniform, as the JAX package does
            Uniform(0.07)._init_weight(desc, arr)
        elif desc.endswith("bias") or desc.endswith("beta"):
            self._set(arr, np.zeros(self._shape(arr)))
        elif desc.endswith("gamma"):
            self._set(arr, np.ones(self._shape(arr)))
        elif desc.endswith("running_var") or desc.endswith("moving_var"):
            self._set(arr, np.ones(self._shape(arr)))
        elif desc.endswith(("running_mean", "moving_mean", "moving_inv_var",
                            "moving_avg", "min", "max", "state",
                            "state_cell")):
            self._set(arr, np.zeros(self._shape(arr)))
        else:
            self._init_default(desc, arr)
        if self._verbose:
            host = arr.asnumpy() if hasattr(arr, "asnumpy") \
                else np.asarray(arr)
            logging.info("Initialized %s: %s", desc, self._print_func(host))

    def _init_default(self, name, arr):
        raise MXNetError(
            "Unknown initialization pattern for %s. Default "
            "initialization is limited to weight/bias/gamma/beta; set "
            "Parameter init explicitly for other names." % name)

    @staticmethod
    def _set(arr, value):
        """Write ``value`` into ``arr``, cast to its dtype by numpy (round
        to nearest, as the JAX package's cast): an NDArray takes a new
        tensor on its device, a numpy array is written in place."""
        if not hasattr(arr, "_data"):
            arr[:] = np.asarray(value, dtype=arr.dtype)
            return
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


@register
class Constant(Initializer):
    """Every value ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._set(arr, np.full(self._shape(arr), self.value))


@register
class Orthogonal(Initializer):
    """An orthogonal matrix times ``scale`` (``mxnet_tpu/initializer.py:
    213-235``): the left or right singular vectors of a (nout, nin) draw,
    uniform in [-1, 1] or standard normal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        from . import random as _random

        shape = self._shape(arr)
        nout, nin = shape[0], int(np.prod(shape[1:]))
        if self.rand_type == "uniform":
            tmp = _random.np_rng().uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _random.np_rng().normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        self._set(arr, (self.scale * q).reshape(shape))


@register
class MSRAPrelu(Xavier):
    """He/MSRA init for PReLU nets: gaussian Xavier of magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel over the last two axes
    (``mxnet_tpu/initializer.py:285-299``, in float64 then float32, as
    there)."""

    def _init_weight(self, _, arr):
        shape = self._shape(arr)
        i = np.arange(int(np.prod(shape)))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        self._set(arr, weight.astype(np.float32).reshape(shape))


@register
class LSTMBias(Initializer):
    """LSTM biases: 0, except the forget gate's quarter (gates i, f, c,
    o) at ``forget_bias``. Reached through a parameter's ``__init__``
    attribute, which dispatches to it whatever the name."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        shape = self._shape(arr)
        bias = np.zeros(shape)
        num_hidden = shape[0] // 4
        bias[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, bias)


@register
class FusedRNN(Initializer):
    """A fused RNN's parameter vector by ``init`` (an initializer or its
    ``dumps()``), applied to the whole vector, as the JAX package's does
    (``mxnet_tpu/initializer.py:318-341``)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        if self._init is not None:
            self._init._init_weight(desc, arr)


@register
class Load(object):
    """Values from a dict of arrays (``arg:``/``aux:`` tags dropped), by
    name; a name not in it goes to ``default_init``, and without one
    raises. A shape that differs raises."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {}
        for name, arr in param.items():
            if name.startswith("arg:") or name.startswith("aux:"):
                name = name[4:]
            self.param[name] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, arr.shape, src.shape))
            Initializer._set(arr, np.asarray(src))
        else:
            if self.default_init is None:
                raise MXNetError(
                    "Cannot Initialize parameter %s. Not found in loaded "
                    "param and no default initializer." % name)
            self.default_init(name, arr)


@register
class Mixed(object):
    """The first initializer whose regular expression matches the name
    (``re.match``); no match raises."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have the same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError(
            'Parameter name %s did not match any pattern. Consider adding a '
            '".*" pattern at the end with a default initializer.' % name)
