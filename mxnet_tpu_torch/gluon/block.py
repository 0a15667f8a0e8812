"""Gluon Block / HybridBlock: the port of ``mxnet_tpu/gluon/block.py``
(name scopes and prefixes, children, ``collect_params``, ``initialize``,
and the eager ``hybrid_forward(F, ...)`` call with ``F`` the port's
``nd``).

``hybridize(active, static_alloc, static_shape, **kw)`` records its
flags, as the JAX package's does (``mxnet_tpu/gluon/block.py:443-456``),
and a hybridized block then runs the same eager torch calls as before,
so it gives the same bits. The JAX package compiles a hybridized block
into one jitted module; the port's
compiled paths are whole steps instead, ``parallel.TrainStep``,
``parallel.InferStep`` and ``trainplane.TrainPlane``, each a CUDA graph.
A graph per block call would not do: a graph's output buffer is written
again by its next replay, while the caller may still hold the last
output.

``cast(dtype)`` casts every parameter of the block and its children, the
BatchNorm moving statistics included.

``save_parameters``/``load_parameters`` (aliases ``save_params``/
``load_params``) write and read a ``.params`` file keyed by attribute
path (``features.0.weight``), as the JAX package's do; a file of full
names without a dot (``ParameterDict.save``) loads through the legacy
path. A load copies into the parameters' tensors in place (see
``gluon/parameter.py``).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from ..base import MXNetError
from ..name import NameManager
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope(object):
    """Name scoping for Blocks."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block(object):
    """Base building block."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__,
                           ", ".join(self._children))

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError("Changing attribute type for %s from %s to "
                                "%s is not allowed."
                                % (name, type(existing), type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params and self._reg_params[name] is not \
                    value:
                raise MXNetError("Overriding Parameter attribute %s is not "
                                 "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """All Parameters of this block and its children."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters keyed by their attribute path from this block
        (``mxnet_tpu/gluon/block.py:198``)."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Save the parameters keyed by attribute path (loadable without
        the block's name prefix; ``mxnet_tpu/gluon/block.py:207-216``)."""
        from ..ndarray import io_utils

        params = self._collect_params_with_prefix()
        io_utils.save(filename, {key: val.data()
                                 for key, val in params.items()})

    save_params = save_parameters

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a ``save_parameters`` file, or a legacy file of full names
        (``mxnet_tpu/gluon/block.py:218-245``); a missing or extra name
        raises unless allowed."""
        from ..context import Context
        from ..ndarray import io_utils

        loaded = io_utils.load(filename, ctx[0] if isinstance(
            ctx, (list, tuple)) else ctx)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in i for i in loaded.keys()):
            # legacy format: full parameter names
            del loaded
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix)
            return
        if isinstance(ctx, Context):
            ctx = [ctx]
        if not allow_missing:
            for name in params.keys():
                if name not in loaded:
                    raise MXNetError("Parameter '%s' is missing in file "
                                     "'%s'." % (name, filename))
        for name in loaded:
            if name not in params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in this block." % (name, filename))
                continue
            params[name]._load_init(loaded[name], ctx)

    load_params = load_parameters

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            from .. import initializer

            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Hybridize every child (a plain Block has nothing of its own to
        hybridize)."""
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        ``dtype``."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block written as ``hybrid_forward(self, F, x, *args, **params)``,
    with ``F`` the ``nd`` namespace and the block's parameters arriving as
    keyword NDArrays, as in MXNet. Runs eagerly, hybridized or not (see
    the module's docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Record the flags (``static_alloc`` and ``static_shape`` are kept
        for MXNet's API: a captured step is static by construction), then
        hybridize the children. A port block caches no compiled path, so
        there is none to clear."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _eager_forward(self, x, *args):
        from .. import ndarray as F

        try:
            params = {i: j.data(x.context)
                      for i, j in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(x, *args)
            params = {i: j.data(x.context)
                      for i, j in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def _finish_deferred(self, x, *args):
        """Resolve deferred shapes from the input, then initialize."""
        self.shape_hint(x, *args)
        for p in self._reg_params.values():
            p._finish_deferred_init()

    def shape_hint(self, x, *args):
        """Layers override this to fill 0-dims of their params from x."""

    def forward(self, x, *args):
        if not isinstance(x, NDArray):
            raise MXNetError("HybridBlock takes NDArray inputs, got %s"
                             % type(x).__name__)
        return self._eager_forward(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
