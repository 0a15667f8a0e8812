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

A ``HybridBlock`` called on a Symbol traces itself: each parameter
enters as its ``Parameter.var()`` (a ``grad_req='null'`` one marked an
auxiliary state) and ``hybrid_forward`` runs with ``F`` the port's
``symbol`` module, as the JAX package's does
(``mxnet_tpu/gluon/block.py:490-507``). ``export(path)`` writes that
trace as ``<path>-symbol.json`` and the values as
``<path>-%04d.params`` under ``arg:``/``aux:`` names, files that either
package's ``SymbolBlock.imports`` reads. A ``SymbolBlock`` runs a graph
through ``Symbol.eval_nd`` on its input's device; as in the JAX package,
no gradient reaches its parameters or its input.

Forward hooks and pre-hooks run around every ``Block.__call__``
(``register_forward_hook``/``register_forward_pre_hook`` give a handle
whose ``detach()`` removes the hook); ``apply(fn)`` calls ``fn`` on
every child, then the block; ``summary(*inputs)`` prints each leaf
block's output shapes and parameter count from one forward.

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

import numpy as np

from ..base import MXNetError
from ..name import NameManager
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


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
        self._forward_hooks = OrderedDict()
        self._forward_pre_hooks = OrderedDict()

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

    def register_forward_pre_hook(self, hook):
        """Run ``hook(block, inputs)`` before each forward; returns a
        handle whose ``detach()`` removes it."""
        handle = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[handle._id] = hook
        return handle

    def register_forward_hook(self, hook):
        """Run ``hook(block, inputs, outputs)`` after each forward;
        returns a handle whose ``detach()`` removes it."""
        handle = _HookHandle(self._forward_hooks)
        self._forward_hooks[handle._id] = hook
        return handle

    def apply(self, fn):
        """Call ``fn`` on every child (depth first), then on this block;
        returns the block."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

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
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print, for this block and every child, the output shapes and
        the count of the block's own parameters from one forward on
        ``inputs``, then the total (``mxnet_tpu/gluon/block.py:302-336``,
        the same table)."""
        summary = OrderedDict()
        hooks = []

        def _register(block, prefix):
            def hook(blk, inp, out):
                outs = out if isinstance(out, (list, tuple)) else [out]
                summary[prefix + blk.__class__.__name__] = (
                    [tuple(o.shape) for o in outs if isinstance(o, NDArray)],
                    sum(int(np.prod(p.shape))
                        for p in blk._reg_params.values()
                        if p.shape is not None))

            hooks.append(block.register_forward_hook(hook))
            for cname, child in block._children.items():
                _register(child, prefix + cname + ".")

        _register(self, "")
        try:
            self(*inputs)
        finally:
            for h in hooks:
                h.detach()
        lines = ["%-40s %-24s %12s" % ("Layer", "Output Shape", "Params"),
                 "=" * 78]
        total = 0
        for name, (shape, n) in summary.items():
            lines.append("%-40s %-24s %12d" % (name, str(shape), n))
            total += n
        lines.append("=" * 78)
        lines.append("Total params (leaf blocks): %d" % total)
        print("\n".join(lines))


class _HookHandle(object):
    """A registered hook; ``detach()`` removes it."""

    _next_id = [0]

    def __init__(self, hooks_dict):
        self._hooks_dict = hooks_dict
        self._id = _HookHandle._next_id[0]
        _HookHandle._next_id[0] += 1

    def detach(self):
        self._hooks_dict.pop(self._id, None)


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

    def infer_shape(self, *args):
        """Finish the deferred initialization of the parameters from
        example inputs: one eager forward with recording paused."""
        from .. import autograd

        with autograd.pause():
            self._eager_forward(*args)

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            return self._eager_forward(x, *args)
        from .. import symbol as sym_mod

        if isinstance(x, sym_mod.Symbol):
            # the symbolic trace: parameters enter as variables, a
            # 'null' one as an auxiliary state; children trace through
            # the same dispatch
            params = {name: p.var() for name, p in self._reg_params.items()}
            for name, p in self._reg_params.items():
                if p.grad_req == "null":
                    params[name]._outputs[0][0]._forced_aux = True
            return self.hybrid_forward(sym_mod, x, *args, **params)
        raise MXNetError("HybridBlock requires NDArray or Symbol inputs, "
                         "got %s" % type(x).__name__)

    def export(self, path, epoch=0):
        """Write the block's symbolic trace to ``<path>-symbol.json`` and
        its parameters to ``<path>-%04d.params`` (``epoch``), each under
        ``arg:`` or ``aux:`` as the graph lists it
        (``mxnet_tpu/gluon/block.py:665-679``). An uninitialized
        parameter raises."""
        from ..ndarray import io_utils

        sym = self._as_symbol()
        sym.save("%s-symbol.json" % path)
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for name, param in self.collect_params().items():
            if name in aux_names:
                arg_dict["aux:%s" % name] = param.data()
            elif name in arg_names:
                arg_dict["arg:%s" % name] = param.data()
        io_utils.save("%s-%04d.params" % (path, epoch), arg_dict)

    def _as_symbol(self):
        """The block's graph: a trace from one input variable ``data``
        (several outputs grouped)."""
        from .. import symbol as sym_mod

        out = self(sym_mod.var("data"))
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        return out

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A block that runs a Symbol's graph (``mxnet_tpu/gluon/block.py:
    697-749``): ``outputs`` over the variables ``inputs``; every other
    argument and auxiliary state becomes a parameter named as in the
    graph (empty prefix), its shape taken from what is loaded into it.
    Used to import an exported model (:meth:`imports`)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=None)
        self._prefix = ""
        self._params = ParameterDict("", params)
        from .. import symbol as sym_mod

        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        self._cached_graph_sym = outputs
        self._in_names = [i.name for i in inputs]
        for name in outputs.list_arguments():
            if name not in self._in_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self.params.get(name, allow_deferred_init=True, grad_req="null")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file``'s graph over ``input_names``,
        with the values of ``param_file`` (``arg:``/``aux:`` tags dropped;
        every parameter must be there) on ``ctx``: the current context by
        default, the card unless a ``with mx.cpu():`` scope asks for the
        host."""
        from .. import symbol as sym_mod

        sym = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [sym_mod.var(i) for i in input_names])
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx,
                                      allow_missing=False,
                                      ignore_extra=True)
        return ret

    def forward(self, x, *args):
        arg_dict = {self._in_names[0]: x}
        arg_dict.update(zip(self._in_names[1:], args))
        for pname, p in self.collect_params().items():
            arg_dict[pname] = p.data(x.context)
        return self._cached_graph_sym.eval_nd(arg_dict)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
