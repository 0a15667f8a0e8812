"""Gluon Parameter / ParameterDict: the port of
``mxnet_tpu/gluon/parameter.py``.

A parameter owns one NDArray per context (one context is what the port
runs: more raise in ``Trainer``) and its gradient buffer. Shapes with an
unknown (0) dimension defer initialization to the first forward, which
fills them in call order; since every weight is drawn from the one host
stream ``random.np_rng()``, that order fixes the values, and it is the
JAX package's order.

``Parameter.var()`` is the parameter's Symbol variable (a block's
symbolic trace, ``HybridBlock.export``); ``Constant`` is a parameter of
fixed value without a gradient. ``reset_ctx`` moves a parameter to
another context: see its docstring for what that does to a captured
plane.

``ParameterDict.save``/``load`` write and read the ``.params`` container
(``nd.save``/``nd.load``). A loaded value is copied into the parameter's
own tensor, cast to its dtype (``Parameter._load_init``), so a captured
step that holds the tensor's address replays with it; the JAX package
rebinds and takes the file's dtype. A ``.params`` file holds no bfloat16,
and the copy is what lets a bfloat16 net take a float32 file back in
place.
"""
from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd, initializer as init_mod
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, cpu, current_context
from ..ndarray import ndarray as nd_mod
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization."""


class Parameter(object):
    """A Block parameter, with deferred initialization when the shape
    holds unknown (0) dimensions resolved at the first forward."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._data = None  # OrderedDict ctx -> NDArray
        self._grad = None
        self._ctx_list = None
        self._deferred_init = ()
        self._var = None
        self.name = name
        self._differentiable = differentiable
        if not differentiable:
            grad_req = "null"
        self._allow_deferred_init = allow_deferred_init
        self._grad_req = None
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        self.init = init
        if stype not in ("default", "row_sparse", "csr"):
            raise MXNetError("invalid stype %r" % (stype,))
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def stype(self):
        """The storage the parameter declares (its value is dense, as in
        the JAX package)."""
        return self._stype

    @property
    def grad_stype(self):
        return self._grad_stype

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add, or null, got %r"
                             % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null" and self._grad is not None:
            self._grad = None
            for d in (self._data or {}).values():
                d._marked = False
                d._leaf = None
                d._grad = None
                d._data = d._data.detach()
        elif self._data is not None:
            self._init_grad()

    # -- init machinery ---------------------------------------------------
    def _check_and_get(self, arr_dict, ctx):
        if arr_dict is not None:
            if ctx is list:
                return list(arr_dict.values())
            if ctx is None or len(arr_dict) == 1:
                return list(arr_dict.values())[0]
            if ctx in arr_dict:
                return arr_dict[ctx]
            raise MXNetError("Parameter '%s' was not initialized on context "
                             "%s." % (self.name, ctx))
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise MXNetError(
            "Parameter '%s' has not been initialized. You should initialize "
            "parameters with Block.collect_params().initialize()."
            % self.name)

    def _load_init(self, data, ctx):
        """Initialize from loaded data (``mxnet_tpu/gluon/parameter.py:
        123-150``): the rank and shape checks, unknown (0) dims taken from
        the data. A parameter with a value takes the data in place (copied
        into each context's tensor under ``no_grad``, cast to its dtype);
        one without (deferred or never initialized) is initialized from
        it."""
        if self.shape:
            if len(self.shape) != len(data.shape):
                raise MXNetError(
                    "Failed loading Parameter '%s' from saved params: "
                    "rank mismatch expected %s vs saved %s"
                    % (self.name, str(self.shape), str(data.shape)))
            for self_dim, data_dim in zip(self.shape, data.shape):
                if self_dim != 0 and self_dim != data_dim:
                    raise MXNetError(
                        "Failed loading Parameter '%s' from saved params: "
                        "shape incompatible expected %s vs saved %s"
                        % (self.name, str(self.shape), str(data.shape)))
            self.shape = tuple(
                self_dim if self_dim != 0 else data_dim
                for self_dim, data_dim in zip(self.shape, data.shape))
        elif self.shape is None:  # a SymbolBlock's parameter: any shape
            self.shape = tuple(data.shape)
        if isinstance(ctx, Context):
            ctx = [ctx]
        src = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(np.asarray(data))
        if self._data is None:
            if not ctx:
                ctx = self._deferred_init[1] if self._deferred_init \
                    else [current_context()]
            self._init_impl(NDArray(src.to(torch_dtype(self.dtype))), ctx)
        else:
            with torch.no_grad():
                for arr in self._data.values():
                    arr._data.copy_(src)
        self._deferred_init = ()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if self.shape is None or np.prod(self.shape) <= 0:
            raise MXNetError("Cannot initialize Parameter '%s' because it has "
                             "invalid shape: %s." % (self.name, self.shape))
        with autograd.pause():
            if data is None:
                data = nd_mod.zeros(self.shape, dtype=self.dtype, ctx=cpu())
                # a parameter's own init overrides the suffix dispatch
                # through the InitDesc __init__ attr
                attrs = {}
                if init is not None:
                    init_obj = init_mod.create(init)
                    if hasattr(init_obj, "dumps"):
                        attrs["__init__"] = init_obj.dumps()
                    else:  # a plain callable
                        init_obj(init_mod.InitDesc(self.name), data)
                        self._init_impl(data, ctx)
                        return
                init_mod.create(default_init)(
                    init_mod.InitDesc(self.name, attrs), data)
            self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        self._ctx_list = list(ctx_list)
        self._data = OrderedDict()
        if not isinstance(data, NDArray):
            data = nd_mod.array(data, dtype=self.dtype, ctx=cpu())
        for ctx in self._ctx_list:
            self._data[ctx] = data.copyto(ctx)
        self._init_grad()

    def _init_grad(self):
        if self.grad_req == "null":
            self._grad = None
            return
        self._grad = OrderedDict()
        for ctx, d in self._data.items():
            d.attach_grad(grad_req=self.grad_req)
            self._grad[ctx] = d._grad

    # -- public API -------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize data and grad buffers on ``ctx`` (the current
        context by default: the card, unless a ``with mx.cpu():`` scope
        is active)."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = default_init if self.init is None else self.init
        if self.shape is None or any(s == 0 for s in self.shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, None)
                return
            raise MXNetError("Cannot initialize Parameter '%s' because it has "
                             "invalid shape: %s." % (self.name, self.shape))
        self._deferred_init = (init, ctx, default_init, None)
        self._finish_deferred_init()

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (a Context or a list of one or
        more; ``mxnet_tpu/gluon/parameter.py:222-234``). The value is kept
        and the gradient restarts at zero; a reset to the contexts it is
        on changes nothing. An initialized parameter keeps its NDArray
        objects, whose tensors are rebound to the new device; a deferred
        one records ``ctx`` for its initialization. A captured plane
        (``parallel.TrainStep``, ``trainplane.TrainPlane``, the module
        plane) made before a move holds the old tensors' addresses, so it
        goes on training those and no longer this parameter: make the
        plane after the move."""
        if isinstance(ctx, Context):
            ctx = [ctx]
        ctx = list(ctx)
        if self._data:
            if list(self._data) == ctx:
                return
            if len(ctx) != 1 or len(self._data) != 1:
                data = list(self._data.values())[0]
                self._init_impl(data.copyto(cpu()), ctx)
                return
            arr = list(self._data.values())[0]
            with autograd.pause(), torch.no_grad():
                arr._data = arr._data.detach().to(ctx[0].torch_device())
            self._data = OrderedDict([(ctx[0], arr)])
            self._ctx_list = ctx
            self._init_grad()
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)
        else:
            raise MXNetError("Cannot reset context for Parameter '%s' "
                             "because it has not been initialized."
                             % self.name)

    def set_data(self, data):
        """Set the value on every context (numpy or NDArray)."""
        self.shape = tuple(data.shape)
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("Parameter '%s' has not been initialized"
                                 % self.name)
            self._deferred_init = self._deferred_init[:3] + (data,)
            return
        if isinstance(data, NDArray):
            src = data._data
        elif np_dtype(self.dtype) is torch.bfloat16:
            # numpy has no bfloat16: a bfloat16 array (ml_dtypes, as the
            # JAX package's asnumpy gives) goes through float32 exactly
            src = torch.from_numpy(np.array(data, np.float32))
        else:
            src = torch.from_numpy(np.array(data, np.dtype(
                np_dtype(self.dtype))))
        for arr in self._data.values():
            with torch.no_grad():
                arr._data.copy_(src.to(arr._data.device))

    def data(self, ctx=None) -> NDArray:
        return self._check_and_get(self._data, ctx)

    def row_sparse_data(self, row_id):
        """The value for the rows ``row_id``: the dense value, as the JAX
        package gives it (``mxnet_tpu/gluon/parameter.py:247``)."""
        return self.data()

    def list_row_sparse_data(self, row_id):
        return self.list_data()

    def list_data(self):
        return self._check_and_get(self._data, list)

    def grad(self, ctx=None) -> NDArray:
        if self._data is not None and self._grad is None:
            raise MXNetError("Cannot get gradient array for Parameter '%s' "
                             "because grad_req='null'" % self.name)
        return self._check_and_get(self._grad, ctx)

    def list_grad(self):
        if self._data is not None and self._grad is None:
            raise MXNetError("Cannot get gradient array for Parameter '%s' "
                             "because grad_req='null'" % self.name)
        return self._check_and_get(self._grad, list)

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise MXNetError("Parameter '%s' has not been initialized"
                             % self.name)
        return self._ctx_list

    def zero_grad(self):
        if self._grad is None:
            return
        for g in self._grad.values():
            g._data = torch.zeros_like(g._data)

    def var(self):
        """The parameter's Symbol variable (made once), carrying its shape,
        dtype, learning-rate and weight-decay multipliers and initializer
        as attributes (``mxnet_tpu/gluon/parameter.py:289-297``)."""
        if self._var is None:
            from .. import symbol

            self._var = symbol.var(self.name, shape=self.shape,
                                   dtype=self.dtype, lr_mult=self.lr_mult,
                                   wd_mult=self.wd_mult, init=self.init)
        return self._var

    def cast(self, dtype):
        """Cast the data and the gradient to ``dtype``
        (``mxnet_tpu/gluon/parameter.py:299-308``); a parameter whose
        initialization is deferred takes ``dtype`` when it is made. The
        data is a new tensor: a captured step made before holds the old
        one, so a cast comes before the step's first call."""
        self.dtype = np_dtype(dtype)
        if self._data is None:
            return
        tdtype = torch_dtype(dtype)
        with autograd.pause(), torch.no_grad():
            for arr in self._data.values():
                arr._data = arr._data.detach().to(tdtype)
                if arr._marked:
                    nd_mod._make_leaf(arr, arr._grad_req)
            if self._grad is not None:
                for g in self._grad.values():
                    g._data = g._data.to(tdtype)


class Constant(Parameter):
    """A parameter of fixed value: ``grad_req='null'``, initialized from
    ``value`` (numpy, a list or an NDArray) by an initializer registered
    under a name of its own (``mxnet_tpu/gluon/parameter.py:311-337``)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd_mod.array(np.asarray(value, np.float32), ctx=cpu())
        self.value = value
        init_name = "constant_{}_{}".format(name, id(self)).lower()
        host = value.asnumpy()

        class _ConstantInit(init_mod.Initializer):
            def _init_weight(self, _, arr):
                init_mod.Initializer._set(arr, host)

            def dumps(self):
                return json.dumps([init_name, {}])

        init_mod._INIT_REGISTRY[init_name] = _ConstantInit
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=init_name)


class ParameterDict(object):
    """Prefix-scoped dict of Parameters with sharing."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        return "%s(\n%s\n)" % (self._prefix,
                               "\n".join(str(v) for v in self.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        """Get or create the Parameter ``self.prefix + name``."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if k == "shape" and v is not None and existing is not None \
                    and len(v) == len(existing) \
                    and all(a == b or a * b == 0 for a, b in zip(v, existing)):
                param.shape = tuple(a or b for a, b in zip(v, existing))
            elif v is not None and existing is not None and v != existing:
                raise MXNetError(
                    "Cannot retrieve Parameter '%s' because desired attribute "
                    "does not match with stored for attribute '%s': desired "
                    "'%s' vs stored '%s'." % (name, k, v, existing))
        return param

    def get_constant(self, name, value=None) -> Constant:
        """Get or create the Constant ``self.prefix + name``; a new one
        needs ``value``, and an existing one must equal ``value`` when it
        is given."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError(
                    "No constant named '{name}'. Please specify value if "
                    "you want to create a new constant.".format(name=name))
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None:
            want = value.asnumpy() if isinstance(value, NDArray) \
                else np.asarray(value, np.float32)
            if not np.array_equal(param.value.asnumpy(), want):
                raise MXNetError(
                    "Constant '{name}' already exists but it's not equal to "
                    "the requested value".format(name=name))
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise MXNetError(
                        "Cannot update self with other because they have "
                        "different Parameters with the same name '%s'" % k)
            else:
                self._params[k] = v

    def reset_ctx(self, ctx):
        """``Parameter.reset_ctx`` on every parameter."""
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of every
        parameter to ``value``."""
        for p in self.values():
            setattr(p, name, value)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def save(self, filename, strip_prefix=""):
        """Save every parameter to a ``.params`` file under its name less
        ``strip_prefix`` (``mxnet_tpu/gluon/parameter.py:484-499``)."""
        from ..ndarray import io_utils

        arg_dict = {}
        for param in self.values():
            if param._data is None:
                raise MXNetError("Parameter %s not initialized" % param.name)
            if not param.name.startswith(strip_prefix):
                raise MXNetError(
                    "Prefix '%s' is to be stripped before saving, but "
                    "Parameter's name '%s' does not start with it."
                    % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        io_utils.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a ``.params`` file, each name prefixed with
        ``restore_prefix`` (an ``arg:``/``aux:`` tag dropped), into the
        parameters of the same names (``mxnet_tpu/gluon/parameter.py:
        501-518``); a missing or extra name raises unless allowed."""
        from ..ndarray import io_utils

        if isinstance(ctx, Context):
            ctx = [ctx]
        arg_dict = io_utils.load(filename, ctx[0] if ctx else None)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter '%s' is missing in file "
                                     "'%s'" % (name, filename))
        for name in arg_dict:
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in ParameterDict" % (name, filename))
                continue
            self[name]._load_init(arg_dict[name], ctx)
