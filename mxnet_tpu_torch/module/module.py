"""Module: symbolic training over one Symbol, the port of
``mxnet_tpu/module/module.py`` (bind, init_params, init_optimizer,
forward/backward, update, get_outputs, get_params/set_params).

The card by default (``context=None`` is the current context, which
raises without a card unless a ``with mx.cpu():`` scope asks for the
host). A ``context`` list binds one executor a context, each on its
slice of the batch by ``work_load_list`` (``executor_group``), and
``group2ctxs`` places the ``ctx_group``s of each executor's graph
(``Symbol.simple_bind(group2ctx=)``). Over several contexts
``init_optimizer`` makes a ``local`` store by default (``update_on_kvstore``,
as ``model._create_kvstore`` decides): each update pushes every
executor's gradient, the store's updater steps its weight with their sum,
and the weight is pulled into every executor. Without a store each
executor's gradient updates its own copy, through the one updater, as
in the JAX ``Module`` (``mxnet_tpu/module/module.py:289-330``): that
updater's states are shared by the copies. Without a kvstore on one
context :meth:`Module.update` applies the
optimizer in place through the fused ``fastpath`` apply
(``MXNET_FASTPATH=0``: the per-parameter updater). With a ``KVStore``
object (``model._create_kvstore``: what ``common/fit.py`` passes) the
store holds a copy of every parameter and, under ``update_on_kvstore``,
the optimizer: each update pushes every gradient to the store, whose
updater steps its copy, and pulls the weight back into the executor's
tensor in place (``mxnet_tpu/module/module.py:270-287``); the optimizer
states are saved and loaded through the store. ``compression_params``
set the store's gradient compression. ``fit`` steps through
``trainplane.module_plane`` where the module allows it (not with a
kvstore).

Checkpoints (``mxnet_tpu/module/module.py:72-93, 346-363``):
``save_checkpoint`` writes ``prefix-symbol.json``, ``prefix-NNNN.params``
and, if asked, ``prefix-NNNN.states`` (the updater's states without the
optimizer, committed atomically); :meth:`Module.load` reads them back.
``set_params``, and so ``load_params``, copies into the executor's
tensors in place where a value has the bound shape and dtype
(``Executor.copy_params_from``), so a captured module plane replays with
it and makes no new capture; ``load_optimizer_states`` copies into the
live states.
``Module.load(..., load_optimizer_states=True)`` applies the states in
``init_optimizer``, as MXNet 1.3 does; the JAX package records the file
but never reads it.

``bind(shared_module=)`` binds over the shared module's parameter,
gradient and auxiliary arrays (``BucketingModule``'s buckets share the
default bucket's); ``init_params`` given an executor's own arrays (another
bucket's ``get_params``) takes them as they are, so a bucket switch copies
nothing. ``state_names`` are inputs the caller sets, not parameters.
:meth:`Module.reshape` binds anew for other input shapes with the trained
parameters.

:func:`params_from_jax` carries the JAX ``Module.get_params()`` into this
package, so both can compute the same thing.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import fastpath, optimizer as opt
from ..base import MXNetError
from ..context import Context, current_context
from ..executor import _same_memory
from ..initializer import InitDesc, Uniform
from ..ndarray import ndarray as nd_mod
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module", "params_from_jax"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        self._compression_params = compression_params
        self._context = list(context)
        self._work_load_list = work_load_list
        self._group2ctxs = group2ctxs
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)

        # the states are inputs the caller sets, not parameters
        # (mxnet_tpu/module/module.py:41-56)
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._grad_req = "write"

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._preload_opt_states = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix``'s checkpoint at ``epoch``: its symbol and
        parameters (on the current context), and with
        ``load_optimizer_states`` its ``.states`` file, applied by
        ``init_optimizer``."""
        from .. import model

        sym, args, auxs = model.load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Save ``prefix-symbol.json`` and ``prefix-NNNN.params`` (and
        with ``save_optimizer_states`` ``prefix-NNNN.states``)."""
        from .. import model

        model.save_checkpoint(prefix, epoch, self._symbol,
                              *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- properties -------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return list(zip(self._output_names, self._inferred_out_shapes))

    # -- parameters -------------------------------------------------------
    def get_params(self):
        """``(arg_params, aux_params)``: name -> NDArray on the context."""
        self._require("binded", "params_initialized")
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def _sync_params_from_devices(self):
        """Point the module's parameter dicts at the executors' current
        values (one context: no copy; several: their mean)."""
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Initialize the parameters (reference module.py:init_params):
        from ``arg_params``/``aux_params`` where given, else by the
        initializer, in sorted name order (the JAX package's draw order)."""
        if self.params_initialized and not force_init:
            return
        self._require("binded")
        if initializer is None:
            initializer = Uniform(0.01)
        ctx = self._context[0]
        if self._arg_params is None:
            self._arg_params = {n: nd_mod.zeros(s, ctx=ctx)
                                for n, s in self._param_shapes.items()}
        if self._aux_params is None:
            self._aux_params = {n: nd_mod.zeros(s, ctx=ctx)
                                for n, s in self._aux_shapes.items()}
        attrs = self._symbol.attr_dict()

        e = self._exec_group.execs[0]

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    src = cache[name]
                    data = src._data if isinstance(src, NDArray) \
                        else torch.as_tensor(np.asarray(src))
                    if tuple(data.shape) != tuple(arr.shape):
                        raise MXNetError("%s: shape %s given, %s expected"
                                         % (name, tuple(data.shape),
                                            arr.shape))
                    bound = e.arg_dict.get(name, e.aux_dict.get(name))
                    if bound is not None and _same_memory(data,
                                                          bound._data):
                        # the executor's own array (another bucket's
                        # get_params over shared arrays): nothing to copy
                        arr._data = bound._data
                        return
                    # a copy of its own, as the reference's set_params
                    # copies: the update and the moving statistics are
                    # written in place
                    arr._data = data.detach().to(
                        device=arr._data.device, dtype=arr._data.dtype,
                        copy=True)
                    return
                if not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Infer every shape and bind one executor (reference
        module.py:bind)."""
        from ..io import DataDesc

        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                       for x in data_shapes]
        if label_shapes is not None:
            label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                            for x in label_shapes]
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        shapes = dict(data_shapes)
        shapes.update(dict(label_shapes or []))
        arg_shapes, out_shapes, aux_shapes = self._symbol.infer_shape(
            **shapes)
        self._inferred_out_shapes = out_shapes
        self._param_shapes = {
            n: s for n, s in zip(self._symbol.list_arguments(), arg_shapes)
            if n in self._param_names}
        self._aux_shapes = dict(zip(self._aux_names, aux_shapes))
        shared_group = None
        if shared_module is not None:
            if not shared_module.binded:
                raise MXNetError("shared_module must be binded first")
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, data_shapes,
            label_shapes, self._param_names, for_training, inputs_need_grad,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            shared_group=shared_group, state_names=self._state_names,
            group2ctxs=self._group2ctxs)
        self.binded = True
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        """Bind again for new input shapes, keeping the parameters
        (``mxnet_tpu/module/module.py:370``): the trained values are
        read from the executor first, then copied into the new one."""
        self._require("binded")
        if self.params_initialized and self._params_dirty:
            self._sync_params_from_devices()
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True,
                  grad_req=self._grad_req)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Set up the optimizer and the kvstore (reference module.py:474,
        ``mxnet_tpu/module/module.py:223-262``): ``rescale_grad`` 1 /
        batch size unless given; with a store, every parameter is
        ``init``-ed into it, and under ``update_on_kvstore`` the store
        takes the optimizer and the module makes no updater."""
        from ..model import _create_kvstore

        self._require("binded", "params_initialized")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kv, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        names = self._ordered_param_names()
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._exec_group.batch_size)
            optimizer = opt.create(optimizer,
                                   param_idx2name=dict(enumerate(names)),
                                   **optimizer_params)
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kv:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            # the store takes a copy of the executor's current weights
            params = self._exec_group.execs[0].arg_dict
            for idx, name in enumerate(names):
                kv.init(idx, params[name])
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            # MXNet 1.3's init_optimizer applies Module.load's states
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def save_optimizer_states(self, fname):
        """Commit the updater's states (no optimizer) to ``fname``
        atomically under the ``ckpt.commit`` retry policy; under
        ``update_on_kvstore``, the store's."""
        from ..elastic import commit_bytes

        self._require("optimizer_initialized")
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        commit_bytes(fname, self._updater.get_states(), kind="states")

    def load_optimizer_states(self, fname):
        """Load ``save_optimizer_states``'s file (of either package) into
        the updater (the store's under ``update_on_kvstore``): in place
        into the live states, new ones on the module's context where
        there are none."""
        self._require("optimizer_initialized")
        with open(fname, "rb") as f:
            states = f.read()
        updater = self._kvstore._updater if self._update_on_kvstore \
            else self._updater
        updater.set_states(states, device=self._context[0].torch_device())
        if self._update_on_kvstore:
            self._optimizer = updater.optimizer

    def install_monitor(self, mon):
        """Hand ``mon`` the executor's outputs after each forward
        (``mxnet_tpu/module/module.py:366-368``)."""
        self._require("binded")
        self._exec_group.install_monitor(mon)

    # -- computation ------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require("binded", "params_initialized")
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._require("binded", "params_initialized")
        self._exec_group.backward(out_grads=out_grads)

    def _ordered_param_names(self):
        return [n for n in self._symbol.list_arguments()
                if n in self._param_names]

    def update(self):
        """One optimizer step on every parameter with a gradient, in
        place (reference module.py:644). Under ``update_on_kvstore``, per
        parameter a push of its gradient (the store's updater steps the
        store's weight) and a pull of the weight into the executor;
        with a store and a module-side updater, the store's reduce then
        the update; without a store, one fused apply, or with
        ``MXNET_FASTPATH=0`` the per-parameter loop."""
        self._require("binded", "params_initialized",
                      "optimizer_initialized")
        self._params_dirty = True
        execs = self._exec_group.execs
        names = self._ordered_param_names()
        if self._update_on_kvstore and self._kvstore:
            for idx, name in enumerate(names):
                grads = [e.grad_dict[name] for e in execs
                         if name in e.grad_dict]
                if not grads:
                    continue
                self._kvstore.push(idx, grads, priority=-idx)
                self._kvstore.pull(idx, [e.arg_dict[name] for e in execs],
                                   priority=-idx)
            return
        # (index, [(executor, gradient)] of the executors holding it)
        entries = [(idx, name, [(e, e.grad_dict[name]) for e in execs
                                if name in e.grad_dict])
                   for idx, name in enumerate(names)]
        entries = [en for en in entries if en[2]]
        if self._kvstore is not None:
            kv = self._kvstore
            grads = [[g for _, g in pairs] for _, _, pairs in entries]
            keys = [idx for idx, _, _ in entries]
            if kv._can_fuse_pushpull():
                kv.pushpull_multi(keys, grads, grads)
            else:
                for idx, g in zip(keys, grads):
                    kv.push(idx, g, priority=-idx)
                    kv.pull(idx, g, priority=-idx)
        n_pos = max((len(pairs) for _, _, pairs in entries), default=1)
        if fastpath.enabled() and isinstance(self._updater, opt.Updater) \
                and fastpath.supports(self._optimizer, n_positions=n_pos):
            # one fused apply an executor position over every parameter
            # (module.py:306-322)
            for k in range(n_pos):
                fastpath.apply_updater(
                    self._updater, [(idx, pairs[k][1],
                                     pairs[k][0].arg_dict[name])
                                    for idx, name, pairs in entries
                                    if k < len(pairs)], positions=n_pos)
            return
        for idx, name, pairs in entries:
            for e, g in pairs:
                self._updater(idx, g, e.arg_dict[name])

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """Feed the last forward's outputs and ``labels`` to the metric
        (reference module.py:update_metric)."""
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    def get_outputs(self, merge_multi_context=True):
        self._require("binded", "params_initialized")
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require("binded", "params_initialized")
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return self._exec_group.get_input_grads(merge_multi_context)


def params_from_jax(mod, arg_params, aux_params):
    """The JAX ``Module.get_params()`` pair (name -> NDArray or numpy) as
    this package's, for ``mod.set_params``: NDArrays on the bound port
    module ``mod``'s context under the same names (the names are explicit,
    ``conv1_weight``, ``cls_pred0_bias``, ...). Each name must be one of
    ``mod``'s parameters (auxiliary states) with the same shape, float32;
    a missing, extra or mismatched one raises."""
    mod._require("binded")
    dev = mod._context[0].torch_device()
    out = []
    for params, want in ((arg_params, mod._param_shapes),
                         (aux_params, mod._aux_shapes)):
        params = params or {}
        missing = sorted(set(want) - set(params))
        extra = sorted(set(params) - set(want))
        if missing or extra:
            raise MXNetError("params_from_jax: missing %s, extra %s"
                             % (missing, extra))
        conv = {}
        for name, value in params.items():
            host = np.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                              else value)
            if host.shape != tuple(want[name]) or host.dtype != np.float32:
                raise MXNetError("params_from_jax: %s is %s %s, the port "
                                 "expects float32 %s" % (
                                     name, host.dtype, host.shape,
                                     tuple(want[name])))
            conv[name] = NDArray(torch.from_numpy(np.array(host)).to(dev))
        out.append(conv)
    return tuple(out)
