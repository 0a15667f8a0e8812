"""BucketingModule: variable-length inputs through one executor a bucket,
the port of ``mxnet_tpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py:36``).

``sym_gen(bucket_key)`` gives each bucket's ``(symbol, data_names,
label_names)``; each bucket is a :class:`Module` bound over the default
bucket's module (``bind(shared_module=)``), so every bucket's executor
holds the default bucket's parameter, gradient and auxiliary NDArrays
themselves, and the buckets share one optimizer, updater and kvstore. A
switch (``switch_bucket``, ``prepare``, ``forward``) hands the current
parameters to the other bucket through ``set_params``, which copies
nothing between shared arrays. Each bucket's optimizer index of a
parameter must be the default bucket's: the updater keys its states by
index.

One departure: with no ``context`` the module runs on the current
context (the card), as the port's ``Module`` does; the JAX one defaults
to ``cpu()``. ``BaseModule.fit`` steps a bucketing module eagerly
(``trainplane.module_plane`` takes a ``Module`` only), as in the JAX
package. ``group2ctxs`` is not ported yet and raises.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..context import Context, current_context
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule: default_bucket_key is "
                             "required")
        if group2ctxs:
            raise MXNetError("BucketingModule: group2ctxs is not ported yet")
        if context is None:
            context = current_context()
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = [context] if isinstance(context, Context) \
            else list(context)
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._require("binded")
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._require("binded")
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._require("binded")
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._require("binded")
        return self._curr_module.symbol

    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names,
                      compression_params=self._compression_params)

    # -- parameters -------------------------------------------------------
    def get_params(self):
        self._require("params_initialized")
        if self._params_dirty:
            self._sync_params_from_curr()
        return self._curr_module.get_params()

    def _sync_params_from_curr(self):
        arg_params, aux_params = self._curr_module.get_params()
        for mod in self._buckets.values():
            if mod is not self._curr_module and mod.params_initialized:
                mod.set_params(arg_params, aux_params)
        self._params_dirty = False

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._require("binded")
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module (reference
        bucketing_module.py:bind)."""
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None,
                    grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module the current one, binding it over
        the default bucket's arrays the first time (reference
        bucketing_module.py:switch_bucket)."""
        self._require("binded")
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default,
                        grad_req=self._grad_req)
            _check_param_order(default, module, bucket_key)
            if self.params_initialized:
                arg_params, aux_params = self.get_params()
                module.init_params(arg_params=arg_params,
                                   aux_params=aux_params)
                self._share_optimizer(module)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        else:
            module = self._buckets[bucket_key]
            if self.params_initialized and self._params_dirty:
                module.set_params(*self._curr_module.get_params())
        self._curr_module = module
        self._curr_bucket_key = bucket_key

    def _share_optimizer(self, module):
        curr = self._curr_module
        module._optimizer = curr._optimizer
        module._kvstore = curr._kvstore
        module._update_on_kvstore = curr._update_on_kvstore
        module._updater = curr._updater
        module.optimizer_initialized = curr.optimizer_initialized

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require("binded", "params_initialized")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module and mod.binded:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    # -- computation ------------------------------------------------------
    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Switch to the batch's bucket (``fit`` calls this first)."""
        self._require("binded", "params_initialized")
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)

    def forward(self, data_batch, is_train=None):
        self._require("binded", "params_initialized")
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._require("binded", "params_initialized")
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._require("binded", "params_initialized",
                      "optimizer_initialized")
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        self._require("binded", "params_initialized")
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require("binded", "params_initialized")
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._require("binded", "params_initialized")
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        self._require("binded")
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)


def _check_param_order(default, module, bucket_key):
    """The shared updater keys its states by a parameter's index in the
    module's ordered parameters: each name a bucket shares must sit at
    the default bucket's index."""
    want = {n: i for i, n in enumerate(default._ordered_param_names())}
    for i, name in enumerate(module._ordered_param_names()):
        if want.get(name, i) != i:
            raise MXNetError(
                "BucketingModule: bucket %r puts parameter %r at index %d, "
                "the default bucket at %d; the shared optimizer states are "
                "kept by index" % (bucket_key, name, i, want[name]))
