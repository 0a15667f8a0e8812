"""SequentialModule: a chain of modules, each fed the outputs of the one
before, the port of ``mxnet_tpu/module/sequential_module.py`` (reference
``python/mxnet/module/sequential_module.py``).

``add(module, take_labels=, auto_wiring=)`` appends a module: with
``take_labels`` it is bound with the labels and scores the metric, with
``auto_wiring`` its data names replace the previous module's output
names. ``forward`` runs the chain, ``backward`` runs it in reverse, each
module's input gradients seeding the one before (every module after the
first is bound with ``inputs_need_grad``), and ``update`` steps each
module's own optimizer.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append ``module`` (reference sequential_module.py:add); returns
        self, so calls chain."""
        unknown = set(kwargs) - self._meta_keys
        if unknown:
            raise MXNetError("Unknown meta %s, a typo?" % sorted(unknown))
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        self._require("binded")
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        self._require("binded")
        return self._label_shapes

    @property
    def output_shapes(self):
        self._require("binded")
        return self._modules[-1].output_shapes

    def get_params(self):
        self._require("binded", "params_initialized")
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Initialize every module's parameters; a name used by two
        modules raises."""
        if self.params_initialized and not force_init:
            return
        self._require("binded")
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init, allow_extra=allow_extra)
        seen_arg, seen_aux = {}, {}
        for i, module in enumerate(self._modules):
            arg, aux = module.get_params()
            for seen, names in ((seen_arg, arg), (seen_aux, aux)):
                for name in names:
                    if name in seen:
                        raise MXNetError(
                            "Duplicated parameter names: name \"%s\" in "
                            "layer %d (%s) is already used in layer %d (%s)."
                            % (name, i, type(module), seen[name],
                               type(self._modules[seen[name]])))
                    seen[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind each module on the previous one's output shapes."""
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad needs for_training")
        if shared_module is not None:
            raise MXNetError("Shared module is not supported")
        if not self._modules:
            raise MXNetError("Attempting to bind an empty SequentialModule")
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        self._data_shapes = data_shapes
        my_data_shapes = data_shapes
        anybody_needs_label = False
        for i, module in enumerate(self._modules):
            meta = self._metas[i]
            if meta.get(self.META_TAKE_LABELS):
                my_label_shapes = label_shapes
                anybody_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = bool(for_training and (
                inputs_need_grad or i > 0))
            if meta.get(self.META_AUTO_WIRING, False):
                data_names = module.data_names
                if len(data_names) != len(my_data_shapes):
                    raise MXNetError(
                        "auto_wiring: module %d takes %d inputs, the one "
                        "before gives %d" % (i, len(data_names),
                                             len(my_data_shapes)))
                my_data_shapes = [(new, shape) for new, (_, shape)
                                  in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            my_data_shapes = module.output_shapes
        if not anybody_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require("binded", "params_initialized")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._require("binded", "params_initialized")
        batch = _CopyBatch(data_batch)
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            batch.data = module.get_outputs()

    def backward(self, out_grads=None):
        self._require("binded", "params_initialized")
        for i in reversed(range(len(self._modules))):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        self._require("binded", "params_initialized",
                      "optimizer_initialized")
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        self._require("binded", "params_initialized")
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require("binded", "params_initialized")
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._require("binded", "params_initialized")
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        self._require("binded")
        for module in self._modules:
            module.install_monitor(mon)


class _CopyBatch(object):
    """A batch whose ``data`` the chain replaces module by module."""

    def __init__(self, batch):
        self.data = batch.data
        self.label = getattr(batch, "label", None)
        self.pad = getattr(batch, "pad", 0)
        self.index = getattr(batch, "index", None)
