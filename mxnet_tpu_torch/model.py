"""Model helpers: the port of ``mxnet_tpu/model.py``'s
``_create_kvstore``, the checkpoint functions, ``BatchEndParam`` and the
legacy ``FeedForward``.

:func:`_create_kvstore` is the JAX package's rule
(``mxnet_tpu/model.py:25-45``): one device and a kvstore name without
``dist`` mean no kvstore, and the module updates its parameters itself;
a ``KVStore`` object (what ``common/fit.py`` passes) is used as it is,
with ``update_on_kvstore`` (the store's updater applies the optimizer),
unless a ``local`` store is made by name for a parameter above 16 M
elements. :func:`_update_params_on_kvstore` and :func:`_update_params`
are the two exchanges (``mxnet_tpu/model.py:48-110``).

:func:`save_checkpoint` writes ``prefix-symbol.json`` and
``prefix-NNNN.params`` (``arg:``/``aux:`` names) and
:func:`load_checkpoint` reads them back, as ``mx.save_checkpoint`` and
``mx.load_checkpoint`` too. :class:`FeedForward` is the pre-Module API as
a shim over ``Module`` (``mxnet_tpu/model.py:149-226``): ``fit`` rides
``Module.fit``, and so the module plane. Its context defaults to the
current one, the card, where the JAX package's defaults to the host.
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import optimizer as opt_mod
from .ndarray import io_utils

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

#: what a batch-end callback receives (reference model.py), as in the JAX
#: package
BatchEndParam = namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)`` (reference
    model.py:_create_kvstore)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            from . import kvstore as kvs_mod

            kv = kvs_mod.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(param.shape))
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        kv = kvstore
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """push(grad), the store's update, pull(weight) for every parameter
    with a gradient (reference model.py:145-155): one
    ``pushpull_update_multi`` where the store allows it (fastpath on, an
    updater, no compression), else the per-key pair."""
    from . import fastpath

    entries = [(index, arg_list, grad_list) for index, (arg_list, grad_list)
               in enumerate(zip(param_arrays, grad_arrays))
               if grad_list[0] is not None]
    if (fastpath.enabled() and getattr(kvstore, "_updater", None) is not None
            and getattr(kvstore, "_compression", None) is None):
        kvstore.pushpull_update_multi([i for i, _, _ in entries],
                                      [g for _, _, g in entries],
                                      [a for _, a, _ in entries])
        return
    for index, arg_list, grad_list in entries:
        kvstore.push(index, grad_list, priority=-index)
        kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The kvstore's reduce (if any), then the updater (reference
    model.py:_update_params): the exchange as one ``pushpull_multi``
    where the store allows it, and the update as one fused apply per
    device position where ``fastpath`` takes the optimizer."""
    from . import fastpath

    entries = [(i, arg_list, grad_list) for i, (arg_list, grad_list)
               in enumerate(zip(param_arrays, grad_arrays))
               if grad_list[0] is not None]
    if kvstore:
        if kvstore._can_fuse_pushpull():
            grad_lists = [g for _, _, g in entries]
            kvstore.pushpull_multi([i for i, _, _ in entries],
                                   grad_lists, grad_lists)
        else:
            for index, _, grad_list in entries:
                kvstore.push(index, grad_list, priority=-index)
                kvstore.pull(index, grad_list, priority=-index)
    n_pos = max((len(a) for _, a, _ in entries), default=1)
    if (fastpath.enabled() and isinstance(updater, opt_mod.Updater)
            and fastpath.supports(updater.optimizer, n_positions=n_pos)):
        by_pos = {}
        for index, arg_list, grad_list in entries:
            for k, (w, g) in enumerate(zip(arg_list, grad_list)):
                by_pos.setdefault(k, []).append(
                    (index * num_device + k, g, w))
        for k in sorted(by_pos):
            fastpath.apply_updater(updater, by_pos[k],
                                   positions=len(by_pos))
        return
    for index, arg_list, grad_list in entries:
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


def _save_params(fname, arg_params, aux_params):
    """Write ``arg_params``/``aux_params`` to a ``.params`` file as
    ``arg:<name>`` and ``aux:<name>``."""
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    io_utils.save(fname, save_dict)


def _load_params(fname):
    """``(arg_params, aux_params)`` of an ``arg:``/``aux:`` ``.params``
    file, on the current context; any other name is refused."""
    arg_params, aux_params = {}, {}
    for key, value in io_utils.load(fname).items():
        kind, _, name = key.partition(":")
        if kind == "arg":
            arg_params[name] = value
        elif kind == "aux":
            aux_params[name] = value
        else:
            raise ValueError("Invalid param file " + fname)
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Save the symbol JSON and the parameters (reference model.py:383)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    param_name = "%s-%04d.params" % (prefix, epoch)
    _save_params(param_name, arg_params, aux_params)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint (reference
    model.py:413), the arrays on the current context. A name that is
    neither ``arg:`` nor ``aux:`` is refused, as ``Module.load_params``
    refuses it, where the JAX function skips it."""
    from . import symbol as sym_mod

    symbol = sym_mod.load("%s-symbol.json" % prefix)
    return (symbol,) + _load_params("%s-%04d.params" % (prefix, epoch))


class FeedForward(object):
    """Legacy pre-Module API (reference model.py:FeedForward) as a thin
    shim over Module."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .context import current_context
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = ctx or [current_context()]
        if not isinstance(self.ctx, list):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    def _init_module(self, data):
        from .module import Module

        data_names = [x[0] for x in data.provide_data]
        label_names = [x[0] for x in (data.provide_label or [])]
        return Module(self.symbol, data_names=data_names,
                      label_names=label_names or None, context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train through ``Module.fit`` (so on the module plane where the
        module allows it); keeps the trained parameters."""
        self._module = self._init_module(X)
        self._module.fit(
            X, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer,
            optimizer_params=self.kwargs or (("learning_rate", 0.01),),
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params, num_epoch=self.num_epoch,
            begin_epoch=self.begin_epoch, monitor=monitor,
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy (a list of NDArrays for several
        outputs)."""
        if self._module is None:
            self._module = self._init_module(X)
            self._module.bind(data_shapes=X.provide_data, for_training=False)
            self._module.init_params(arg_params=self.arg_params,
                                     aux_params=self.aux_params)
        outputs = self._module.predict(X, num_batch=num_batch, reset=reset)
        return outputs.asnumpy() if hasattr(outputs, "asnumpy") else outputs
