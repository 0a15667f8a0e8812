"""Model helpers: the port of ``mxnet_tpu/model.py``'s
``_create_kvstore``, the checkpoint functions and the legacy
``FeedForward``.

With one device and a kvstore name without ``dist`` there is no kvstore,
and the module updates its parameters itself (``mxnet_tpu/model.py:
25-45``). Every other case needs the kvstore, which is not ported yet,
and raises.

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

from .base import MXNetError
from .ndarray import io_utils

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward"]


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: ``(None, False)`` for one device
    without a distributed store."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return None, False
    raise MXNetError("kvstore %r over %d devices is not ported yet"
                     % (kvstore, num_device))


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
