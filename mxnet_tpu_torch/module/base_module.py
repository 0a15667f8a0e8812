"""BaseModule: the high-level train/predict interface, the port of
``mxnet_tpu/module/base_module.py``.

``forward_backward`` and ``set_params`` are here. ``fit``, ``score``,
``predict`` and the checkpoint helpers need ``metric.py`` and the
``.params`` format, which are not ported yet: they raise.
"""
from __future__ import annotations

import logging

from ..base import MXNetError

__all__ = ["BaseModule"]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in [n for n in names if n not in args]:
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). "
               "Did you mean one of:\n\t%s"
               % (typename, str(names), name, "\n\t".join(args)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule(object):
    """Abstract module (reference base_module.py:BaseModule)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    def forward_backward(self, data_batch):
        """forward + backward in one call (reference base_module.py:193)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    @property
    def symbol(self):
        return self._symbol

    def _not_ported(self, what):
        raise MXNetError("Module.%s is not ported yet (it needs metric.py "
                         "or the .params format)" % what)

    def fit(self, *args, **kwargs):
        self._not_ported("fit")

    def score(self, *args, **kwargs):
        self._not_ported("score")

    def predict(self, *args, **kwargs):
        self._not_ported("predict")

    def save_params(self, fname):
        self._not_ported("save_params")

    def load_params(self, fname):
        self._not_ported("load_params")
