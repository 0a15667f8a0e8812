"""BaseModule: the high-level train/predict interface, the port of
``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``: fit :409, score, predict,
forward_backward).

``fit`` is the JAX package's epoch loop: it asks
``trainplane.module_plane`` once for the whole training step as one
captured graph and steps every batch through it; where the plane
declines (its reasons are counted in ``trainplane.FALLBACKS``: a
``KVStore`` object demotes as ``module-config``), each batch runs
``forward_backward`` and ``update``. A ``monitor=`` is installed on the
executor and forces the eager pair (its ``tic``/``toc_print`` bracket
every batch), as in the JAX package. ``save_params``/``load_params``
write and read the ``.params`` container with ``arg:``/``aux:`` names
(``mxnet_tpu/module/base_module.py:272-290``).
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..initializer import Uniform

__all__ = ["BaseModule"]


class _BatchEndParam(object):
    """Callback payload: epoch / nbatch / eval_metric / locals (reference
    BatchEndParam namedtuple contract)."""

    def __init__(self, epoch, nbatch, eval_metric, locals_):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals_


def _fire(callbacks, *args):
    """Invoke one callback or a list of them."""
    if callbacks is None:
        return
    cbs = callbacks if isinstance(callbacks, (list, tuple)) else [callbacks]
    for cb in cbs:
        cb(*args)


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _limited(data_iter, num_batch):
    """Yield (nbatch, batch) pairs, stopping after num_batch if given."""
    for nbatch, batch in enumerate(data_iter):
        if num_batch is not None and nbatch >= num_batch:
            return
        yield nbatch, batch


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

    def _require(self, *what):
        """Raise unless each state named (``binded``,
        ``params_initialized``, ``optimizer_initialized``) is set."""
        for w in what:
            if not getattr(self, w):
                raise MXNetError("%s: call %s first" % (
                    type(self).__name__,
                    {"binded": "bind()", "params_initialized": "init_params()",
                     "optimizer_initialized": "init_optimizer()"}[w]))

    # -- the abstract surface (reference base_module.py), as the JAX
    # package's: a concrete module implements each ----------------------
    @property
    def data_names(self):
        raise NotImplementedError("implemented by the concrete Module")

    @property
    def output_names(self):
        raise NotImplementedError("implemented by the concrete Module")

    @property
    def data_shapes(self):
        raise NotImplementedError("implemented by the concrete Module")

    @property
    def label_shapes(self):
        raise NotImplementedError("implemented by the concrete Module")

    @property
    def output_shapes(self):
        raise NotImplementedError("implemented by the concrete Module")

    def get_params(self):
        raise NotImplementedError("implemented by the concrete Module")

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError("implemented by the concrete Module")

    def install_monitor(self, mon):
        raise NotImplementedError("implemented by the concrete Module")

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError("implemented by the concrete Module")

    def backward(self, out_grads=None):
        raise NotImplementedError("implemented by the concrete Module")

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError("implemented by the concrete Module")

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError("implemented by the concrete Module")

    def update(self):
        raise NotImplementedError("implemented by the concrete Module")

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError("implemented by the concrete Module")

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError("implemented by the concrete Module")

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError("implemented by the concrete Module")

    def forward_backward(self, data_batch):
        """forward + backward in one call (reference base_module.py:193)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Get ready for ``data_batch`` before its forward (``fit`` calls
        it each batch): nothing here; ``BucketingModule`` switches to the
        batch's bucket."""

    def get_states(self, merge_multi_context=True):
        """The module's state arrays: none, as in the JAX package
        (``mxnet_tpu/module/base_module.py:294-297``)."""
        self._require("binded", "params_initialized")
        if merge_multi_context:
            raise MXNetError("get_states: merge_multi_context is not "
                             "supported")
        return []

    def set_states(self, states=None, value=None):
        """Set the state arrays: there are none to set
        (``mxnet_tpu/module/base_module.py:299-301``)."""
        self._require("binded", "params_initialized")
        if states or value:
            raise MXNetError("set_states: the module has no states")

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate on a data iterator (reference base_module.py:score)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("score: bind() and init_params() first")
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        seen = 0
        for nbatch, batch in _limited(eval_data, num_batch):
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback,
                  _BatchEndParam(epoch, nbatch, eval_metric, locals()))
            seen = nbatch + 1
        _fire(score_end_callback,
              _BatchEndParam(epoch, seen, eval_metric, locals()))
        return eval_metric.get_name_value()

    def _unpadded_outputs(self, batch):
        """Forwarded outputs with the batch's tail padding sliced off."""
        keep = slice(None) if not batch.pad else slice(0, -batch.pad)
        return [out[keep] for out in self.get_outputs()]

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        if not (self.binded and self.params_initialized):
            raise MXNetError("iter_predict: bind() and init_params() first")
        if reset:
            eval_data.reset()
        for nbatch, batch in _limited(eval_data, num_batch):
            self.forward(batch, is_train=False)
            yield (self._unpadded_outputs(batch), nbatch, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Run prediction, collecting outputs (reference
        base_module.py:predict)."""
        from ..ndarray import ndarray as nd_mod

        per_batch = [[o.copy() for o in outs] for outs, _, _
                     in self.iter_predict(eval_data, num_batch, reset)]
        if not per_batch:
            return []
        if not merge_batches:
            return per_batch
        width = len(per_batch[0])
        if any(len(outs) != width for outs in per_batch):
            raise ValueError(
                "Cannot merge batches: output arity varies across "
                "mini-batches. Maybe bucketing is used?")
        merged = [nd_mod.invoke("Concat", *[outs[i] for outs in per_batch],
                                dim=0, num_args=len(per_batch))
                  for i in range(width)]
        if width == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Train the module (reference base_module.py:409): bind, init
        params and optimizer, then per epoch one step of the graph plane
        (``trainplane.module_plane``) or ``forward_backward`` + ``update``,
        and ``update_metric``, on every batch, the callbacks, and
        ``score`` on ``eval_data``."""
        if num_epoch is None:
            raise MXNetError("fit: please specify number of epochs")

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        eval_metric = _as_metric(eval_metric)
        validation_metric = validation_metric or eval_metric

        # the training plane (mxnet_tpu/module/base_module.py:168-189): one
        # captured forward + backward + update a batch where the module
        # allows it, else the eager pair below; a monitor needs the
        # executor's forward, so it forces the eager pair
        plane = None
        if monitor is None:
            from .. import trainplane

            plane = trainplane.module_plane(self)

        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            eval_metric.reset()
            nbatch = -1
            epoch_vals = []
            for nbatch, batch in enumerate(train_data):
                self.prepare(batch, sparse_row_id_fn=sparse_row_id_fn)
                if monitor is not None:
                    monitor.tic()
                if plane is not None:
                    plane.step(batch)
                else:
                    self.forward_backward(batch)
                    self.update()
                self.update_metric(eval_metric, batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    # snapshot BEFORE callbacks: an auto-resetting
                    # Speedometer on the final batch would otherwise leave
                    # the epoch summary reading an empty (nan) metric
                    epoch_vals = eval_metric.get_name_value()
                    _fire(batch_end_callback,
                          _BatchEndParam(epoch, nbatch, eval_metric,
                                         locals()))
            if nbatch < 0:
                raise ValueError("train_data produced no batches")
            if batch_end_callback is None:
                epoch_vals = eval_metric.get_name_value()

            for name, val in epoch_vals:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f",
                             epoch, time.time() - started)

            arg_now, aux_now = self.get_params()
            _fire(epoch_end_callback, epoch, self.symbol, arg_now, aux_now)

            if eval_data is not None:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)

            train_data.reset()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    @property
    def symbol(self):
        return self._symbol

    def save_params(self, fname):
        """Save the parameters and auxiliary states as ``arg:<name>`` and
        ``aux:<name>``."""
        from .. import model

        model._save_params(fname, *self.get_params())

    def load_params(self, fname):
        """Load a ``save_params`` file through ``set_params``."""
        from .. import model

        self.set_params(*model._load_params(fname))
