"""Gluon Trainer: the port of ``mxnet_tpu/gluon/trainer.py`` for one
context.

``step`` = ``allreduce_grads`` (a no-op on one context, as in the JAX
package) + ``update``: one fused apply over every parameter
(``fastpath.apply_updater``, ``trainer.py:212-224``), or with
``MXNET_FASTPATH=0`` the per-parameter loop over the updater
(``trainer.py:227-234``), both under the fresh-gradient contract
(``trainer.py:189-206``): a gradient no backward has renewed since the
last step raises unless ``ignore_stale_grad``, which then skips that
parameter. Parameters on more than one context, or a kvstore, raise "not
ported yet".

``save_states``/``load_states`` (``trainer.py:236-259``) write and read
the updater's states with the optimizer: numpy arrays and plain Python
(``Updater.get_states``), copied back into the live state tensors where
they have the shape, with the optimizer's counters and schedule. The
file names the optimizer's class by its module path, so a Trainer's
states file loads in the package that wrote it only.
"""
from __future__ import annotations

from .. import fastpath, optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer(object):
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % (type(params),))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s."
                                 % (type(param),))
            self._params.append(param)
        if kvstore not in ("device", "local", None) or update_on_kvstore \
                or compression_params:
            raise MXNetError("kvstore %r is not ported yet: the port trains "
                             "on one context" % (kvstore,))
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError(
                    "All Parameters must be initialized on the same set of "
                    "contexts, but Parameter %s is initialized on %s while "
                    "previous Parameters are initialized on %s."
                    % (param.name, ctx, contexts))
            contexts = ctx
        if contexts is not None and len(contexts) > 1:
            raise MXNetError("training on %d contexts is not ported yet (the "
                             "port trains on one)" % len(contexts))
        return contexts

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def save_states(self, fname):
        """Save the updater's states and the optimizer to ``fname``."""
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load ``save_states``'s file: the states into the live state
        tensors (new ones on the parameters' context where there are
        none), and its optimizer, with this Trainer's parameters as its
        ``param_dict``."""
        with open(fname, "rb") as f:
            states = f.read()
        device = self._contexts[0].torch_device() if self._contexts \
            else None
        self._updater.set_states(states, device=device)
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce (nothing to reduce on one context) + update."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce gradients across contexts: one context, nothing to do."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Apply the optimizer to every parameter with a fresh gradient."""
        self._optimizer.rescale_grad = self._scale / batch_size
        rows = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            arr = param.data()
            if not getattr(arr, "_fresh_grad", True):
                if ignore_stale_grad:
                    continue
                raise UserWarning(
                    "Gradient of Parameter `%s` on context %s has not been "
                    "updated by backward since last `step`. This could mean "
                    "a bug in your model that made it only use a subset of "
                    "the Parameters for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning and "
                    "skip updating of Parameters with stale gradient"
                    % (param.name, arr.context))
            rows.append((i, param.grad(), arr))
        for _i, _grad, arr in rows:
            arr._fresh_grad = False
        if fastpath.enabled() and fastpath.supports(self._optimizer):
            fastpath.apply_updater(self._updater, rows)
            return
        for i, grad, arr in rows:
            self._updater(i, grad, arr)
