"""Gluon Trainer: the port of ``mxnet_tpu/gluon/trainer.py``.

``step`` = ``allreduce_grads`` (a no-op on one context, as in the JAX
package) + ``update``: one fused apply over every parameter a context
(``fastpath.apply_updater``, ``trainer.py:212-224``), or with
``MXNET_FASTPATH=0`` the per-parameter loop over the updaters
(``trainer.py:227-234``), both under the fresh-gradient contract
(``trainer.py:189-206``): a gradient no backward has renewed since the
last step raises unless ``ignore_stale_grad``, which then skips that
parameter.

Several contexts in one process (``mxnet_tpu/gluon/trainer.py:47-105``,
``:146-177``): every parameter lives on the same contexts, the card and
the host or several ``cpu(i)``, with one updater a context (their states
on that context). The store reduces the contexts' gradients
(``pushpull_multi``: the copies summed in context order on the first
context's device, the sum copied back into every copy), so each
context's update takes the same gradient and its copy stays the
others'.

The kvstore is made at the first ``step`` (``_init_kvstore``,
``mxnet_tpu/gluon/trainer.py:80-108``): ``"device"``/``"local"`` on one
context mean no store, as in the JAX package, and a ``device``,
``local`` or ``tpu`` store over several; a ``KVStore`` object is
kept, takes a copy of every parameter and the ``compression_params``,
and with ``update_on_kvstore`` the optimizer: ``step`` then pushes each
gradient (the store's updater steps the store's weight) and pulls the
weight into the parameter in place. Without ``update_on_kvstore``,
``allreduce_grads`` pushes and pulls the gradients through the store
(one ``pushpull_multi`` where the store allows it) and ``update`` applies
the Trainer's own updater. A ``tpu``/``dist*`` store (one context a rank
of a job, ``kvstore.init_distributed``) sums every rank's gradients, one
collective a bucket; ``step``'s ``batch_size`` is then the job's batch.

``save_states``/``load_states`` (``trainer.py:236-259``) write and read
the updater's states with the optimizer: numpy arrays and plain Python
(``Updater.get_states``), copied back into the live state tensors where
they have the shape, with the optimizer's counters and schedule. The
file names the optimizer's class by its module path, so a Trainer's
states file loads in the package that wrote it only. Under ``MXNET_ZERO``
in a job, ``save_states`` materializes the sharded states first
(``fastpath.zero``: a collective, so every rank calls it), and
``load_states`` drops the plane; the next step shards again.
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
        if isinstance(kvstore, str) and kvstore not in ("device", "local"):
            from .. import kvstore as kvs_mod

            kvs_mod.create(kvstore)  # raises for an unknown name
        self._compression_params = compression_params
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
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
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts or [None]]

    @property
    def _updater(self):
        """The first context's updater (the one of a single context)."""
        return self._updaters[0]

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
        return contexts

    def _init_kvstore(self):
        """Make the kvstore (reference trainer.py:158): none for
        ``"device"``/``"local"`` on one context; a name or a ``KVStore``
        object otherwise, with every parameter ``init``-ed into it and,
        under ``update_on_kvstore``, the optimizer."""
        config = self._kvstore_params
        kvstore = config["kvstore"]
        update_on_kvstore = config["update_on_kvstore"]
        if isinstance(kvstore, str) and kvstore in ("device", "local") \
                and len(self._contexts or [None]) == 1:
            kvstore = None
        if kvstore:
            if isinstance(kvstore, str):
                from .. import kvstore as kvs_mod

                kvstore = kvs_mod.create(kvstore)
            if update_on_kvstore is None:
                update_on_kvstore = False
        else:
            kvstore = None
        self._kvstore = kvstore
        self._update_on_kvstore = bool(update_on_kvstore) if kvstore \
            else False
        if self._kvstore is not None:
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            ctx = self._contexts[0] if self._contexts else None
            for i, param in enumerate(self._params):
                self._kvstore.init(i, param.data(ctx))
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def save_states(self, fname):
        """Save the updater's states and the optimizer to ``fname`` (the
        store's, under ``update_on_kvstore``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load ``save_states``'s file: the states into each context's
        live state tensors (new ones on that context where there are
        none), and its optimizer, with this Trainer's parameters as its
        ``param_dict``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
            self._optimizer.param_dict = dict(enumerate(self._params))
            return
        with open(fname, "rb") as f:
            states = f.read()
        for upd, ctx in zip(self._updaters, self._contexts or [None]):
            upd.set_states(states, device=ctx.torch_device() if ctx
                           else None)
            upd.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce (through the kvstore, if any) + update (reference
        trainer.py:step)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Only reduce the gradients, for an update done by hand."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() when parameters are updated "
                             "on kvstore is not supported. Try setting "
                             "`update_on_kvstore` to False.")
        self._allreduce_grads()

    def _allreduce_grads(self):
        """Push each gradient into the store (and, without
        ``update_on_kvstore``, pull the reduced value back); nothing
        without a store (``mxnet_tpu/gluon/trainer.py:130-170``)."""
        if self._kvstore is None:
            return
        kv = self._kvstore
        keys = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not self._update_on_kvstore and kv._can_fuse_pushpull():
            grads = [self._params[i].list_grad() for i in keys]
            kv.pushpull_multi(keys, grads, grads)
            return
        for i in keys:
            grad = self._params[i].list_grad()
            kv.push(i, grad, priority=-i)
            if not self._update_on_kvstore:
                kv.pull(i, grad, priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        """Only update, the gradients reduced already."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() when parameters are updated on "
                             "kvstore is not supported. Try setting "
                             "`update_on_kvstore` to False.")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """Apply each context's updater to every parameter with a fresh
        gradient there; under ``update_on_kvstore``, pull the store's
        weights instead."""
        rows = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not ignore_stale_grad:
                for arr in param.list_data():
                    if not getattr(arr, "_fresh_grad", True):
                        raise UserWarning(
                            "Gradient of Parameter `%s` on context %s has "
                            "not been updated by backward since last "
                            "`step`. This could mean a bug in your model "
                            "that made it only use a subset of the "
                            "Parameters for this iteration. If you are "
                            "intentionally only using a subset, call step "
                            "with ignore_stale_grad=True to suppress this "
                            "warning and skip updating of Parameters with "
                            "stale gradient" % (param.name, arr.context))
            if self._update_on_kvstore:
                for arr in param.list_data():
                    arr._fresh_grad = False
                self._kvstore.pull(i, param.list_data(), priority=-i)
                continue
            rows.append((i, param))
        n = len(self._updaters)
        if fastpath.enabled() and fastpath.supports(self._optimizer,
                                                    n_positions=n):
            # one fused apply a context, its updater over its copies
            for j, upd in enumerate(self._updaters):
                triples = []
                for i, param in rows:
                    arr = param.list_data()[j]
                    if getattr(arr, "_fresh_grad", True):
                        triples.append((i, param.list_grad()[j], arr))
                        arr._fresh_grad = False
                fastpath.apply_updater(upd, triples, positions=n)
            return
        for i, param in rows:
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                if getattr(arr, "_fresh_grad", True):
                    upd(i, grad, arr)
                    arr._fresh_grad = False
