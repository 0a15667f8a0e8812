"""DataParallelExecutorGroup on one context: the port of
``mxnet_tpu/module/executor_group.py``.

The JAX group slices each batch over its contexts (``:281-303``); the
port's Module takes one context, so the group holds one executor, fed
the whole batch. Several contexts (and ``_split_input_slice``) are not
ported yet and raise.

Given a ``shared_group`` (a bucketing module's default bucket), the
executor is bound with the shared group's executor as ``shared_exec``
over the parameter names (``:78-115``): its parameter, gradient and
auxiliary arrays are the shared group's own NDArrays, so an update
through one bucket is every bucket's, without a copy.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write", shared_group=None,
                 state_names=None):
        if len(contexts) != 1:
            raise MXNetError("Module over %d contexts is not ported yet (one "
                             "context)" % len(contexts))
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.state_names = list(state_names or [])
        fixed = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.data_names = [x[0] for x in data_shapes]
        self.label_names = [x[0] for x in label_shapes] if label_shapes \
            else []
        self.batch_size = data_shapes[0][1][0]

        self._grad_req = {}
        for name in self.arg_names:
            if name in param_names and name not in fixed:
                self._grad_req[name] = grad_req if for_training else "null"
            elif name in self.data_names:
                self._grad_req[name] = grad_req if inputs_need_grad \
                    else "null"
            else:
                self._grad_req[name] = "null"
        shapes = dict(data_shapes)
        shapes.update(dict(label_shapes or []))
        shared = shared_group.execs[0] if shared_group is not None \
            else None
        self.execs = [symbol.simple_bind(
            contexts[0], grad_req=self._grad_req, shared_exec=shared,
            shared_arg_names=param_names if shared is not None else None,
            **shapes)]

    def get_params(self, arg_params, aux_params):
        """Point ``arg_params``/``aux_params`` at the executor's current
        values (no copy: one context)."""
        e = self.execs[0]
        for name in self.param_names:
            arg_params[name]._data = e.arg_dict[name]._data
        for name in self.aux_names:
            aux_params[name]._data = e.aux_dict[name]._data

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        e = self.execs[0]
        dev = self.contexts[0].torch_device()
        for name, arr in zip(self.data_names, data_batch.data):
            e.arg_dict[name]._data = arr._data.to(dev)
        if self.label_names and data_batch.label:
            for name, arr in zip(self.label_names, data_batch.label):
                e.arg_dict[name]._data = arr._data.to(dev)
        e.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self.execs[0].backward(out_grads)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """The metric over the whole batch: one executor, no slices
        (reference executor_group.py:601)."""
        eval_metric.update_dict(
            dict(zip(self.label_names, labels)),
            dict(zip(self.output_names, self.execs[0].outputs)))

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def install_monitor(self, mon):
        """The executor hands ``mon`` its outputs after each forward
        (``mxnet_tpu/module/executor_group.py:197-199``: the callback only,
        without ``Monitor.install``, so ``toc`` adds no arguments)."""
        for e in self.execs:
            e.set_monitor_callback(mon.stat_helper
                                   if hasattr(mon, "stat_helper") else mon)

    def get_input_grads(self, merge_multi_context=True):
        grads = [self.execs[0].grad_dict[n] for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]
