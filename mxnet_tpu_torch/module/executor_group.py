"""DataParallelExecutorGroup: the port of
``mxnet_tpu/module/executor_group.py``.

One executor a context. Each batch is sliced along its first axis over
the contexts by ``work_load_list`` (:func:`_split_input_slice`, ``:23-36``;
even by default), every executor runs its slice on its own device (a
slice for another device is copied there, counted in
``mxnet_cross_device_bytes_total{site="module.slices"}``), and
``get_outputs`` joins the executors' outputs along the batch axis on the
first context's device. The metric is updated slice by slice.
``group2ctxs`` (one dict, or one a context) places each executor's
``ctx_group``s (``Symbol.simple_bind(group2ctx=)``).

Given a ``shared_group`` (a bucketing module's default bucket), the
executor of each context is bound with the shared group's executor of
that context as ``shared_exec`` over the parameter names (``:78-115``):
its parameter, gradient and auxiliary arrays are the shared group's own
NDArrays, so an update through one bucket is every bucket's, without a
copy.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray import ndarray as nd_mod
from ..ndarray.ndarray import NDArray, cross_copy

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's rows of each context: ``slice``s in context order,
    sized by ``work_load_list`` (rounded; the last takes the rest)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            stop = batch_size
        else:
            stop = start + int(round(batch_size * w / total))
        slices.append(slice(start, stop))
        start = stop
    return slices


class DataParallelExecutorGroup(object):
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write", shared_group=None,
                 state_names=None, group2ctxs=None):
        if isinstance(group2ctxs, dict) or group2ctxs is None:
            group2ctxs = [group2ctxs] * len(contexts)
        if len(group2ctxs) != len(contexts):
            raise MXNetError("group2ctxs: one map a context (%d), got %d"
                             % (len(contexts), len(group2ctxs)))
        self.symbol = symbol
        self.contexts = contexts
        self.group2ctxs = group2ctxs
        self.workload = list(workload) if workload else [1] * len(contexts)
        if len(self.workload) != len(contexts):
            raise MXNetError("work_load_list: one load a context (%d), got %d"
                             % (len(contexts), len(self.workload)))
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
        self.slices = _split_input_slice(self.batch_size, self.workload)
        shapes = dict(data_shapes)
        shapes.update(dict(label_shapes or []))
        self.execs = []
        for i, ctx in enumerate(contexts):
            rows = self.slices[i].stop - self.slices[i].start
            shared = shared_group.execs[i] if shared_group is not None \
                and i < len(shared_group.execs) else None
            self.execs.append(symbol.simple_bind(
                ctx, grad_req=self._grad_req, group2ctx=self.group2ctxs[i],
                shared_exec=shared,
                shared_arg_names=param_names if shared is not None else None,
                **{n: (rows,) + tuple(s[1:]) for n, s in shapes.items()}))

    def get_params(self, arg_params, aux_params):
        """Point ``arg_params``/``aux_params`` at the current values: one
        context's own arrays (no copy); over several, each parameter's
        mean over the contexts on the first one's device (the JAX group's
        host mean, ``:132-153``), and the first context's auxiliary
        states."""
        for name in self.param_names:
            if name not in self.execs[0].arg_dict:
                continue
            block = [e.arg_dict[name]._data for e in self.execs]
            if len(block) == 1:
                arg_params[name]._data = block[0]
                continue
            dev = block[0].device
            acc = block[0]
            for w in block[1:]:
                acc = acc + cross_copy(w, dev, "module.params")
            arg_params[name]._data = acc / len(block)
        for name in self.aux_names:
            aux_params[name]._data = self.execs[0].aux_dict[name]._data

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=allow_extra)

    def _load(self, names, arrays):
        """Each executor's slice of the batch's ``arrays`` into its
        arguments ``names``, on its device."""
        for name, arr in zip(names, arrays):
            src = arr._data if isinstance(arr, NDArray) \
                else torch.as_tensor(arr)
            for sl, e in zip(self.slices, self.execs):
                whole = len(self.execs) == 1 or \
                    sl.stop - sl.start == src.shape[0]
                dst = e.arg_dict[name]
                dst._data = cross_copy(src if whole else src[sl],
                                       dst._data.device, "module.slices")

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load(self.data_names, data_batch.data)
        if self.label_names and data_batch.label:
            self._load(self.label_names, data_batch.label)
        for e in self.execs:
            e.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        for sl, e in zip(self.slices, self.execs):
            og = None
            if out_grads is not None:
                og = [g if len(self.execs) == 1 else g[sl]
                      for g in out_grads]
            e.backward(og)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """The metric over each executor's slice (reference
        executor_group.py:601)."""
        for sl, e in zip(self.slices, self.execs):
            part = [lab if sl.stop - sl.start == lab.shape[0] else lab[sl]
                    for lab in labels]
            eval_metric.update_dict(dict(zip(self.label_names, part)),
                                    dict(zip(self.output_names, e.outputs)))

    def _merge(self, per_exec):
        """One array a name from the executors' (joined along the batch
        axis on the first context's device where there are several)."""
        if len(per_exec) == 1:
            return per_exec[0]
        dev = per_exec[0]._data.device
        return nd_mod.concat(*[NDArray(cross_copy(a._data, dev,
                                                  "module.outputs"))
                               for a in per_exec], dim=0)

    def get_outputs(self, merge_multi_context=True):
        outs = [[e.outputs[i] for e in self.execs]
                for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [self._merge(o) for o in outs]
        return outs

    def install_monitor(self, mon):
        """The executors hand ``mon`` their outputs after each forward
        (``mxnet_tpu/module/executor_group.py:197-199``: the callback only,
        without ``Monitor.install``, so ``toc`` adds no arguments)."""
        for e in self.execs:
            e.set_monitor_callback(mon.stat_helper
                                   if hasattr(mon, "stat_helper") else mon)

    def get_input_grads(self, merge_multi_context=True):
        grads = [[e.grad_dict[n] for e in self.execs]
                 for n in self.data_names]
        if merge_multi_context:
            return [self._merge(g) for g in grads]
        return grads
