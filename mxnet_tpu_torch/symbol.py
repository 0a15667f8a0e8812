"""Symbol: declarative graph construction, the port of
``mxnet_tpu/symbol.py``.

The graph is a small Python DAG over the op registry, as in the JAX
package, and JSON keeps the reference's ``*-symbol.json`` format (nodes,
arg_nodes and heads with ``[node_id, out_idx, version]`` inputs), so a
graph written by either package loads in the other. ``Symbol.save``
commits that JSON atomically (``elastic.commit_bytes``: tmp, fsync,
rename), and :func:`load` reads it, as in the JAX package.

Two departures in how a graph runs:

* shape inference runs every op on ``meta`` tensors (shapes, no data)
  where the JAX package traces it with ``jax.eval_shape``; ops that read
  values (``MultiBoxTarget``, the NMS) have a shape rule of their own.
  Parameter shapes are back-filled from the op's attrs as in
  ``_fill_param_shapes`` (Convolution and Deconvolution in either
  channel layout, FullyConnected, LayerNorm, Embedding, the output ops'
  labels), and for a ``Custom`` node from
  what its prop's ``infer_shape`` returns;
* an executor walks the graph eagerly under torch autograd
  (:mod:`.executor`) where the JAX package jits it whole;
  :meth:`Symbol.eval_nd` (a ``SymbolBlock``'s forward) walks it on the
  NDArray inputs' device, or on the card, without a gradient, as the
  JAX package's unwraps its arrays.

A variable marked ``_forced_aux`` (a block parameter with
``grad_req='null'``, set by a ``HybridBlock``'s symbolic trace, or an
auxiliary state inside a control-flow body) is an auxiliary state
wherever it is used, as in the JAX package.

The control-flow ops (``sym.contrib.foreach``/``while_loop``/``cond``)
and ``_subgraph_op`` keep their subgraphs in their attrs; JSON nests each
subgraph's graph JSON in its attr, and shape inference reaches into the
subgraphs for the shapes of their free variables (a weight used inside a
loop). ``simple_bind(shared_exec=)`` binds the shared executor's arrays
themselves (a bucketing module's executors share one set of
parameters); :meth:`Symbol.get_backend_symbol` partitions the graph with
a registered ``subgraph`` property. ``group2ctx`` is not ported yet and
raises.
"""
from __future__ import annotations

import json
from builtins import slice as _py_slice  # a generated op may shadow it
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .base import MXNetError, dtype_name
from .name import NameManager
from .ops.registry import OP_REGISTRY, get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "invoke", "zeros", "ones", "full", "arange", "eye", "maximum",
           "minimum", "hypot", "histogram"]


class _Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "_extra_attrs",
                 "_forced_aux")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]]):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self._extra_attrs = {}  # user attrs (__lr_mult__ etc.)
        self._forced_aux = False  # an aux state wherever it is used

    def is_var(self):
        return self.op is None

    def num_outputs(self) -> int:
        if self.op is None:
            return 1
        opdef = get_op(self.op)
        return opdef.num_outputs(opdef.parse_attrs(self.attrs))


# op inputs that are auxiliary states (not gradient targets), as in the
# JAX package (reference FMutateInputs)
_AUX_INPUT_NAMES = {"moving_mean", "moving_var", "running_mean",
                    "running_var"}


class Symbol(object):
    """Multi-output symbolic handle (reference symbol.py:54)."""

    def __init__(self, outputs: List[Tuple[_Node, int]]):
        self._outputs = list(outputs)

    # -- identity / composition -----------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def attr(self, key):
        return self._outputs[0][0]._extra_attrs.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0]._extra_attrs.update(
            {k: str(v) for k, v in kwargs.items()})

    def attr_dict(self):
        """name -> attr dict of every node (reference symbol.py:attr_dict)."""
        ret = {}
        for node in self._topo_nodes():
            d = {}
            if node.op is not None:
                d.update(_str_attrs(node))
            d.update(node._extra_attrs)
            if d:
                ret[node.name] = d
        return ret

    def __repr__(self):
        if len(self._outputs) == 1:
            return "<Symbol %s>" % self.name
        return "<Symbol group [%s]>" % ", ".join(
            n.name for n, _ in self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if names.count(index) != 1:
                raise MXNetError(
                    "There are multiple outputs with name \"%s\"" % index
                    if index in names else
                    "Cannot find output that matches name \"%s\"" % index)
            index = names.index(index)
        if isinstance(index, _py_slice):
            return Group([self[i] for i in range(*index.indices(len(self)))])
        if index >= len(self):
            raise IndexError
        return Symbol([self._outputs[index]])

    def get_internals(self):
        """Every output of every node, in topological order, as one
        grouped Symbol (reference symbol.py:get_internals)."""
        return Group([Symbol([(node, i)]) for node in self._topo_nodes()
                      for i in range(node.num_outputs())])

    def get_children(self):
        """The inputs of the output nodes as one Symbol, or None for a
        variable."""
        children = [entry for n, _ in self._outputs for entry in n.inputs]
        return Symbol(children) if children else None

    # -- operators (reference symbol.py:141-210) ------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _invoke(op, [a, b], {})
        if isinstance(other, (int, float, np.generic)):
            return _invoke(scalar_op, [self], {"scalar": float(other)})
        raise TypeError("cannot combine Symbol with %r" % (other,))

    def __add__(self, o):
        return self._binop(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        if isinstance(o, (int, float, np.generic)):
            return _invoke("_rminus_scalar", [self], {"scalar": float(o)})
        return self._binop(o, "elemwise_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        if isinstance(o, (int, float, np.generic)):
            return _invoke("_rdiv_scalar", [self], {"scalar": float(o)})
        return self._binop(o, "elemwise_div", "_div_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "_power", "_power_scalar")

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binop(o, "broadcast_mod", "_rmod_scalar", reverse=True)

    # comparisons build graph nodes (reference symbol.py:303-339); the
    # identity hash keeps Symbols usable in dicts and sets
    __hash__ = object.__hash__

    def __eq__(self, o):
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __neg__(self):
        return _invoke("negative", [self], {})

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, _):
        """A new graph of new nodes, through JSON
        (``mxnet_tpu/symbol.py:210-214``)."""
        return load_json(self.tojson())

    # -- graph traversal --------------------------------------------------
    def _topo_nodes(self) -> List[_Node]:
        seen = set()
        order: List[_Node] = []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for n, _ in self._outputs:
            visit(n)
        return order

    def _aux_ids(self) -> set:
        """ids of the variables marked ``_forced_aux`` or bound by some op
        to an aux input slot."""
        aux = set()
        for n in self._topo_nodes():
            if n.is_var():
                if n._forced_aux:
                    aux.add(id(n))
                continue
            opdef = get_op(n.op)
            names = opdef.input_names(opdef.parse_attrs(n.attrs))
            for (src, _), iname in zip(n.inputs, names):
                if src.is_var() and iname in _AUX_INPUT_NAMES:
                    aux.add(id(src))
        return aux

    def list_arguments(self) -> List[str]:
        aux = self._aux_ids()
        return [n.name for n in self._topo_nodes()
                if n.is_var() and id(n) not in aux]

    def list_outputs(self) -> List[str]:
        outs = []
        for node, idx in self._outputs:
            if node.is_var():
                outs.append(node.name)
            elif node.num_outputs() == 1:
                outs.append(node.name + "_output")
            else:
                outs.append("%s_output%d" % (node.name, idx))
        return outs

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_ids()
        return [n.name for n in self._topo_nodes()
                if n.is_var() and id(n) in aux]

    def list_inputs(self) -> List[str]:
        """Every variable, arguments and auxiliary states, in topological
        order."""
        return [n.name for n in self._topo_nodes() if n.is_var()]

    # -- shape and type inference ------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the given input
        shapes (positional in ``list_arguments()`` order, or by name)."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """:meth:`infer_shape` that gives None for what it cannot infer,
        where :meth:`infer_shape` raises: an op whose inputs are not all
        known, or whose shape rule fails, leaves its outputs unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy dtypes: every
        argument and output in the first given type (float32 by
        default), the auxiliary states in float32, as the JAX package
        gives them (``mxnet_tpu/symbol.py:355-363``)."""
        dtype = args[0] if args and args[0] is not None else np.float32
        return ([np.dtype(dtype) for _ in self.list_arguments()],
                [np.dtype(dtype) for _ in self._outputs],
                [np.dtype(np.float32)
                 for _ in self.list_auxiliary_states()])

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known: Dict[str, Tuple] = {}
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                known[name] = tuple(shape)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)

        # local propagation in topological order: run each op on meta
        # tensors once all its input shapes are known, back-filling
        # parameter shapes from the op's attrs first
        shapes: Dict[Tuple[int, int], Optional[Tuple]] = {}
        dtypes: Dict[Tuple[int, int], torch.dtype] = {}
        for node in self._topo_nodes():
            if node.is_var():
                shp = known.get(node.name)
                if shp is None and node._extra_attrs.get("__shape__"):
                    shp = tuple(json.loads(node._extra_attrs["__shape__"]))
                shapes[(id(node), 0)] = shp
                dtypes[(id(node), 0)] = torch.float32
                continue
            in_shapes = [shapes.get((id(n), i)) for n, i in node.inputs]
            if any(s is None for s in in_shapes):
                filled = _fill_param_shapes(node, in_shapes)
                if filled is not None:
                    for (src, si), old, new in zip(node.inputs, in_shapes,
                                                   filled):
                        if old is None and new is not None:
                            shapes[(id(src), si)] = new
                    in_shapes = filled
            if any(s is None for s in in_shapes):
                for i in range(node.num_outputs()):
                    shapes[(id(node), i)] = None
                continue
            opdef = get_op(node.op)
            attrs = opdef.parse_attrs(node.attrs)
            if not node.inputs:  # a nullary op (_zeros) makes meta too
                attrs["__device__"] = torch.device("meta")
            metas = [torch.empty(s, dtype=dtypes.get((id(n), i),
                                                     torch.float32),
                                 device="meta")
                     for s, (n, i) in zip(in_shapes, node.inputs)]
            try:
                with torch.no_grad():
                    out = opdef.fcompute(attrs, *metas)
            except Exception as e:  # an op's own error names the problem
                if partial:
                    for i in range(node.num_outputs()):
                        shapes[(id(node), i)] = None
                    continue
                raise MXNetError("shape inference failed at op %s(%s): %s"
                                 % (node.op, node.name, e)) from e
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, o in enumerate(outs):
                shapes[(id(node), i)] = tuple(o.shape)
                dtypes[(id(node), i)] = o.dtype

        aux = self._aux_ids()
        arg_shapes = [shapes.get((id(n), 0)) for n in self._topo_nodes()
                      if n.is_var() and id(n) not in aux]
        out_shapes = [shapes.get((id(n), i)) for n, i in self._outputs]
        aux_shapes = [shapes.get((id(n), 0)) for n in self._topo_nodes()
                      if n.is_var() and id(n) in aux]
        if not partial and any(s is None for s in out_shapes):
            raise MXNetError("infer_shape: insufficient information")
        return arg_shapes, out_shapes, aux_shapes

    # -- JSON (reference *-symbol.json format) ---------------------------
    def tojson(self) -> str:
        nodes = self._topo_nodes()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        arg_nodes = []
        for i, n in enumerate(nodes):
            if n.is_var():
                arg_nodes.append(i)
            entry = {
                "op": n.op if n.op is not None else "null",
                "name": n.name,
                "inputs": [[node_ids[id(src)], idx, 0]
                           for src, idx in n.inputs],
            }
            attrs = dict(_str_attrs(n))
            attrs.update(n._extra_attrs)
            if attrs:
                entry["attrs"] = {k: str(v) for k, v in attrs.items()}
            out_nodes.append(entry)
        js = {
            "nodes": out_nodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[node_ids[id(n)], idx, 0] for n, idx in self._outputs],
            "attrs": {"mxnet_version": ["int", 10300]},
        }
        return json.dumps(js, indent=2)

    def get_backend_symbol(self, backend):
        """This graph partitioned by a registered subgraph backend
        (reference ``Symbol.get_backend_symbol``): a name registered with
        ``subgraph.register_subgraph_property``."""
        from . import subgraph

        return subgraph.partition_graph(self, backend)

    def grad(self, wrt):
        raise MXNetError(
            "Symbol.grad is not supported; gradients come from "
            "Executor.backward (torch autograd over the graph)")

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` as one atomic commit under the
        ``ckpt.commit`` retry policy (``mxnet_tpu/symbol.py:408``): a
        crash mid-save leaves the old file or the new one."""
        from .elastic import commit_bytes

        commit_bytes(fname, self.tojson().encode("utf-8"), kind="symbol")

    # -- evaluation / binding ---------------------------------------------
    def eval_torch(self, value_map: Dict[str, torch.Tensor],
                   aux_updates: Optional[Dict[str, torch.Tensor]] = None,
                   device: Optional[torch.device] = None):
        """Output tensors of the graph given name -> tensor bindings; runs
        each op's ``fcompute`` in topological order (under whatever
        autograd mode the caller set). An op with no input and no ``ctx``
        of its own (``_zeros``) makes its output on ``device`` when given
        (an executor's, or a control-flow op's inputs'), else on the
        current context. Given a dict ``aux_updates``, a
        ``BatchNorm`` in train mode (without ``use_global_stats``) records
        there its moving statistics' new values, ``momentum * moving +
        (1 - momentum) * batch``, under the auxiliary variables' names,
        as ``mxnet_tpu/symbol.py:462-471`` does; the caller writes them."""
        from . import autograd

        vals: Dict[Tuple[int, int], Any] = {}
        for node in self._topo_nodes():
            if node.is_var():
                if node.name not in value_map:
                    raise MXNetError("eval: missing binding for %r"
                                     % node.name)
                vals[(id(node), 0)] = value_map[node.name]
                continue
            opdef = get_op(node.op)
            attrs = opdef.parse_attrs(node.attrs)
            if device is not None and not node.inputs \
                    and not attrs.get("ctx"):
                attrs["__device__"] = device
            out = opdef.fcompute(attrs, *[vals[(id(n), i)]
                                          for n, i in node.inputs])
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            if aux_updates is not None and node.op == "BatchNorm" \
                    and autograd.is_training() \
                    and not attrs.use_global_stats:
                names = opdef.input_names(attrs)
                m = attrs.momentum
                with torch.no_grad():
                    for slot, stat in (("moving_mean", outs[1]),
                                       ("moving_var", outs[2])):
                        src, _ = node.inputs[names.index(slot)]
                        if src.is_var():
                            old = vals[(id(src), 0)]
                            aux_updates[src.name] = m * old + (1 - m) * stat
        return [vals[(id(n), i)] for n, i in self._outputs]

    def eval_nd(self, arg_dict, ctx=None):
        """The outputs for ``arg_dict`` (name -> NDArray, tensor or numpy),
        each a new NDArray; one output alone, several as a list. The graph
        runs on the device of the first NDArray input; without one, on
        ``ctx``, the current context (the card) by default. Inputs that
        are not NDArrays are put on that device first, so numpy inputs
        run on the card unless the host is asked for. The outputs are
        moved to ``ctx`` when it is given. As the JAX package's
        (``mxnet_tpu/symbol.py:474-484``), the inputs are unwrapped and
        nothing is recorded: no gradient reaches them, and no moving
        statistic is updated."""
        from .context import current_context, from_device
        from .ndarray.ndarray import NDArray

        nds = [v for v in arg_dict.values() if isinstance(v, NDArray)]
        run_ctx = from_device(nds[0]._data.device) if nds \
            else (ctx or current_context())
        dev = run_ctx.torch_device()
        vm = {}
        for k, v in arg_dict.items():
            if isinstance(v, NDArray):
                v = v._data
            elif isinstance(v, torch.Tensor):
                v = v.to(dev)
            else:
                v = torch.as_tensor(np.asarray(v), device=dev)
            vm[k] = v.detach()
        with run_ctx, torch.no_grad():
            outs = self.eval_torch(vm)
        if ctx is not None:
            outs = [o.to(ctx.torch_device()) for o in outs]
        nd_outs = [NDArray(o) for o in outs]
        return nd_outs[0] if len(nd_outs) == 1 else nd_outs

    def eval(self, ctx=None, **kwargs):
        """Bind and run forward in one call (reference symbol.py:eval):
        :meth:`eval_nd` of the keyword arrays."""
        return self.eval_nd(kwargs, ctx)

    def save_checkpoint_compatible(self):
        return True

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An executor over the given arrays. ``shared_exec`` is accepted
        and unused, as in the JAX package: the arrays are the caller's."""
        from .executor import Executor

        if group2ctx:
            raise MXNetError("bind: group2ctx is not ported yet")
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Allocate the argument, gradient and aux arrays on ``ctx`` from
        the inferred shapes and bind (reference symbol.py:1289).

        With ``shared_exec``, an argument named in ``shared_arg_names``
        (default: every argument of ``shared_exec``), its gradient and
        every auxiliary state are ``shared_exec``'s own NDArrays where the
        shape and dtype agree (``mxnet_tpu/symbol.py:519-565``, the
        reference's shared data pool): an update through one executor is
        the other's. ``shared_buffer`` (a dict, name -> NDArray) is the
        other pool: an argument not shared through ``shared_exec`` takes
        the buffer's array of its name where the shape and dtype agree,
        and a newly made argument array is put into the buffer under its
        name, as in the JAX package. ``group2ctx`` is not ported yet and
        raises."""
        from .executor import Executor
        from .ndarray import ndarray as nd_mod

        if group2ctx:
            raise MXNetError("simple_bind: group2ctx is not ported yet")
        if stype_dict and any(v != "default" for v in stype_dict.values()):
            raise MXNetError("simple_bind: sparse storage is not ported yet")
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
        if missing:
            raise MXNetError("simple_bind: cannot infer shapes for %s"
                             % missing)
        type_dict = type_dict or {}
        reqs = grad_req if isinstance(grad_req, dict) \
            else dict.fromkeys(arg_names, grad_req)
        shared_args, shared_grads, shared_aux = {}, {}, {}
        if shared_exec is not None:
            share = set(shared_exec.arg_dict if shared_arg_names is None
                        else shared_arg_names)
            shared_args = {n: a for n, a in shared_exec.arg_dict.items()
                           if n in share}
            shared_grads = {n: g for n, g in shared_exec.grad_dict.items()
                            if n in share and g is not None}
            shared_aux = shared_exec.aux_dict
        args, args_grad = {}, {}
        for name, shape in zip(arg_names, arg_shapes):
            dt = type_dict.get(name, np.float32)

            def fits(arr):
                return arr is not None and tuple(arr.shape) == tuple(shape) \
                    and arr.dtype == np.dtype(dt)

            if fits(shared_args.get(name)):
                args[name] = shared_args[name]
            elif shared_buffer is not None and \
                    fits(shared_buffer.get(name)):
                args[name] = shared_buffer[name]
            else:
                args[name] = nd_mod.zeros(shape, ctx=ctx, dtype=dt)
                if shared_buffer is not None:
                    shared_buffer[name] = args[name]
            if reqs.get(name, "null") != "null":
                args_grad[name] = shared_grads[name] \
                    if fits(shared_grads.get(name)) \
                    else nd_mod.zeros(shape, ctx=ctx, dtype=dt)
        aux = {}
        for name, shape in zip(self.list_auxiliary_states(), aux_shapes):
            held = shared_aux.get(name)
            aux[name] = held if held is not None and \
                tuple(held.shape) == tuple(shape) \
                else nd_mod.zeros(shape, ctx=ctx)
        return Executor(self, ctx, args, args_grad or None, grad_req, aux)


def _str_attrs(node: _Node) -> Dict[str, str]:
    if node.op is None:
        return {}
    opdef = get_op(node.op)
    return opdef.serialize_attrs(opdef.parse_attrs(node.attrs))


def _fill_param_shapes(node: _Node, in_shapes):
    """Back-fill unknown parameter-input shapes from the op's attrs and
    its data shape (the JAX package's ``_fill_param_shapes``, for the ops
    the port has). Returns a filled copy of ``in_shapes``, or None when
    the op gives no hint."""
    op = node.op
    opdef = get_op(op)
    attrs = opdef.parse_attrs(node.attrs)
    in_names = opdef.input_names(attrs)
    named = dict(zip(in_names, in_shapes))
    data = named.get("data")
    out = list(in_shapes)

    def put(slot, shape):
        if slot in in_names and named.get(slot) is None and shape is not None:
            out[in_names.index(slot)] = tuple(int(s) for s in shape)

    if op == "FullyConnected" and data is not None:
        in_units = int(np.prod(data[1:])) if attrs.flatten else data[-1]
        put("weight", (attrs.num_hidden, in_units))
        put("bias", (attrs.num_hidden,))
    elif op in ("Convolution", "Deconvolution") and data is not None:
        # the channels: axis 1, or the last axis of a channels-last layout
        # (the weight is OI + spatial in both)
        layout = attrs.layout or ""
        c = data[1] if not layout or layout.startswith("NC") else data[-1]
        if op == "Convolution":
            put("weight", (attrs.num_filter, c // attrs.num_group)
                + tuple(attrs.kernel))
        else:
            put("weight", (c, attrs.num_filter // attrs.num_group)
                + tuple(attrs.kernel))
        put("bias", (attrs.num_filter,))
    elif op in ("BatchNorm", "InstanceNorm") and data is not None:
        c = (data[attrs.get("axis", 1) % len(data)],)
        for slot in ("gamma", "beta", "moving_mean", "moving_var"):
            put(slot, c)
    elif op == "LayerNorm" and data is not None:
        c = (data[attrs.axis % len(data)],)
        put("gamma", c)
        put("beta", c)
    elif op == "Embedding":
        put("weight", (attrs.input_dim, attrs.output_dim))
    elif op == "LeakyReLU" and data is not None \
            and attrs.act_type == "prelu":
        put("gamma", (data[1] if len(data) > 1 else data[0],))
    elif op == "RNN" and data is not None:
        from .ops.nn import rnn_param_size

        put("parameters", (rnn_param_size(
            attrs.mode, data[2], attrs.state_size, attrs.num_layers,
            attrs.bidirectional),))
        st = (attrs.num_layers * (2 if attrs.bidirectional else 1),
              data[1], attrs.state_size)
        put("state", st)
        put("state_cell", st)
    elif op in ("SoftmaxOutput", "Softmax") and data is not None:
        put("label", data[:-1])
    elif op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                "MAERegressionOutput", "SVMOutput") and data is not None:
        put("label", data)
    elif op == "Custom":  # what the user's prop says (a loss op's label)
        from .operator import fill_input_shapes

        return fill_input_shapes(attrs, in_shapes)
    elif op in ("_foreach", "_while_loop", "_cond"):
        if not _fill_from_subgraphs(op, attrs, in_shapes, named, put):
            return None
    else:
        return None
    return out


def _fill_from_subgraphs(op, attrs, in_shapes, named, put):
    """A control-flow node's free-variable shapes (layer weights, moving
    statistics used in a body) from partial inference inside its
    subgraphs, given the interface variables' known shapes: a
    ``_foreach`` data input's without its leading (time) axis
    (``mxnet_tpu/symbol.py:684-726``; reference
    ``subgraph_op_common.cc:InferSubgraphShape``). True if any was
    found."""
    if op == "_foreach":
        dn, sn = attrs["data_names"], attrs["state_names"]
        iface = list(dn) + list(sn)
        subs = [attrs["__subgraph__"]]
        known = {n: tuple(s[1:]) for n, s in zip(dn, in_shapes)
                 if s is not None}
        known.update((n, tuple(s)) for n, s in
                     zip(sn, in_shapes[len(dn):]) if s is not None)
    elif op == "_while_loop":
        iface = list(attrs["loop_var_names"])
        subs = [attrs["__cond__"], attrs["__func__"]]
        known = {n: tuple(s) for n, s in zip(iface, in_shapes)
                 if s is not None}
    else:
        iface = []
        subs = [attrs["__pred__"], attrs["__then__"], attrs["__else__"]]
        known = {n: tuple(s) for n, s in zip(attrs["input_names"],
                                             in_shapes) if s is not None}
    found_any = False
    for sub in subs:
        try:
            arg_shapes, _, aux_shapes = sub.infer_shape_partial(**known)
        except MXNetError:
            continue
        found = dict(zip(sub.list_arguments(), arg_shapes))
        found.update(zip(sub.list_auxiliary_states(), aux_shapes))
        for slot, shp in found.items():
            if slot not in iface and shp is not None \
                    and slot in named and named[slot] is None:
                put(slot, shp)
                found_any = True
    return found_any


def _invoke(op_name: str, sym_inputs: List[Symbol], attrs: Dict[str, Any],
            name: Optional[str] = None) -> Symbol:
    from .attribute import AttrScope

    opdef = get_op(op_name)
    parsed = opdef.parse_attrs(attrs)
    name = NameManager.current().get(name, op_name.lower().lstrip("_"))
    entries: List[Tuple[_Node, int]] = []
    for s in sym_inputs:
        # a multi-output symbol used as one input gives all its outputs
        entries.extend(s._outputs)
    # missing trailing inputs become variables (FullyConnected(data)
    # creates name_weight / name_bias)
    in_names = opdef.input_names(parsed)
    for missing in in_names[len(entries):]:
        entries.append((_Node(None, "%s_%s" % (name, missing), {}, []), 0))
    node = _Node(op_name, name, dict(attrs), entries)
    scope_attrs = AttrScope.current().get(None)
    if scope_attrs:
        node._extra_attrs.update(scope_attrs)
    n_out = opdef.num_outputs(parsed)
    # BatchNorm's and LayerNorm's mean and variance outputs are internal
    if op_name in ("BatchNorm", "LayerNorm"):
        n_out = 1
    return Symbol([(node, i) for i in range(n_out)])


def _make_sym_op(op_name: str):
    opdef = OP_REGISTRY[op_name]
    param_names = list(opdef.params.keys())

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_inputs = [a for a in args if isinstance(a, Symbol)]
        scalars = [a for a in args if not isinstance(a, Symbol)]
        kw_syms = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        for k in kw_syms:
            kwargs.pop(k)
        if kw_syms:  # keyword inputs (data=..., weight=...) in slot order
            in_names = opdef.input_names(opdef.parse_attrs(kwargs))
            sym_inputs.extend(kw_syms[n] for n in in_names if n in kw_syms)
        if scalars:
            free = [p for p in param_names if p not in kwargs]
            kwargs.update(zip(free, scalars))
        out = _invoke(op_name, sym_inputs, kwargs, name=name)
        if attr:
            out._set_attr(**attr)
        return out

    fn.__name__ = op_name
    fn.__qualname__ = op_name
    fn.__doc__ = opdef.doc
    return fn


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs) -> Symbol:
    """A variable (reference symbol.py:var)."""
    from .attribute import AttrScope

    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    node = _Node(None, name, {}, [])
    extra = {}
    if shape is not None:
        extra["__shape__"] = json.dumps(list(shape))
    if lr_mult is not None:
        extra["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        extra["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        extra["__dtype__"] = dtype_name(dtype)
    if init is not None:
        extra["__init__"] = init if isinstance(init, str) else init.dumps()
    if attr:
        extra.update({k: str(v) for k, v in attr.items()})
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            extra[k] = str(v)
    # scope attrs apply under explicit ones (reference AttrScope.get)
    node._extra_attrs = AttrScope.current().get(extra)
    return Symbol([(node, 0)])


Variable = var


def Group(symbols) -> Symbol:
    """One multi-output Symbol of several (reference symbol.py:Group)."""
    if not symbols or any(not isinstance(s, Symbol) for s in symbols):
        raise TypeError("Expected a list of symbols as input")
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def load(fname) -> Symbol:
    """The Symbol of a ``*-symbol.json`` file (``mxnet_tpu/symbol.py:862``)."""
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    """Parse reference-format symbol JSON ('attrs', or the older 'attr'
    and 'param', merged in that order)."""
    js = json.loads(json_str)
    nodes: List[_Node] = []
    for nj in js["nodes"]:
        op = nj["op"]
        attrs = dict(nj.get("param") or {})
        attrs.update(nj.get("attr") or {})
        attrs.update(nj.get("attrs") or {})
        if op == "null":
            node = _Node(None, nj["name"], {}, [])
            node._extra_attrs = dict(attrs)
        else:
            if op not in OP_REGISTRY:
                raise MXNetError("symbol JSON references op %r, which is "
                                 "not ported yet" % op)
            inputs = [(nodes[i], idx) for i, idx, *_ in nj.get("inputs", [])]
            params = get_op(op).params
            node = _Node(op, nj["name"], {k: v for k, v in attrs.items()
                                         if k in params}, inputs)
            node._extra_attrs = {k: v for k, v in attrs.items()
                                 if k not in params}
        nodes.append(node)
    return Symbol([(nodes[i], idx) for i, idx, *_ in js["heads"]])


# generated op wrappers: sym.Convolution(...), sym.Activation(...), ...
import sys as _sys  # noqa: E402

_mod = _sys.modules[__name__]
for _opname in list(OP_REGISTRY):
    if not hasattr(_mod, _opname):
        setattr(_mod, _opname, _make_sym_op(_opname))

# the _contrib_* ops under their short names (mx.sym.contrib.MultiBoxPrior)
from . import sym_contrib as contrib  # noqa: E402,F401


def invoke(op_name, *sym_inputs, **kwargs):
    """The Symbol of op ``op_name`` over ``sym_inputs`` with ``kwargs`` as
    its attributes (``name=`` names the node): ``F.invoke`` of a block's
    ``hybrid_forward`` when ``F`` is this module."""
    name = kwargs.pop("name", None)
    return _invoke(op_name, list(sym_inputs), kwargs, name=name)


def zeros(shape, dtype=None, **kwargs):
    return _invoke("_zeros", [], {"shape": shape}, name=kwargs.get("name"))


def ones(shape, dtype=None, **kwargs):
    return _invoke("_ones", [], {"shape": shape}, name=kwargs.get("name"))


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, **kwargs):
    return _invoke("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "repeat": repeat},
                   name=kwargs.get("name"))


def eye(N, M=0, k=0, dtype=None, **kwargs):
    attrs = dict(N=N, M=M or N, k=k, **kwargs)
    if dtype is not None:
        attrs["dtype"] = dtype
    return _invoke("_eye", [], attrs)


def full(shape, val, dtype=None, **kwargs):
    attrs = dict(shape=shape, value=float(val), **kwargs)
    if dtype is not None:
        attrs["dtype"] = dtype
    return _invoke("_full", [], attrs)


def _sym_binop(broadcast_op, scalar_op):
    def fn(left, right, **kwargs):
        if isinstance(left, Symbol) and isinstance(right, Symbol):
            return _invoke(broadcast_op, [left, right], kwargs)
        if isinstance(left, Symbol):
            return _invoke(scalar_op, [left],
                           dict(scalar=float(right), **kwargs))
        if isinstance(right, Symbol):
            return _invoke(scalar_op, [right],
                           dict(scalar=float(left), **kwargs))
        raise TypeError("at least one argument must be a Symbol")
    return fn


maximum = _sym_binop("broadcast_maximum", "_maximum_scalar")
minimum = _sym_binop("broadcast_minimum", "_minimum_scalar")
hypot = _sym_binop("broadcast_hypot", "_hypot_scalar")


def histogram(a, bins=10, range=None, **kwargs):
    """Counts of ``a`` in ``bins`` equal bins over ``range``, which a
    graph needs given (its edges are a constant subgraph)."""
    if range is None:
        raise MXNetError("symbol histogram requires an explicit range "
                         "(shapes must be static in a graph)")
    lo, hi = float(range[0]), float(range[1])
    edges = _invoke("_arange", [], dict(start=0.0, stop=float(bins + 1),
                                        step=1.0)) * ((hi - lo) / bins) + lo
    return _invoke("_histogram", [a, edges], dict(bin_cnt=bins, **kwargs))
