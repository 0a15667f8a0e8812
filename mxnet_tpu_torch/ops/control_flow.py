"""Control-flow operators: the port of ``mxnet_tpu/ops/control_flow.py``
(reference ``_foreach``, src/operator/control_flow.cc:35-73; ``_while_loop``
and ``_cond``, src/operator/subgraph_op_common.cc).

Each op holds its subgraphs in its attrs as Symbols (nested graph JSON in
a symbol file, parsed back here); its positional inputs bind to the
subgraphs' variables through the ``*_names`` attrs. Where the JAX package
lowers each op to one XLA construct, the port runs the subgraphs through
``Symbol.eval_torch`` in a Python loop and torch autograd gives the
gradients:

* ``_foreach`` evaluates the subgraph once a step over axis 0 of its data
  inputs and stacks the step outputs (``lax.scan``'s result:
  ``stacked outputs + final states``); ``remat=True`` checkpoints each
  step (``torch.utils.checkpoint``, non-reentrant): its internals are
  recomputed in the backward, in the forward's train mode;
* ``_while_loop`` runs ``max_iterations`` steps whatever the data, with
  predicated updates (``torch.where`` on the live flag), so nothing is
  read back to the host and a CUDA graph can hold the loop; output rows
  past the last live step are zero, as in the JAX package;
* ``_cond`` is described at :func:`_cond`.
"""
from __future__ import annotations

import functools

import torch

from ..base import MXNetError
from .registry import REQUIRED, register


@functools.lru_cache(maxsize=256)
def _load_subgraph(js):
    from ..symbol import load_json

    return load_json(js)


def _subgraph(v):
    """A subgraph attr: a Symbol, or its graph JSON (parsed once a
    string: evaluation never changes a Symbol, so nodes share it)."""
    return _load_subgraph(v) if isinstance(v, str) else v


def _names(v):
    """A name-list attr: a tuple, or ``a,b`` (``()`` when empty)."""
    if isinstance(v, str):
        v = v.strip().lstrip("(").rstrip(")")
        return tuple(x for x in (p.strip() for p in v.split(",")) if x)
    return tuple(v)


def _scalar_bool(x):
    return x.reshape(()).bool()


def _device(inputs):
    """Where a subgraph's nullary ops (``_zeros``) make their outputs:
    the op's inputs' device (None without an input: the current
    context)."""
    return inputs[0].device if inputs else None


# -- _foreach -----------------------------------------------------------------


def _foreach_inputs(attrs):
    return (list(attrs["data_names"]) + list(attrs["state_names"])
            + list(attrs["free_names"]))


@register(
    "_foreach",
    params={
        "__subgraph__": (_subgraph, REQUIRED),
        "data_names": (_names, REQUIRED),
        "state_names": (_names, REQUIRED),
        "free_names": (_names, ()),
        "num_out_data": (int, REQUIRED),
        "remat": (bool, False),
    },
    inputs=_foreach_inputs,
    num_outputs=lambda a: a["num_out_data"] + len(a["state_names"]),
)
def _foreach(attrs, *inputs):
    """Evaluate the subgraph over axis 0 of each data input; its outputs
    are ``[step outputs..., new states...]``. Returns the step outputs
    stacked on a new axis 0, then the final states."""
    from ..parallel import _remat_contexts

    sub = attrs["__subgraph__"]
    dn, sn, fn = attrs["data_names"], attrs["state_names"], \
        attrs["free_names"]
    n_data, n_state, nod = len(dn), len(sn), attrs["num_out_data"]
    data = inputs[:n_data]
    states = tuple(inputs[n_data:n_data + n_state])
    free = dict(zip(fn, inputs[n_data + n_state:]))
    if not data:
        raise MXNetError("_foreach: needs at least one data input")
    steps = data[0].shape[0]

    dev = _device(data)

    def step(*flat):
        vm = dict(zip(sn, flat[:n_state]))
        vm.update(zip(dn, flat[n_state:]))
        vm.update(free)
        return tuple(sub.eval_torch(vm, device=dev))

    # the recompute records in the forward's train mode (TrainStep's)
    remat = attrs.get("remat") and torch.is_grad_enabled()
    stacked = [[] for _ in range(nod)]
    for t in range(steps):
        args = states + tuple(d[t] for d in data)
        if remat:
            outs = torch.utils.checkpoint.checkpoint(
                step, *args, use_reentrant=False, preserve_rng_state=False,
                context_fn=_remat_contexts)
        else:
            outs = step(*args)
        for col, o in zip(stacked, outs[:nod]):
            col.append(o)
        states = tuple(outs[nod:])
    return tuple(torch.stack(col) for col in stacked) + states


# -- _while_loop --------------------------------------------------------------


def _while_inputs(attrs):
    return list(attrs["loop_var_names"]) + list(attrs["free_names"])


@register(
    "_while_loop",
    params={
        "__cond__": (_subgraph, REQUIRED),
        "__func__": (_subgraph, REQUIRED),
        "loop_var_names": (_names, REQUIRED),
        "free_names": (_names, ()),
        "num_out_data": (int, REQUIRED),
        "max_iterations": (int, REQUIRED),
    },
    inputs=_while_inputs,
    num_outputs=lambda a: a["num_out_data"] + len(a["loop_var_names"]),
)
def _while_loop(attrs, *inputs):
    """Run the func subgraph while the cond subgraph is true, at most
    ``max_iterations`` times. Both subgraphs run every iteration and the
    live flag selects their results: the step outputs are stacked into
    buffers of leading size ``max_iterations`` (zero past the last live
    step), the final loop variables follow."""
    cond_g, func_g = attrs["__cond__"], attrs["__func__"]
    vn, fn = attrs["loop_var_names"], attrs["free_names"]
    nv, nod = len(vn), attrs["num_out_data"]
    cur = tuple(inputs[:nv])
    free = dict(zip(fn, inputs[nv:]))
    dev = _device(inputs)
    active = None
    stacked = [[] for _ in range(nod)]
    for _ in range(attrs["max_iterations"]):
        vm = dict(zip(vn, cur))
        vm.update(free)
        live = _scalar_bool(cond_g.eval_torch(vm, device=dev)[0])
        active = live if active is None else torch.logical_and(active, live)
        outs = func_g.eval_torch(vm, device=dev)
        for col, o in zip(stacked, outs[:nod]):
            col.append(torch.where(active, o, torch.zeros_like(o)))
        cur = tuple(torch.where(active, n, v)
                    for n, v in zip(outs[nod:], cur))
    return tuple(torch.stack(col) for col in stacked) + cur


# -- _cond --------------------------------------------------------------------


def _cond_inputs(attrs):
    return list(attrs["input_names"])


class _Branches(torch.autograd.Function):
    """Both branches of a ``_cond``, their outputs selected by ``pred``
    (a 0-d bool tensor on the device): the values and the gradients of
    ``lax.cond``'s taken branch, read back by no one.

    Each branch runs on leaves of its own, so its graph stays apart from
    the caller's; the backward takes each branch's own vector-Jacobian
    product (``torch.autograd.grad``, seeded with the output gradients)
    and selects between the two products by ``pred``. A non-finite value
    or gradient of the untaken branch is dropped by that selection,
    where ``torch.where`` over the outputs would multiply it by a zero
    cotangent (``0 * inf`` is NaN)."""

    @staticmethod
    def forward(ctx, pred, then_g, else_g, names, *inputs):
        grads = [ctx.needs_input_grad[4 + i] for i in range(len(inputs))]
        dev = _device(inputs)
        with torch.enable_grad() if any(grads) else torch.no_grad():
            leaves = [x.detach().requires_grad_(g) for x, g in
                      zip(inputs, grads)]
            vm = dict(zip(names, leaves))
            then_outs = then_g.eval_torch(vm, device=dev)
            else_outs = else_g.eval_torch(vm, device=dev)
        ctx.branches = (leaves, then_outs, else_outs) if any(grads) \
            else None
        ctx.save_for_backward(pred)
        return tuple(torch.where(pred, a, b).detach()
                     for a, b in zip(then_outs, else_outs))

    @staticmethod
    def backward(ctx, *cts):
        (pred,) = ctx.saved_tensors
        leaves, then_outs, else_outs = ctx.branches
        ctx.branches = None
        wanted = [x for x in leaves if x.requires_grad]

        def vjp(outs):
            pairs = [(o, c) for o, c in zip(outs, cts)
                     if o.requires_grad and c is not None]
            if not pairs:
                return [torch.zeros_like(x) for x in wanted]
            return torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [c for _, c in pairs],
                                       allow_unused=True,
                                       materialize_grads=True)

        picked = iter([torch.where(pred, a, b) for a, b in
                       zip(vjp(then_outs), vjp(else_outs))])
        return (None, None, None, None) + tuple(
            next(picked) if x.requires_grad else None for x in leaves)


@register(
    "_cond",
    params={
        "__pred__": (_subgraph, REQUIRED),
        "__then__": (_subgraph, REQUIRED),
        "__else__": (_subgraph, REQUIRED),
        "input_names": (_names, REQUIRED),
        "num_out": (int, REQUIRED),
    },
    inputs=_cond_inputs,
    num_outputs=lambda a: a["num_out"],
)
def _cond(attrs, *inputs):
    """Branch between the then/else subgraphs on the pred subgraph's
    scalar output; both must give the same shapes and dtypes (the
    reference's contract).

    The design: the predicate stays on the device and both branches run
    (:class:`_Branches`), so no value is read back to the host and a
    module plane can capture the graph; the cost is the untaken branch's
    work, forward and backward. The values and gradients are
    ``lax.cond``'s, an untaken branch's non-finite values included.
    (The eager ``nd.contrib.cond`` reads the predicate on the host and
    runs one branch, as the JAX package's does.)"""
    names = attrs["input_names"]
    with torch.no_grad():
        pred = _scalar_bool(attrs["__pred__"].eval_torch(
            dict(zip(names, inputs)), device=_device(inputs))[0])
    return _Branches.apply(pred, attrs["__then__"], attrs["__else__"],
                           names, *inputs)
