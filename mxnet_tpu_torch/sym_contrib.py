"""``mx.sym.contrib``: symbolic control flow (``foreach``, ``while_loop``,
``cond``) and every registered ``_contrib_*`` op under its short name
(``sym.contrib.MultiBoxPrior``, ...), the port of
``mxnet_tpu/sym_contrib.py`` (reference ``python/mxnet/symbol/contrib.py``).

The body, cond and func callables are called ONCE on fresh variables to
capture each subgraph as a Symbol, which the op node keeps in its attrs;
variables a subgraph uses that the op did not make (free variables: an
RNN's weights) become extra inputs of the op, bound by name. The ops run
through ``ops/control_flow.py``.
"""
from __future__ import annotations

from .base import MXNetError, flatten_list as _flatten, \
    regroup_list as _regroup
from .name import NameManager

__all__ = ["foreach", "while_loop", "cond"]


def _free_syms(sub, bound_names):
    """The free variables of a subgraph: its inputs (arguments and
    auxiliary states) less the loop's own variables, as Symbols over the
    same nodes, so the outer graph binds them (reference contrib.py
    ``_cut_subgraph``). A subgraph's auxiliary states are marked
    ``_forced_aux``, so the outer graph takes them as auxiliary states
    too (the op's input slots carry the subgraph's names). Moving
    statistics used inside a body are not updated by training, as in the
    JAX package."""
    from .symbol import Symbol

    nodes = {n.name: n for n in sub._topo_nodes() if n.is_var()}
    for n in sub.list_auxiliary_states():
        nodes[n]._forced_aux = True
    order = [n for n in sub.list_inputs() if n not in bound_names]
    return order, [Symbol([(nodes[n], 0)]) for n in order]


def _check_single_output(flat, what):
    for s in flat:
        if len(s._outputs) != 1:
            raise MXNetError(
                "%s contains a multi-output Symbol (e.g. split()); unpack "
                "it into a list of single-output Symbols first" % what)
    return flat


def foreach(body, data, init_states, name=None, remat=False):
    """Symbolic loop over axis 0 (reference symbol/contrib.py:foreach):
    ``out, states = body(data_slice, states)``. ``remat=True`` recomputes
    each step's internals in the backward instead of keeping them."""
    from . import symbol as sym_mod

    name = NameManager.current().get(name, "foreach")
    data_list, data_fmt = _flatten(data)
    states_list, state_fmt = _flatten(init_states)
    data_vars = [sym_mod.var("%s_in_data%d" % (name, i))
                 for i in range(len(data_list))]
    state_vars = [sym_mod.var("%s_in_state%d" % (name, i))
                  for i in range(len(states_list))]
    data_arg, _ = _regroup(data_vars, data_fmt)
    state_arg, _ = _regroup(state_vars, state_fmt)

    outs, out_states = body(data_arg, state_arg)
    flat_outs, out_fmt = _flatten(outs)
    flat_ostates, _ = _flatten(out_states)
    _check_single_output(flat_outs, "foreach body output")
    _check_single_output(flat_ostates, "foreach body states")
    if len(flat_ostates) != len(states_list):
        raise MXNetError("foreach: body must return as many states as "
                         "init_states (%d vs %d)"
                         % (len(flat_ostates), len(states_list)))

    sub = sym_mod.Group(list(flat_outs) + list(flat_ostates))
    dnames = tuple(v.name for v in data_vars)
    snames = tuple(v.name for v in state_vars)
    free_names, free_symbols = _free_syms(sub, set(dnames) | set(snames))
    res = sym_mod._invoke(
        "_foreach", list(data_list) + list(states_list) + free_symbols,
        {"__subgraph__": sub, "data_names": dnames, "state_names": snames,
         "free_names": tuple(free_names), "num_out_data": len(flat_outs),
         "remat": remat},
        name=name)
    nod = len(flat_outs)
    outputs, _ = _regroup([res[i] for i in range(nod)], out_fmt)
    states, _ = _regroup([res[nod + i] for i in range(len(states_list))],
                         state_fmt)
    return outputs, states


def while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """Symbolic bounded while (reference symbol/contrib.py:while_loop):
    ``step_out, new_vars = func(*loop_vars)`` while ``cond(*loop_vars)``,
    at most ``max_iterations`` times (required: shapes are static)."""
    from . import symbol as sym_mod

    if max_iterations is None:
        raise MXNetError("max_iterations should be specified")
    name = NameManager.current().get(name, "while_loop")
    vars_list, var_fmt = _flatten(loop_vars)
    if not vars_list:
        raise MXNetError("loop_vars should contain at least one element")
    var_vars = [sym_mod.var("%s_in_var%d" % (name, i))
                for i in range(len(vars_list))]
    cond_out = cond(*var_vars)
    step_out, new_vars = func(*var_vars)
    if step_out is None:
        step_out = []
    flat_outs, out_fmt = _flatten(step_out)
    flat_nvars, _ = _flatten(new_vars)
    _check_single_output(flat_outs, "while_loop step output")
    _check_single_output(flat_nvars, "while_loop loop_vars")
    if len(flat_nvars) != len(vars_list):
        raise MXNetError("while_loop: func must return as many loop_vars "
                         "as it was given")

    cond_g = sym_mod.Group([cond_out])
    func_g = sym_mod.Group(list(flat_outs) + list(flat_nvars))
    vnames = tuple(v.name for v in var_vars)
    free = {}
    for g in (cond_g, func_g):
        names, syms = _free_syms(g, set(vnames))
        free.update(zip(names, syms))
    free_names = tuple(free)
    res = sym_mod._invoke(
        "_while_loop", list(vars_list) + [free[n] for n in free_names],
        {"__cond__": cond_g, "__func__": func_g, "loop_var_names": vnames,
         "free_names": free_names, "num_out_data": len(flat_outs),
         "max_iterations": int(max_iterations)},
        name=name)
    nod = len(flat_outs)
    outputs, _ = _regroup([res[i] for i in range(nod)], out_fmt)
    states, _ = _regroup([res[nod + i] for i in range(len(vars_list))],
                         var_fmt)
    return outputs, states


def cond(pred, then_func, else_func, name=None):
    """Symbolic branch (reference symbol/contrib.py:cond): ``pred`` a
    scalar Symbol, then/else nullary callables capturing their inputs."""
    from . import symbol as sym_mod

    name = NameManager.current().get(name, "cond")
    flat_then, out_fmt = _flatten(then_func())
    flat_else, _ = _flatten(else_func())
    _check_single_output(flat_then, "cond then output")
    _check_single_output(flat_else, "cond else output")
    if len(flat_then) != len(flat_else):
        raise MXNetError("cond: then/else must produce the same number of "
                         "outputs")
    pred_g = sym_mod.Group([pred])
    then_g = sym_mod.Group(list(flat_then))
    else_g = sym_mod.Group(list(flat_else))
    free = {}
    for g in (pred_g, then_g, else_g):
        names, syms = _free_syms(g, set())
        free.update(zip(names, syms))
    input_names = tuple(free)
    res = sym_mod._invoke(
        "_cond", [free[n] for n in input_names],
        {"__pred__": pred_g, "__then__": then_g, "__else__": else_g,
         "input_names": input_names, "num_out": len(flat_then)},
        name=name)
    n = len(flat_then)
    outs = [res[i] for i in range(n)] if n > 1 else [res]
    outputs, _ = _regroup(outs, out_fmt)
    return outputs


def _export_contrib_ops():
    from . import symbol as sym_mod

    for flat in dir(sym_mod):
        if flat.startswith("_contrib_"):
            globals().setdefault(flat[len("_contrib_"):],
                                 getattr(sym_mod, flat))


_export_contrib_ops()
