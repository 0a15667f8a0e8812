"""Subgraph framework: partition a Symbol graph and replace groups of
nodes with fused subgraph ops, the port of ``mxnet_tpu/subgraph.py``
(reference ``src/operator/subgraph/subgraph_property.h:87-114``: a
``SubgraphSelector`` seeds and grows groups of nodes, a
``SubgraphProperty`` replaces each group with one op that runs the
captured subgraph; ``default_subgraph_op.cc``'s op-name-list property).

The fused node, ``_subgraph_op`` (alias ``_default_subgraph_op``), runs
its captured Symbol through ``Symbol.eval_torch`` on its inputs, so a
partitioned graph computes what the whole one does, gradients included;
the grouping marks a region (for quantization, a custom lowering, a
remat boundary).

Partitioning, as in the JAX package: a property is registered under a
backend name (:func:`register_subgraph_property`);
``partition_graph(sym, prop)`` returns a new Symbol with every maximal
*convex* group of selected nodes collapsed into one ``_subgraph_op`` node
(a group that a path between two members leaves is split, like the
reference's cycle check); the captured subgraph round-trips through graph
JSON like the control-flow ops'.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .base import MXNetError
from .ops.control_flow import _subgraph as _parse_subgraph
from .ops.registry import OP_REGISTRY, REQUIRED, register
from .symbol import Symbol, _Node, var as sym_var

__all__ = [
    "SubgraphSelector", "SubgraphProperty", "DefaultSubgraphProperty",
    "register_subgraph_property", "get_subgraph_property", "partition_graph",
]


class SubgraphSelector(object):
    """Decides which nodes join a subgraph (reference SubgraphSelector,
    subgraph_property.h:40-85)."""

    def select(self, node) -> bool:
        """Seed: may this node start/join a subgraph?"""
        return False

    def select_input(self, node, input_node) -> bool:
        """Grow across the edge input_node → node (both already selected)."""
        return self.select(input_node)

    def select_output(self, node, output_node) -> bool:
        """Grow across the edge node → output_node."""
        return self.select(output_node)


class _OpNameSelector(SubgraphSelector):
    def __init__(self, op_names):
        self.op_names = frozenset(op_names)

    def select(self, node) -> bool:
        return node.op in self.op_names


class SubgraphProperty(object):
    """A partitioning policy (reference SubgraphProperty,
    subgraph_property.h:87)."""

    #: counter so every fused node gets a stable unique name
    _counter = 0

    def create_selector(self) -> SubgraphSelector:
        raise NotImplementedError

    def create_subgraph_node(self, subgraph_sym: Symbol, subgraph_id: int,
                             inputs: List[Tuple[_Node, int]]) -> _Node:
        """Build the replacement node. Default: a ``_subgraph_op`` node
        executing the captured Symbol (reference default_subgraph_op.cc)."""
        return _Node(
            "_subgraph_op",
            "subgraph%d" % subgraph_id,
            {
                "__subgraph__": subgraph_sym,
                "num_args": len(inputs),
                "num_outputs": len(subgraph_sym.list_outputs()),
            },
            list(inputs),
        )


class DefaultSubgraphProperty(SubgraphProperty):
    """Group maximal connected regions of whitelisted ops
    (reference ``mxnet.symbol.contrib._set_subgraph_backend`` default path)."""

    def __init__(self, op_names: Sequence[str]):
        self.op_names = tuple(op_names)

    def create_selector(self) -> SubgraphSelector:
        return _OpNameSelector(self.op_names)


_PROPERTIES: Dict[str, SubgraphProperty] = {}


def register_subgraph_property(name: str, prop: SubgraphProperty) -> None:
    """Register a backend partitioning property (reference
    MXNET_REGISTER_SUBGRAPH_PROPERTY)."""
    _PROPERTIES[name] = prop


def get_subgraph_property(name: str) -> SubgraphProperty:
    if name not in _PROPERTIES:
        raise MXNetError("unknown subgraph backend %r (registered: %s)"
                         % (name, sorted(_PROPERTIES)))
    return _PROPERTIES[name]


# ---------------------------------------------------------------------------
# the fused op
# ---------------------------------------------------------------------------


def _sg_inputs(attrs):
    n = int(attrs.get("num_args", 1))  # hoisted out of the comprehension
    return ["arg%d" % i for i in range(n)]


def _sg_outputs(attrs):
    return int(attrs.get("num_outputs", 1))


@register(
    "_subgraph_op",
    params={
        "__subgraph__": (_parse_subgraph, REQUIRED),
        "num_args": (int, 1),
        "num_outputs": (int, 1),
    },
    inputs=_sg_inputs,
    num_outputs=_sg_outputs,
)
def _subgraph_op(attrs, *inputs):
    """Run a captured subgraph (reference default_subgraph_op.cc:
    InvokeOperator over the inner graph) through ``eval_torch``, under
    the caller's autograd mode: its gradients are the inner ops'."""
    sub = attrs["__subgraph__"]
    names = sub.list_inputs()
    if len(names) != len(inputs):
        raise MXNetError("_subgraph_op: %d inputs for %d subgraph variables"
                         % (len(inputs), len(names)))
    # variables are named by position (arg0..argN) at capture time, so bind
    # positionally by name — list_inputs() topo order need not match
    vals = {"arg%d" % i: x for i, x in enumerate(inputs)}
    missing = set(names) - set(vals)
    if missing:
        raise MXNetError("_subgraph_op: unbound subgraph variables %s"
                         % sorted(missing))
    outs = sub.eval_torch(vals,
                          device=inputs[0].device if inputs else None)
    return tuple(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# partitioning pass
# ---------------------------------------------------------------------------


def partition_graph(sym: Symbol, prop) -> Symbol:
    """Return a new Symbol with selected node groups fused
    (reference ``BuildSubgraph`` pass,
    src/operator/subgraph/build_subgraph.cc).

    ``prop`` is a SubgraphProperty, a registered backend name, or a list of
    op names (sugar for DefaultSubgraphProperty).
    """
    if isinstance(prop, str):
        prop = get_subgraph_property(prop)
    elif isinstance(prop, (list, tuple, set, frozenset)):
        prop = DefaultSubgraphProperty(prop)
    selector = prop.create_selector()

    topo = sym._topo_nodes()
    topo_idx = {id(n): i for i, n in enumerate(topo)}
    selected = [n for n in topo if not n.is_var() and selector.select(n)]
    sel_ids = {id(n) for n in selected}

    # union-find over approved edges between selected nodes
    parent: Dict[int, int] = {id(n): id(n) for n in selected}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for n in selected:
        for src, _ in n.inputs:
            if id(src) in sel_ids and selector.select_input(n, src) \
                    and selector.select_output(src, n):
                union(id(n), id(src))

    groups: Dict[int, List[_Node]] = {}
    for n in selected:
        groups.setdefault(find(id(n)), []).append(n)
    # deterministic order; singletons are kept (a 1-op subgraph is still a
    # marked region, e.g. for quantization)
    comps = [sorted(g, key=lambda n: topo_idx[id(n)]) for g in groups.values()]
    comps.sort(key=lambda g: topo_idx[id(g[0])])

    # convexity: walking in topo order, a node outside the group that is a
    # descendant of the group AND an ancestor of a group member would create
    # a cycle after fusion. Split such groups at the offending member.
    kept: List[List[_Node]] = []
    for comp in comps:
        comp_ids = {id(n) for n in comp}
        desc: set = set()  # ids of outside nodes downstream of the group
        good: List[_Node] = []
        lo, hi = topo_idx[id(comp[0])], topo_idx[id(comp[-1])]
        for i in range(lo, hi + 1):
            n = topo[i]
            in_comp = id(n) in comp_ids
            feeds_from_desc = any(id(s) in desc for s, _ in n.inputs)
            from_comp = any(id(s) in comp_ids for s, _ in n.inputs)
            if in_comp:
                if feeds_from_desc:
                    # fusing would swallow a path that leaves the group:
                    # split — this member (and later ones) form their own
                    # groups
                    kept.extend([m] for m in comp[comp.index(n):])
                    comp_ids = {id(m) for m in good}
                    break
                good.append(n)
            elif from_comp or feeds_from_desc:
                desc.add(id(n))
        if good:
            kept.append(good)

    if not kept:
        return sym

    member_group: Dict[int, int] = {}
    for gi, comp in enumerate(kept):
        for n in comp:
            member_group[id(n)] = gi
    group_last = {gi: max(topo_idx[id(n)] for n in comp)
                  for gi, comp in enumerate(kept)}

    # rebuild the graph
    new_of: Dict[Tuple[int, int], Tuple[_Node, int]] = {}

    def remap(src, idx):
        return new_of[(id(src), idx)]

    for i, n in enumerate(topo):
        gi = member_group.get(id(n))
        if gi is None:
            clone = _Node(n.op, n.name, dict(n.attrs),
                          [remap(s, k) for s, k in n.inputs])
            clone._extra_attrs = dict(n._extra_attrs)
            for k in range(n.num_outputs() if not n.is_var() else 1):
                new_of[(id(n), k)] = (clone, k)
            continue
        if i != group_last[gi]:
            continue  # group materializes at its last member
        comp = kept[gi]
        comp_ids = {id(m) for m in comp}
        # external inputs in first-use order
        ext: List[Tuple[_Node, int]] = []
        ext_pos: Dict[Tuple[int, int], int] = {}
        for m in comp:
            for s, k in m.inputs:
                if id(s) not in comp_ids and (id(s), k) not in ext_pos:
                    ext_pos[(id(s), k)] = len(ext)
                    ext.append((s, k))
        # build the captured Symbol over fresh variables
        sub_vars = [sym_var("arg%d" % j) for j in range(len(ext))]
        sub_of: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
        for (sid, k), j in ext_pos.items():
            sub_of[(sid, k)] = (sub_vars[j]._outputs[0][0], 0)
        for m in comp:
            c = _Node(m.op, m.name, dict(m.attrs),
                      [sub_of[(id(s), k)] for s, k in m.inputs])
            c._extra_attrs = dict(m._extra_attrs)
            for k in range(m.num_outputs()):
                sub_of[(id(m), k)] = (c, k)
        # outputs: member outputs consumed outside the group or by sym heads
        out_pairs: List[Tuple[int, int]] = []
        consumed: set = set()
        for n2 in topo:
            if id(n2) in comp_ids:
                continue
            for s, k in n2.inputs:
                if id(s) in comp_ids:
                    consumed.add((id(s), k))
        for s, k in sym._outputs:
            if id(s) in comp_ids:
                consumed.add((id(s), k))
        for m in comp:
            for k in range(m.num_outputs()):
                if (id(m), k) in consumed:
                    out_pairs.append((id(m), k))
        if not out_pairs:  # dead group: keep last member's first output
            out_pairs = [(id(comp[-1]), 0)]
        sub_sym = Symbol([sub_of[p] for p in out_pairs])
        SubgraphProperty._counter += 1
        fused = prop.create_subgraph_node(
            sub_sym, SubgraphProperty._counter,
            [remap(s, k) for (s, k) in ext])
        for j, p in enumerate(out_pairs):
            new_of[p] = (fused, j)

    return Symbol([new_of[(id(s), k)] for s, k in sym._outputs])


# the reference's default_subgraph_op.cc registers the same executor under
# this name; the alias keeps its symbol JSON loadable
OP_REGISTRY.setdefault("_default_subgraph_op", OP_REGISTRY["_subgraph_op"])
