"""The port's ``ops/tensor.py`` against the JAX package's, name by name
(CPU).

The sweep runs every case of ``torch_op_cases`` through both packages
(``torch_op_sweep``: float32 with gradients, int32 where the JAX op takes
it); this file holds the unary cases, and the ``test_torch_tensor_ops_*``
files the other groups. Every name that no case runs (an alias such as
``_Plus``) runs its op's first case under that name. Then the registry
gap: which JAX op names the port still lacks, grouped by the JAX file
that registers them, pinned exactly (none since slice 23).
"""
import collections
import inspect

import pytest

from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_cases import CASES, group, int_group
from torch_op_sweep import check, check_case

# the JAX file of each op name: the module that defines its fcompute
_JAX_FILE = {n: inspect.getmodule(o.fcompute).__name__.rsplit(".", 1)[-1]
             for n, o in JAX_REGISTRY.items()}
TENSOR_NAMES = sorted(n for n, f in _JAX_FILE.items() if f == "tensor")


@pytest.mark.parametrize("case", group("unary"))
def test_op_matches_jax_in_float32(case):
    check_case(case, "float32")


@pytest.mark.parametrize("case", int_group("unary"))
def test_op_matches_jax_in_int32(case):
    check_case(case, "int32")


def _canonical(name):
    """The first case whose op is ``name``'s OpDef in the port."""
    target = OP_REGISTRY[name]
    for key in sorted(CASES):
        if OP_REGISTRY[CASES[key][0]] is target:
            return CASES[key]
    raise AssertionError("no case runs the op behind %r" % name)


_CASE_OPS = {v[0] for v in CASES.values()}
_ALIASES = [n for n in TENSOR_NAMES if n not in _CASE_OPS]


@pytest.mark.parametrize("name", _ALIASES)
def test_every_other_name_runs_its_op(name):
    op, specs, attrs, flags = _canonical(name)
    check(name, specs, attrs, flags, "float32")


def test_sweep_covers_every_tensor_name():
    assert len(TENSOR_NAMES) == 227
    missing = [n for n in TENSOR_NAMES if n not in OP_REGISTRY]
    assert missing == []
    assert set(TENSOR_NAMES) <= _CASE_OPS | set(_ALIASES)
    # the aliases share their op's OpDef, as in the JAX package
    for n in TENSOR_NAMES:
        jax_twins = [m for m in TENSOR_NAMES
                     if JAX_REGISTRY[m] is JAX_REGISTRY[n]]
        assert all(OP_REGISTRY[m] is OP_REGISTRY[n] for m in jax_twins), n


# what later items of the port take, by JAX file: nothing since slice 23
# (vision, detection and quantization), so every name of the JAX registry
# has its counterpart
STILL_MISSING = {}


def test_registry_gap_is_exactly_the_later_items():
    gap = collections.defaultdict(list)
    for name, f in _JAX_FILE.items():
        if name not in OP_REGISTRY:
            gap[f].append(name)
    assert {f: sorted(v) for f, v in gap.items()} == STILL_MISSING
    for name in ("RNN", "_rnn_param_concat", "SequenceMask",
                 "SequenceLast", "SequenceReverse"):
        assert name in OP_REGISTRY
    assert not [n for n, f in _JAX_FILE.items()
                if f == "random_ops" and n not in OP_REGISTRY]
    for f in ("linalg", "misc_tail", "sparse",  # slice 18
              "control_flow", "subgraph",  # slice 20
              "vision", "detection", "quantization"):  # slice 23
        assert not [n for n, g in _JAX_FILE.items()
                    if g == f and n not in OP_REGISTRY]
    assert sum(map(len, STILL_MISSING.values())) == 0
    assert set(JAX_REGISTRY) <= set(OP_REGISTRY)
