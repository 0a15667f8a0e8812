"""The port's ``ops/vision.py`` and the rest of ``ops/detection.py``
against the JAX package's, name by name (CPU).

Every case of ``torch_vision_cases``' vision and detection groups (crop,
adaptive pooling, fft, count sketch, the KL regulariser, bipartite
matching) runs through both packages (``torch_op_sweep``: forward and
gradients, ``rtol=atol=2e-5`` in float32), and each alias runs its op's
first case under its own name; the other groups have files of their own
(``test_torch_vision_{sampling,roi,align,deform_conv,deform_psroi}.py``,
``test_torch_proposal.py``).
Then the coverage: every name the JAX package's ``vision.py`` and
``detection.py`` register is in the port, shares its OpDef with the same
names as in JAX, has the JAX op's params and their defaults, and each of
the slice's names is run by a case or an alias under the JAX op's input
names. Last, the RoI, Proposal and quantization ops divide by no Python
number (a CUDA kernel would multiply by its reciprocal instead).
"""
import inspect

import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import OP_REGISTRY as JAX_REGISTRY
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from torch_op_cases import make_inputs
from torch_op_sweep import check
from torch_vision_cases import ALIASES, VISION_CASES, canonical, group

_JAX_FILE = {n: inspect.getmodule(o.fcompute).__name__.rsplit(".", 1)[-1]
             for n, o in JAX_REGISTRY.items()}


@pytest.mark.parametrize("case", group("vision") + group("detection"))
def test_vision_op_matches_jax(case):
    check(*VISION_CASES[case], "float32")


@pytest.mark.parametrize("name", ALIASES["vision"])
def test_vision_alias_runs_its_op(name):
    op, specs, attrs, flags = canonical(name, OP_REGISTRY)
    assert OP_REGISTRY[name] is OP_REGISTRY[op]
    assert JAX_REGISTRY[name] is JAX_REGISTRY[op]
    check(name, specs, attrs, flags, "float32")


_SLICE_OPS = {"sampling", "vision", "roi", "align", "deform_conv",
              "deform_psroi", "proposal", "detection"}


@pytest.mark.parametrize("jax_file,count", [("vision", 25),
                                            ("detection", 10)])
def test_every_name_of_the_file_is_ported_and_run(jax_file, count):
    names = sorted(n for n, f in _JAX_FILE.items() if f == jax_file)
    assert len(names) == count
    assert [n for n in names if n not in OP_REGISTRY] == []
    cases = [v for v in VISION_CASES.values()
             if v[3]["group"] in _SLICE_OPS]
    run = {v[0] for v in cases} | {
        n for g in _SLICE_OPS for n in ALIASES[g]}
    if jax_file == "vision":
        assert set(names) <= run
    else:
        assert {"ROIAlign", "_contrib_ROIAlign",
                "_contrib_bipartite_matching"} <= run
    for n in names:
        twins = [m for m in names if JAX_REGISTRY[m] is JAX_REGISTRY[n]]
        assert all(OP_REGISTRY[m] is OP_REGISTRY[n] for m in twins), n
        jp, tp = JAX_REGISTRY[n].params, OP_REGISTRY[n].params
        assert list(tp) == list(jp), n
        assert all(tp[k][1] == jp[k][1] for k in jp
                   if jp[k][1] is not JAX_REGISTRY[n].REQUIRED), n
    for op, _, attrs, _ in cases:
        jop, top = JAX_REGISTRY[op], OP_REGISTRY[op]
        assert top.input_names(top.parse_attrs(attrs)) == \
            jop.input_names(jop.parse_attrs(attrs)), op
        assert top.num_outputs(top.parse_attrs(attrs)) == \
            jop.num_outputs(jop.parse_attrs(attrs)), op


class _ScalarDivisions(torch.overrides.TorchFunctionMode):
    """Records each division of a tensor by a Python number."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__truediv__, torch.Tensor.div,
                    torch.div, torch.true_divide) and len(args) > 1 \
                and isinstance(args[1], (int, float)):
            self.seen.append(args[1])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", group("roi") + group("align")
                         + group("deform_psroi") + group("proposal")
                         + group("quantization"))
def test_bin_and_scale_arithmetic_divides_by_no_python_number(case):
    # on the card a division by a Python number is a multiply by its
    # reciprocal, which moved ROIPooling's bin edges off the CPU's (and
    # JAX's): the RoI, Proposal and quantization ops divide by tensors
    op, specs, attrs, _ = VISION_CASES[case]
    inputs = make_inputs(specs, "float32", seed=11)
    with mx.cpu():
        arrs = [mx.nd.array(a, dtype=a.dtype) for a in inputs]
        with _ScalarDivisions() as mode:
            mx.nd.invoke(op, *arrs, **attrs)
    assert mode.seen == []
