"""Operator registry: the port of ``mxnet_tpu/ops/registry.py``.

Every op registers

* an ``fcompute(attrs, *inputs) -> tensor | tuple`` written with PyTorch
  on ``torch.Tensor``s;
* a typed parameter spec, so string attrs parse as in the JAX package;
* its input names.

Gradients are not registered per op: :func:`mxnet_tpu_torch.ndarray.invoke`
runs ``fcompute`` with torch autograd on while ``autograd.record()`` is
active, and torch differentiates through it (the JAX package runs
``jax.vjp`` over the same ``fcompute`` instead). An op whose backward is
not the autodiff of its forward (``_contrib_flash_attention``) wraps its
``fcompute`` in a ``torch.autograd.Function`` itself.

An op may also carry an ``fcompute_ex`` (:func:`register_ex`), the
storage-type path that :func:`mxnet_tpu_torch.ndarray.invoke` takes when
an input is sparse (``ops/sparse.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, dtype_name, parser_for

__all__ = ["OpDef", "register", "register_ex", "get_op", "list_ops",
           "AttrDict", "OP_REGISTRY", "REQUIRED"]

OP_REGISTRY: Dict[str, "OpDef"] = {}


class AttrDict(dict):
    """Parsed op attributes with attribute access (``attrs.axis``)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


class OpDef:
    """One registered operator.

    ``params`` maps attr name -> (type, default); type is bool/int/float/
    tuple/str/'dtype' or a callable parser, default :data:`REQUIRED` marks
    a mandatory attr. ``inputs`` is a list of input names or a
    callable(attrs) -> list; ``num_outputs`` an int or callable(attrs).
    """

    REQUIRED = object()

    def __init__(self, name: str, fcompute: Callable,
                 params: Optional[Dict[str, Tuple[Any, Any]]] = None,
                 inputs: Any = ("data",), num_outputs: Any = 1,
                 aliases: Sequence[str] = (), doc: str = ""):
        self.name = name
        self.fcompute = fcompute
        self.params = params or {}
        self._inputs = inputs
        self._num_outputs = num_outputs
        self.aliases = tuple(aliases)
        self.doc = doc
        # the storage-type path (register_ex)
        self.fcompute_ex: Optional[Callable] = None
        self.dispatch_ex_always = False
        self.ex_differentiable = False
        self.ex_grad_fallback = False

    def input_names(self, attrs: Optional[AttrDict] = None) -> List[str]:
        if callable(self._inputs):
            return list(self._inputs(attrs or self.parse_attrs({})))
        return list(self._inputs)

    def num_outputs(self, attrs: Optional[AttrDict] = None) -> int:
        if callable(self._num_outputs):
            return int(self._num_outputs(attrs or self.parse_attrs({})))
        return int(self._num_outputs)

    def parse_attrs(self, raw: Dict[str, Any]) -> AttrDict:
        """Typed attrs from raw (possibly string-valued) ones, with
        defaults applied and required fields checked. Unknown attrs are
        kept verbatim, as in the JAX package."""
        out = AttrDict()
        for pname, (ptype, pdefault) in self.params.items():
            if pname in raw:
                v = raw[pname]
                if v is None or (isinstance(v, str) and v == "None"):
                    if pdefault is OpDef.REQUIRED:
                        raise MXNetError("op %s: required attribute %r is "
                                         "None" % (self.name, pname))
                    out[pname] = pdefault
                elif isinstance(v, str) or ptype in (bool, int, float, tuple) \
                        or isinstance(ptype, str):
                    out[pname] = parser_for(ptype)(v)
                else:
                    out[pname] = v
            elif pdefault is OpDef.REQUIRED:
                raise MXNetError("op %s: required attribute %r missing"
                                 % (self.name, pname))
            else:
                out[pname] = pdefault
        for k, v in raw.items():
            if k not in out and not k.startswith("__"):
                out[k] = v
        return out

    def serialize_attrs(self, attrs: Dict[str, Any]) -> Dict[str, str]:
        """Declared attrs as strings for MXNet-format symbol JSON, as the
        JAX package writes them (``mxnet_tpu/ops/registry.py:162-185``):
        a subgraph (a Symbol, of the control-flow and subgraph ops) as
        its nested graph JSON, a tuple of names as ``a,b``, tuples of
        numbers as ``(a, b)`` with integral values printed as ints, an
        unset optional attr left out. The op's parser reads each back."""
        out = {}
        for k, v in attrs.items():
            if k not in self.params:
                continue
            ptype, pdefault = self.params[k]
            if v is None and pdefault is None:
                continue
            if ptype == "dtype" and v is not None:
                out[k] = dtype_name(v)
            elif hasattr(v, "tojson"):
                out[k] = v.tojson()
            elif isinstance(v, (tuple, list)) and v \
                    and all(isinstance(x, str) for x in v):
                out[k] = ",".join(v)
            elif isinstance(v, (tuple, list)):
                out[k] = "(" + ", ".join(
                    str(int(x)) if float(x).is_integer() else repr(float(x))
                    for x in v) + ")"
            else:
                out[k] = str(v)
        return out

    def __repr__(self):
        return "OpDef(%s)" % self.name


REQUIRED = OpDef.REQUIRED


def register(name: str, params: Optional[Dict[str, Tuple[Any, Any]]] = None,
             inputs: Any = ("data",), num_outputs: Any = 1,
             aliases: Sequence[str] = ()):
    """Decorator registering ``fcompute`` under ``name`` (+ aliases)."""

    def deco(fn: Callable) -> Callable:
        if name in OP_REGISTRY:
            raise MXNetError("op %r registered twice" % name)
        opdef = OpDef(name, fn, params=params, inputs=inputs,
                      num_outputs=num_outputs, aliases=aliases,
                      doc=fn.__doc__ or "")
        OP_REGISTRY[name] = opdef
        for a in aliases:
            OP_REGISTRY.setdefault(a, opdef)
        return fn

    return deco


def register_ex(name: str, always: bool = False, differentiable: bool = False,
                grad_fallback: bool = False):
    """Attach an ``fcompute_ex(attrs, *inputs)`` to the registered op
    ``name`` (``mxnet_tpu/ops/registry.py:227``): it takes a sparse
    input as an ``ops.sparse.SparseRep`` and may return one. ``always``:
    the op takes this path whatever its inputs (``cast_storage``, whose
    output is the sparse one). ``differentiable``: under ``record()`` it
    runs with autograd on, so the gradient reaches its dense inputs (a
    sparse input's components never carry one). ``grad_fallback``: the
    dense ``fcompute`` is a full equivalent, which ``invoke`` takes
    instead while recording with a dense input in the graph."""

    def deco(fn: Callable) -> Callable:
        opdef = get_op(name)
        opdef.fcompute_ex = fn
        opdef.dispatch_ex_always = always
        opdef.ex_differentiable = differentiable
        opdef.ex_grad_fallback = grad_fallback
        return fn

    return deco


def get_op(name: str) -> OpDef:
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("operator %r is not registered" % (name,))


def list_ops() -> List[str]:
    """Every registered operator name, sorted (``mxnet_tpu/ops/
    registry.py:253``)."""
    return sorted(OP_REGISTRY.keys())
