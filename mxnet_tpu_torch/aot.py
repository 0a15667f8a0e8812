"""AOT deployment: an exported, self-contained inference program.

The port of ``mxnet_tpu/aot.py``. The JAX package exports the jitted
forward as a ``jax.export`` serialization (``model.stablehlo``); the port
exports it as a ``torch.export`` program saved with ``torch.export.save``
(``model.pt2``): the graph of ATen operations with the net's weights as
its buffers, loadable with no Python source of the net
(:func:`load_stablehlo`) and servable by
:class:`~mxnet_tpu_torch.serving.StableHLOEngine`. ``manifest.json`` keeps
the JAX package's keys (``input_shape``, ``input_dtype``, ``poly_batch``,
``outputs``, ``output_shape``, ``output_dtype``) under the format
``mxnet_tpu_torch-aot-v1``; a directory of another format (a JAX
``model.stablehlo``) is refused by name.

The JAX package's second artifact, a TF SavedModel for the no-Python C
runner (``cpp-package/predict_aot_demo.cc``), is not ported:
``save_tf=True`` writes the program and its manifest first, then raises.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from .base import MXNetError, fetch_host, torch_dtype
from .ndarray.ndarray import NDArray

__all__ = ["export_model", "load_stablehlo", "predict_stablehlo"]

FORMAT = "mxnet_tpu_torch-aot-v1"
PROGRAM = "model.pt2"
MANIFEST = "manifest.json"
# the largest batch of a poly_batch program: cuDNN's convolutions take no
# more (on the card the trace guards the batch dimension at it)
MAX_BATCH = 65535


class _Exported(torch.nn.Module):
    """The net's forward over its parameters registered as buffers of this
    module, so ``torch.export`` keeps them as the program's state instead
    of lifting them as constants."""

    def __init__(self, net):
        super().__init__()
        self._net = [net]  # a list: not a submodule of the export
        self._names = {}
        for i, (name, p) in enumerate(net.collect_params().items()):
            buf = "p%d" % i
            self._names[name] = buf
            self.register_buffer(buf, p.data()._data.detach())

    def forward(self, x):
        from .context import from_device
        from .parallel import _bound

        net = self._net[0]
        tensors = {n: getattr(self, b) for n, b in self._names.items()}
        with from_device(x.device), _bound(net.collect_params(), tensors):
            out = net(NDArray(x))
        if isinstance(out, (list, tuple)):
            return tuple(o._data for o in out)
        return out._data


def _net_device(net) -> torch.device:
    from .context import current_context

    for p in net.collect_params().values():
        return p.data()._data.device
    return current_context().torch_device()


def _json_shape(shape, batch_sym):
    """Concrete dims as ints; symbolic ones as their expression with the
    batch symbol named ``b``, as the JAX manifest writes them."""
    out = []
    for d in shape:
        if isinstance(d, int):
            out.append(d)
        else:
            expr = str(d)
            out.append(expr.replace(batch_sym, "b") if batch_sym else expr)
    return out


def export_model(net, input_shape: Sequence[int], out_dir: str,
                 dtype="float32", save_tf: bool = True,
                 poly_batch: bool = False):
    """Export an initialized Gluon block's forward for deployment.

    Parameters
    ----------
    net : initialized Gluon block; the program runs on the device its
        parameters are on
    input_shape : example input shape, e.g. ``(1, 3, 224, 224)``
    out_dir : artifact directory (created)
    save_tf : the JAX package's TF SavedModel for the no-Python C runner;
        not ported: the program and manifest are written, then
        :class:`MXNetError` is raised
    poly_batch : export with a *symbolic* leading (batch) dimension
        (``torch.export.Dim("b")``, 1 to ``MAX_BATCH``) so one
        ``model.pt2`` serves every batch size — the format
        ``serving.StableHLOEngine`` expects for bucketed dynamic
        batching. Mutually exclusive with ``save_tf``.

    The forward is traced (non-strict) in predict mode under
    ``torch.no_grad()``. Returns the manifest dict.
    """
    from . import autograd

    if poly_batch and save_tf:
        raise ValueError("poly_batch=True exports a symbolic batch dim; "
                         "pass save_tf=False (the TF SavedModel needs a "
                         "concrete shape)")
    os.makedirs(out_dir, exist_ok=True)
    input_shape = [int(d) for d in input_shape]
    wrapper = _Exported(net)
    example_shape = list(input_shape)
    dynamic = None
    if poly_batch:
        # an example batch of 0 or 1 would be specialized by the tracer
        example_shape[0] = max(2, example_shape[0])
        dynamic = ({0: torch.export.Dim("b", min=1, max=MAX_BATCH)},)
    example = torch.zeros(example_shape, dtype=torch_dtype(dtype),
                          device=_net_device(net))
    # outside the traced function: a grad-mode switch inside it leaves a
    # node that torch.export.load refuses
    with torch.no_grad(), autograd.pause():
        program = torch.export.export(wrapper, (example,),
                                      dynamic_shapes=dynamic, strict=False)
    torch.export.save(program, os.path.join(out_dir, PROGRAM))

    vals = _output_values(program)
    batch_sym = _batch_symbol(program) if poly_batch else None
    outputs = [{"shape": _json_shape(v.shape, batch_sym),
                "dtype": str(v.dtype).replace("torch.", "")} for v in vals]
    manifest = {
        "format": FORMAT,
        "input_shape": input_shape,
        "input_dtype": str(dtype),
        "poly_batch": bool(poly_batch),
        "outputs": outputs,
        # single-output convenience aliases
        "output_shape": outputs[0]["shape"],
        "output_dtype": outputs[0]["dtype"],
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if save_tf:
        raise MXNetError(
            "export_model(save_tf=True): the TF SavedModel for the "
            "no-Python C runner is not ported; %s and %s are written — "
            "pass save_tf=False" % (PROGRAM, MANIFEST))
    return manifest


def _output_values(program):
    """The fake tensors of the program's user outputs, in order."""
    names = list(program.graph_signature.user_outputs)
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    by_name = {a.name: a for a in out_node.args[0]
               if isinstance(a, torch.fx.Node)}
    return [by_name[n].meta["val"] for n in names]


def _batch_symbol(program):
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == name)
    return str(node.meta["val"].shape[0])


def read_manifest(out_dir: str) -> dict:
    """The artifact's manifest; :class:`MXNetError` when the directory is
    not a ``mxnet_tpu_torch-aot-v1`` export (a JAX ``model.stablehlo``,
    say)."""
    path = os.path.join(out_dir, MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise MXNetError("%s is not an exported artifact: %s"
                         % (out_dir, exc)) from exc
    fmt = manifest.get("format")
    if fmt != FORMAT:
        raise MXNetError(
            "%s holds an artifact of format %r; this package loads %r "
            "(a torch.export program, %s): re-export the net with "
            "mxnet_tpu_torch.aot.export_model" % (out_dir, fmt, FORMAT,
                                                  PROGRAM))
    return manifest


_LOADED = {}  # (path, mtime) -> ExportedProgram
_MODULES = {}  # (path, mtime, device) -> the program's module on device


def load_stablehlo(out_dir: str):
    """Load the exported program (``torch.export.load``). Memoized on
    (path, mtime) so a serving loop pays the load once."""
    read_manifest(out_dir)
    path = os.path.join(out_dir, PROGRAM)
    key = (path, os.path.getmtime(path))
    cached = _LOADED.get(key)
    if cached is None:
        cached = torch.export.load(path)
        _LOADED.clear()  # one live artifact per process is the common case
        _MODULES.clear()
        _LOADED[key] = cached
    return cached


def module_on(out_dir: str, device) -> torch.nn.Module:
    """The loaded program as a callable module on ``device`` (its weights
    and the device arguments of its operations moved there), memoized
    with the program."""
    from torch.export.passes import move_to_device_pass

    program = load_stablehlo(out_dir)
    path = os.path.join(out_dir, PROGRAM)
    key = (path, os.path.getmtime(path), str(device))
    mod = _MODULES.get(key)
    if mod is None:
        mod = _MODULES[key] = move_to_device_pass(program, device).module()
    return mod


def predict_stablehlo(out_dir: str, x):
    """Run the artifact in-process on ``x``'s device (an NDArray), or for
    host data on the current context (the card unless inside
    ``with mx.cpu():``). Single-output models return one ndarray;
    multi-output models a list."""
    from .context import current_context

    if isinstance(x, NDArray):
        data = x._data
    else:
        data = torch.as_tensor(np.asarray(x)).to(
            current_context().torch_device())
    with torch.no_grad():
        out = module_on(out_dir, data.device)(data)
    if isinstance(out, (list, tuple)):
        return fetch_host(list(out))
    return fetch_host([out])[0]
