"""The port's ``example/gluon/train_resnet.py`` (BASELINE workload 2)
against the JAX script (CPU), both in this process, seeded alike, at
``resnet18_v1``, batch 4, 64 x 64, 10 classes, 3 batches (BatchNorm over
16 values a channel in the last stage, and every residual add):

* the same loss at each step, within 2e-5 relative: the third step's
  loss is where a wrong SGD/momentum update of the second would show;
* the exported files: the same ``arg:``/``aux:`` names (counters
  renumbered) and symbol nodes, and the moving statistics within 2e-5
  relative. The weights themselves are not held against each other:
  a step's gradient routes through ReLU and max-pool choices between
  values equal to about 1e-6, and a 1e-6 perturbation of the input
  moves the JAX package's own gradients by up to 13 % at this size
  (measured on a CPU), so they are held through the losses above and
  the outputs below;
* across packages on these files: the port's ``SymbolBlock.imports`` of
  the JAX script's export gives the JAX ``SymbolBlock``'s output on it,
  and the JAX package's import of the port's export gives the port's,
  each within 1e-5 relative;
* ``--devices 2`` raises "not ported yet"; with ``--rec`` (a .rec of
  eight 64 x 64 JPEGs, so no resize runs, read by ``ImageRecordIter``'s
  single process in both packages) the losses are the JAX script's,
  step for step, within 2e-5 relative: the port's JPEG decoder gives
  PIL's pixels.

``test_torch_port_rules.py`` runs the script with ``jax`` and
``mxnet_tpu`` blocked.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.example.gluon import train_resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--model", "resnet18_v1", "--batch-size", "4", "--image-size",
        "64", "--num-classes", "10", "--num-batches", "3",
        "--disp-batches", "1"]
REL = 2e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / max(
        float(np.abs(np.asarray(want)).max()), 1e-30)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_resnet")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_losses = []

    class Recording(jmx.parallel.TrainStep):
        def __call__(self, data, label):
            out = super().__call__(data, label)
            jax_losses.append(float(out.asnumpy()))
            return out

    script = _load("_jax_train_resnet",
                   os.path.join(REPO, "example", "gluon", "train_resnet.py"))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jmx.parallel, "TrainStep", Recording)
        mp.setattr(sys, "argv", ["train_resnet.py"] + ARGS + [
            "--devices", "1", "--save-prefix", str(d / "jax")])
        jmx.random.seed(0)
        script.main()
        mx.random.seed(0)
        res = train_resnet.run(train_resnet.parse_args(ARGS + [
            "--device", "cpu", "--save-prefix", str(d / "port")]))
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return d, jax_losses, res


def test_losses_step_for_step(runs):
    _, want, res = runs
    got = res["losses"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= REL
    assert len(res["step_s"]) == 3 and res["export_s"] > 0


def test_exported_files_agree(runs):
    d, _, _ = runs
    got = mx.nd.load(str(d / "port-0000.params"), ctx=mx.cpu())
    want = jmx.nd.load(str(d / "jax-0000.params"))

    def canon(params):
        keys = list(params)
        names = gluon._canonical_names([k.split(":", 1)[1] for k in keys])
        return {k.split(":")[0] + ":" + n: params[k].asnumpy()
                for k, n in zip(keys, names)}

    got, want = canon(got), canon(want)
    assert sorted(got) == sorted(want)
    assert sum(k.startswith("aux:") for k in got) == 40  # 20 BatchNorms
    for k in want:
        assert got[k].shape == want[k].shape
        if k.startswith("aux:"):
            assert _rel_err(got[k], want[k]) <= REL, k
    gj = json.loads((d / "port-symbol.json").read_text())
    jj = json.loads((d / "jax-symbol.json").read_text())
    assert [n["op"] for n in gj["nodes"]] == [n["op"] for n in jj["nodes"]]


@pytest.mark.parametrize("source", ["jax", "port"])
def test_each_export_imports_across_packages(runs, source):
    d, _, _ = runs
    files = [str(d / ("%s-symbol.json" % source)), "data",
             str(d / ("%s-0000.params" % source))]
    x = np.random.RandomState(9).rand(2, 3, 64, 64).astype(np.float32)
    with mx.cpu():
        got = gluon.SymbolBlock.imports(*files)(mx.nd.array(x)).asnumpy()
    jsb = jmx.gluon.SymbolBlock.imports(*files, ctx=jmx.cpu())
    want = jsb(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy()
    assert np.isfinite(got).all()
    assert _rel_err(got, want) <= 1e-5


def test_more_devices_and_rec_raise(tmp_path, monkeypatch):
    with pytest.raises(MXNetError, match="not ported yet"):
        train_resnet.run(train_resnet.parse_args(ARGS + [
            "--device", "cpu", "--devices", "2"]))
    rec = str(tmp_path / "train.rec")
    writer = mx.recordio.MXIndexedRecordIO(str(tmp_path / "train.idx"), rec,
                                           "w")
    rs = np.random.RandomState(5)
    with mx.cpu():
        for i in range(8):
            img = (rs.rand(64, 64, 3) * 255).astype(np.uint8)
            writer.write_idx(i, mx.recordio.pack_img(
                mx.recordio.IRHeader(0, float(i % 10), i, 0), img))
    writer.close()
    # both packages read the records in one process (no spawned workers)
    monkeypatch.setattr(sys.modules["__main__"], "__file__", None,
                        raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_losses = []

    class Recording(jmx.parallel.TrainStep):
        def __call__(self, data, label):
            out = super().__call__(data, label)
            jax_losses.append(float(out.asnumpy()))
            return out

    script = _load("_jax_train_resnet_rec",
                   os.path.join(REPO, "example", "gluon", "train_resnet.py"))
    try:
        monkeypatch.setattr(jmx.parallel, "TrainStep", Recording)
        monkeypatch.setattr(sys, "argv", ["train_resnet.py"] + ARGS + [
            "--devices", "1", "--rec", rec])
        jmx.random.seed(0)
        script.main()
        mx.random.seed(0)
        res = train_resnet.run(train_resnet.parse_args(ARGS + [
            "--device", "cpu", "--rec", rec]))
    finally:
        torch.set_num_threads(threads)
    assert len(res["losses"]) == len(jax_losses) == 2
    assert len(res["wait_s"]) == 2
    for g, w in zip(res["losses"], jax_losses):
        assert _rel_err(g, w) <= REL
