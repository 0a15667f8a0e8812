"""The port's standing rules (CPU).

* ``mxnet_tpu_torch/``, ``chip_smoke.py`` and ``paged_attention_sweep.py``
  import neither ``jax`` nor anything of ``mxnet_tpu`` (an AST scan of
  every module), and the port
  still serves with ``jax`` and ``mxnet_tpu`` made unimportable;
* its entry points run on the card by default: with no CUDA device and
  no ``device="cpu"`` they raise instead of quietly using the CPU; the
  training slice's default context is ``gpu(0)``, so ``current_context()``
  and ``nd.array`` without a context raise too, and ``gpu()`` raises
  where the JAX package (``mxnet_tpu/context.py:81``) falls back to the
  host;
* the training slice, like the serving one, imports and trains with
  ``jax`` and ``mxnet_tpu`` made unimportable;
* the detection slice's entry points, ``Module`` and ``ImageDetIter``,
  raise without a card when no context asks for the host, and the SSD
  example imports and takes a training step with ``jax`` and
  ``mxnet_tpu`` made unimportable;
* ``chip_smoke.py`` refuses to run without a card, printing no result;
* the training plane slice (``trainplane``, ``lr_scheduler``) is in the
  scan and trains in bfloat16 with ``jax`` and ``mxnet_tpu`` made
  unimportable;
* the module plane and vision zoo slice (``trainplane.module_plane``,
  ``gluon/contrib/``, the zoo families, ``benchmark_score``) is in the
  scan, and fits a module on the plane, builds every zoo name and scores
  a net with ``jax`` and ``mxnet_tpu`` made unimportable;
* the checkpoint slice (``ndarray/io_utils``, ``elastic``, ``model``) is
  in the scan, and fits a module with ``module_checkpoint``, resumes it
  through ``Module.load`` and predicts with ``jax`` and ``mxnet_tpu``
  made unimportable;
* the word language model slice (``gluon/rnn/``, ``gluon/utils``,
  ``ops/random_ops``, ``ndarray/random``, ``example/gluon/``) is in the
  scan and trains with ``jax`` and ``mxnet_tpu`` made unimportable, and no
  module of the port draws from torch's global generator (every
  ``torch.rand*``/``normal``/``multinomial``/... call passes
  ``generator=``);
* the MNIST slice (``kvstore``, ``monitor``, ``ops/optimizer_ops``,
  ``example/image_classification/train_mnist.py`` and ``common/``,
  ``symbols/``) is in the scan, and the example trains through the
  kvstore with a monitor and 2-bit compression with ``jax`` and
  ``mxnet_tpu`` made unimportable;
* the sparse and operator-tail slice (``ndarray/sparse``,
  ``ops/sparse``, ``ops/linalg``, ``ops/misc_tail``, the four examples
  under ``example/sparse/``, ``example/ctc/``, ``example/svm_mnist/``)
  is in the scan; the examples, ``LibSVMIter`` and the sparse
  constructors run on the card unless asked for the host, and the four
  examples train with ``jax`` and ``mxnet_tpu`` made unimportable;
* the gluon slice (``gluon/data/``, ``gluon/contrib/data/`` and
  ``rnn/``, ``contrib/text``, the three ``example/gluon/`` scripts) is in the
  scan; the examples, ``DataLoader``, ``SymbolBlock.imports`` and
  ``Constant`` run on the card unless asked for the host, and the
  examples train, export, import and load data with ``jax`` and
  ``mxnet_tpu`` made unimportable;
* the bucketing and graph slice (``subgraph``, ``sym_contrib``,
  ``ndarray/contrib``, ``ops/control_flow``, ``module/bucketing_module``
  and ``sequential_module``, ``example/rnn/``, ``example/memcost/``) is
  in the scan; ``BucketingModule``, a ``SequentialModule``'s modules and
  the two examples run on the card unless asked for the host, and the
  examples, a control-flow symbol and a partitioned graph train with
  ``jax`` and ``mxnet_tpu`` made unimportable;
* the observability, memory and fleet slice (``profiler``,
  ``telemetry/``'s spans, flightrec, tracing, slo, exporters, httpd and
  devprof, ``resilience/hbm``, ``serving/fleet``) is in the scan; a
  two-replica fleet serves, traces and profiles with ``jax`` and
  ``mxnet_tpu`` made unimportable, and ``FleetRouter``'s replicas run
  on the card unless the factory asks for the host;
* the extension slice's modules (``rtc``, ``operator``, ``metric``,
  ``callback``, ``contrib/``, ``example/numpy_ops/``) are in the scan,
  no module of the port defines ``PallasModule`` (Pallas source cannot
  run on the card), and the rtc example fits with ``jax`` and
  ``mxnet_tpu`` made unimportable.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from conftest import subprocess_env
from mxnet_tpu_torch import MXNetError, nd, serving
from mxnet_tpu_torch.name import NameManager

REPO = Path(__file__).resolve().parent.parent
_BANNED = ("jax", "jaxlib", "mxnet_tpu")


def _port_files():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "paged_attention_sweep.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_imports_no_jax_and_nothing_of_mxnet_tpu():
    files = _port_files()
    assert len(files) >= 15  # the scan really covers the package
    bad = [(str(f.relative_to(REPO)), root) for f in files
           for root in _imported_roots(f) if root in _BANNED]
    assert bad == []


def test_port_serves_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np
from mxnet_tpu_torch import serving
m = serving.TinyDecoder(vocab_size=16, num_layers=1, num_heads=2,
                        head_dim=4)
p = m.init_params(0, device="cpu")
with serving.DecodeEngine(m, p, num_slots=2, max_seq_len=16,
                          prefill_buckets=(4, 8), timeout_ms=0,
                          device="cpu") as eng:
    outs = [f.result(60) for f in [eng.submit([1, 2, 3], 4),
                                   eng.submit([5], 3)]]
assert np.array_equal(outs[0], m.reference_generate(p, [1, 2, 3], 4))
assert np.array_equal(outs[1], m.reference_generate(p, [5], 3))
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("served", [len(o) for o in outs])
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served [4, 3]" in proc.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    model = serving.TinyDecoder(vocab_size=16, num_layers=1, num_heads=2,
                                head_dim=4)
    with pytest.raises(MXNetError, match="no CUDA device"):
        model.init_params(0)
    params = model.init_params(0, device="cpu")
    with pytest.raises(MXNetError, match="no CUDA device"):
        serving.DecodeEngine(model, params, num_slots=1, max_seq_len=8)
    with pytest.raises(MXNetError, match="no CUDA device"):
        serving.params_from_jax({"w": [0.0]})
    with pytest.raises(MXNetError, match="CUDA"):
        serving.DecodeEngine(model, params, num_slots=1, max_seq_len=8,
                             device="cuda")


def test_training_slice_trains_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
from mxnet_tpu_torch.example.transformer import train_gpt
res = train_gpt.run(train_gpt.parse_args(
    ["--device", "cpu", "--epochs", "1", "--train-size", "64",
     "--batch-size", "8", "--layers", "1"]))
assert res["steps"] == 8 and res["test_ppl"] > 0
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("trained", res["steps"])
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "trained 8" in proc.stdout


def test_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.current_context()
    with pytest.raises(MXNetError, match="no CUDA device"):
        nd.array([1.0, 2.0])
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.gpu()  # no quiet fall-back to the host
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.gluon.nn.Dense(2, in_units=2).initialize()
    with mx.cpu():  # asked for: the host is honoured
        assert mx.current_context() == mx.cpu()
        assert nd.array([1.0, 2.0]).context == mx.cpu()


def test_detection_slice_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from mxnet_tpu_torch.example.ssd import train_ssd

    rec = train_ssd.make_dataset(str(tmp_path / "s"), n=2, side=16)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.image.ImageDetIter(batch_size=2, data_shape=(3, 16, 16),
                              path_imgrec=rec)
    net = train_ssd.get_symbol_train(3)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.module.Module(net, data_names=("data",), label_names=("label",))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.module.Module(net, data_names=("data",), label_names=("label",),
                         context=mx.gpu())
    with mx.cpu():  # asked for: the host is honoured
        it = mx.image.ImageDetIter(batch_size=2, data_shape=(3, 16, 16),
                                   path_imgrec=rec)
        mod = mx.module.Module(net, data_names=("data",),
                               label_names=("label",))
    assert next(iter(it)).data[0].context == mx.cpu()
    assert mod._context == [mx.cpu()]


def test_detection_slice_trains_with_jax_and_mxnet_tpu_blocked(tmp_path):
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np
from mxnet_tpu_torch.example.ssd import train_ssd
res = train_ssd.run(train_ssd.parse_args(
    ["--device", "cpu", "--epochs", "1", "--side", "16", "--batch-size",
     "32", "--data-dir", sys.argv[1]]))
assert res["steps"] == 2 and np.isfinite(res["last_loss"])
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("trained", res["steps"])
"""
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=subprocess_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "trained 2" in proc.stdout


def test_chip_smoke_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=str(tmp_path), env=subprocess_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert os.listdir(tmp_path) == []  # and wrote nothing


def test_scan_covers_the_extension_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ("mxnet_tpu_torch/rtc.py", "mxnet_tpu_torch/operator.py",
                 "mxnet_tpu_torch/metric.py", "mxnet_tpu_torch/callback.py",
                 "mxnet_tpu_torch/contrib/__init__.py",
                 "mxnet_tpu_torch/contrib/torch_bridge.py",
                 "mxnet_tpu_torch/example/rtc_spec.py",
                 "mxnet_tpu_torch/example/numpy_ops/custom_softmax.py",
                 "mxnet_tpu_torch/example/numpy_ops/custom_softmax_rtc.py"):
        assert path in names


def _defines(path, name):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)) \
                and node.name == name:
            return True
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return True
    return False


def test_no_module_of_the_port_defines_pallas_module():
    assert [str(f.relative_to(REPO)) for f in _port_files()
            if _defines(f, "PallasModule")] == []
    assert _defines(REPO / "mxnet_tpu" / "rtc.py", "PallasModule")
    assert _defines(REPO / "mxnet_tpu_torch" / "rtc.py", "CudaModule")
    assert not hasattr(mx.rtc, "PallasModule")


def test_extension_slice_fits_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as cr
res = cr.run(cr.parse_args(["--device", "cpu", "--epochs", "1",
                            "--train-size", "256"]))
assert res["learned"] and res["train_batches"] == 4
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("fitted", res["train_batches"])
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fitted 4" in proc.stdout


def test_scan_covers_the_training_plane_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ("mxnet_tpu_torch/trainplane.py",
                 "mxnet_tpu_torch/lr_scheduler.py",
                 "mxnet_tpu_torch/parallel.py",
                 "mxnet_tpu_torch/fastpath/fused.py"):
        assert path in names


def test_training_plane_trains_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import os, sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
os.environ["MXNET_TRAIN_DTYPE"] = "bf16"
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, lr_scheduler, nd, trainplane
with mx.cpu():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu"), gluon.nn.Dense(4))
    net.initialize()
    tr = gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9,
        "lr_scheduler": lr_scheduler.FactorScheduler(step=2, factor=0.5)})
    xs = np.random.RandomState(0).rand(32, 6).astype(np.float32)
    it = mx.io.NDArrayIter(xs, xs[:, :4].argmax(1), batch_size=8)
    plane = trainplane.fit(net, gluon.loss.SoftmaxCrossEntropyLoss(), tr,
                           it, epochs=2)
assert plane.plane == "graph" and tr.optimizer.num_update == 8
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("plane", plane.plane)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "plane graph" in proc.stdout


def test_scan_covers_the_zoo_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    zoo = "mxnet_tpu_torch/gluon/model_zoo/vision/"
    for path in [zoo + f for f in ("alexnet.py", "vgg.py", "squeezenet.py",
                                   "densenet.py", "inception.py",
                                   "mobilenet.py")] + [
            "mxnet_tpu_torch/gluon/contrib/nn/basic_layers.py",
            "mxnet_tpu_torch/example/image_classification/"
            "benchmark_score.py"]:
        assert path in names


def test_zoo_slice_runs_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym, telemetry
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.example.image_classification import benchmark_score
nets = [vision.get_model(n) for n in sorted(vision._MODELS)]
rate = benchmark_score.score("mobilenet0_25", 1, (3, 32, 32), "float32",
                             0.01, ctx=mx.cpu())
net = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc")
net = sym.SoftmaxOutput(net, name="softmax")
xs = np.random.RandomState(0).rand(32, 6).astype(np.float32)
with mx.cpu():
    it = mx.io.NDArrayIter(xs, xs[:, :4].argmax(1), batch_size=8)
    mx.module.Module(net).fit(it, num_epoch=1)
steps = telemetry.STEP_DISPATCHES.value(plane="graph")
assert rate > 0 and steps == 4, (rate, steps)
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("zoo", len(nets), "plane steps", int(steps))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "zoo 34 plane steps 4" in proc.stdout


def test_scan_covers_the_checkpoint_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ("mxnet_tpu_torch/ndarray/io_utils.py",
                 "mxnet_tpu_torch/elastic.py", "mxnet_tpu_torch/model.py"):
        assert path in names


def test_checkpoint_slice_runs_with_jax_and_mxnet_tpu_blocked(tmp_path):
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import os
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym
prefix = os.path.join(sys.argv[1], "fc")
net = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc")
net = sym.SoftmaxOutput(net, name="softmax")
xs = np.random.RandomState(0).rand(32, 6).astype(np.float32)
with mx.cpu():
    it = mx.io.NDArrayIter(xs, xs[:, :4].argmax(1), batch_size=8)
    mod = mx.module.Module(net)
    mod.fit(it, num_epoch=1, epoch_end_callback=mx.callback.module_checkpoint(
        mod, prefix, save_optimizer_states=True))
    back = mx.module.Module.load(prefix, 1, load_optimizer_states=True)
    back.fit(it, num_epoch=2, begin_epoch=1)
    out = back.predict(it).asnumpy()
assert out.shape == (32, 4) and np.isfinite(out).all()
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("files", len(os.listdir(sys.argv[1])))
"""
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=subprocess_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "files 3" in proc.stdout


def test_scan_covers_the_word_lm_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ("mxnet_tpu_torch/example/gluon/__init__.py",
                 "mxnet_tpu_torch/example/gluon/word_language_model/"
                 "__init__.py",
                 "mxnet_tpu_torch/example/gluon/word_language_model/"
                 "train.py",
                 "mxnet_tpu_torch/gluon/rnn/rnn_cell.py",
                 "mxnet_tpu_torch/gluon/rnn/rnn_layer.py",
                 "mxnet_tpu_torch/gluon/utils.py",
                 "mxnet_tpu_torch/ops/random_ops.py",
                 "mxnet_tpu_torch/ndarray/random.py"):
        assert path in names


# torch's sampling calls and in-place samplers: each takes the port's
# generator (random.generator), never torch's global one
_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal", "multinomial",
             "poisson", "bernoulli", "_standard_gamma", "rand_like",
             "randn_like", "randint_like"}
_INPLACE_SAMPLERS = {"uniform_", "normal_", "exponential_", "random_",
                     "bernoulli_", "geometric_", "cauchy_", "log_normal_"}


def _global_draws(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        if "generator" in {k.arg for k in node.keywords}:
            continue
        f = node.func
        if (isinstance(f.value, ast.Name) and f.value.id == "torch"
                and f.attr in _SAMPLERS) or f.attr in _INPLACE_SAMPLERS:
            out.append((str(path.relative_to(REPO)), node.lineno, f.attr))
    return out


def test_no_draw_takes_torchs_global_generator():
    assert [d for f in _port_files() for d in _global_draws(f)] == []
    bad = REPO / "mxnet_tpu_torch" / "ops" / "random_ops.py"
    assert len([n for n in ast.walk(ast.parse(bad.read_text()))
                if isinstance(n, ast.keyword)
                and n.arg == "generator"]) >= 6  # the scan sees them


def test_word_lm_slice_trains_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
from mxnet_tpu_torch.example.gluon.word_language_model import train
res = train.run(train.parse_args(
    ["--device", "cpu", "--epochs", "1", "--nhid", "8", "--emsize", "8",
     "--synth-tokens", "2000", "--bptt", "5", "--batch-size", "8",
     "--tied"]))
assert res["steps"] > 0 and res["val_ppl"][0] > 0
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("steps", res["steps"])
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "steps 45" in proc.stdout


def test_scan_covers_the_mnist_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ("mxnet_tpu_torch/kvstore.py", "mxnet_tpu_torch/monitor.py",
                 "mxnet_tpu_torch/ops/optimizer_ops.py",
                 "mxnet_tpu_torch/example/image_classification/"
                 "train_mnist.py",
                 "mxnet_tpu_torch/example/image_classification/common/"
                 "fit.py",
                 "mxnet_tpu_torch/example/image_classification/symbols/"
                 "mlp.py",
                 "mxnet_tpu_torch/example/image_classification/symbols/"
                 "lenet.py"):
        assert path in names


def test_mnist_slice_trains_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
from mxnet_tpu_torch.example.image_classification import train_mnist
from mxnet_tpu_torch.kvstore import OPS
mod = train_mnist.main(["--device", "cpu", "--num-examples", "320",
                        "--num-epochs", "1", "--monitor", "2",
                        "--gc-type", "2bit", "--optimizer", "nadam"])
assert mod._update_on_kvstore and mod._kvstore is not None
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("pushes", int(OPS.value(op="push")))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "pushes 30" in proc.stdout


_SPARSE_SLICE_EXAMPLES = ("sparse/linear_classification", "sparse/fm",
                          "ctc/lstm_ocr", "svm_mnist/svm_mnist")


def test_scan_covers_the_sparse_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ["mxnet_tpu_torch/ndarray/sparse.py",
                 "mxnet_tpu_torch/ops/sparse.py",
                 "mxnet_tpu_torch/ops/linalg.py",
                 "mxnet_tpu_torch/ops/misc_tail.py"] + [
            "mxnet_tpu_torch/example/%s.py" % e
            for e in _SPARSE_SLICE_EXAMPLES]:
        assert path in names


def test_sparse_slice_defaults_to_the_card(tmp_path):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    for ex in _SPARSE_SLICE_EXAMPLES:
        mod = importlib.import_module("mxnet_tpu_torch.example."
                                      + ex.replace("/", "."))
        args = mod.parse_args([])
        assert args.device == "gpu"
        with pytest.raises(MXNetError, match="no CUDA device"):
            mod.run(args)
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:1.5 3:2\n")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.io.LibSVMIter(data_libsvm=str(path), data_shape=4, batch_size=1)
    with pytest.raises(MXNetError, match="no CUDA device"):
        nd.sparse.csr_matrix([[0.0, 1.0]])


def test_sparse_slice_trains_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
from mxnet_tpu_torch.example.sparse import fm, linear_classification as lc
from mxnet_tpu_torch.example.ctc import lstm_ocr
from mxnet_tpu_torch.example.svm_mnist import svm_mnist
steps = [
    lc.run(lc.parse_args(["--device", "cpu", "--num-samples", "128",
                          "--feature-dim", "100", "--epochs", "2"]))["steps"],
    fm.run(fm.parse_args(["--device", "cpu", "--num-samples", "128",
                          "--feature-dim", "100", "--epochs", "2",
                          "--optimizer", "adagrad"]))["steps"],
    lstm_ocr.run(lstm_ocr.parse_args(["--device", "cpu", "--epochs", "1",
                                      "--train-size", "64",
                                      "--batch-size", "32"]))["steps"],
    svm_mnist.run(svm_mnist.parse_args(["--device", "cpu", "--epochs", "1",
                                        "--train-size", "128"]))["steps"]]
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("steps", steps)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "steps [4, 4, 2, 6]" in proc.stdout


_GLUON_SLICE_EXAMPLES = ("train_resnet", "dcgan", "neural_style")


def test_scan_covers_the_gluon_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ["mxnet_tpu_torch/gluon/data/%s.py" % m for m in (
            "__init__", "dataset", "sampler", "dataloader",
            "vision/__init__", "vision/datasets", "vision/transforms")] + [
            "mxnet_tpu_torch/gluon/contrib/%s.py" % m for m in (
                "data/__init__", "data/sampler", "data/text",
                "rnn/__init__", "rnn/rnn_cell", "rnn/conv_rnn_cell")] + [
            "mxnet_tpu_torch/contrib/text/__init__.py",
            "mxnet_tpu_torch/contrib/text/vocab.py"] + [
            "mxnet_tpu_torch/example/gluon/%s.py" % e
            for e in _GLUON_SLICE_EXAMPLES]:
        assert path in names


def test_gluon_slice_defaults_to_the_card(tmp_path):
    """The three examples, a DataLoader, a SymbolBlock import and a
    Constant raise without a card unless the host is asked for: nothing
    falls back to the CPU quietly."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    for ex in _GLUON_SLICE_EXAMPLES:
        mod = importlib.import_module("mxnet_tpu_torch.example.gluon." + ex)
        args = mod.parse_args(["--iters", "1"] if ex == "neural_style"
                              else [])
        assert args.device == "gpu"
        with pytest.raises(MXNetError, match="no CUDA device"):
            mod.run(args)
    ds = mx.gluon.data.SimpleDataset([1.0, 2.0])
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.gluon.data.DataLoader(ds, batch_size=1)
    # a name scope of its own: the trace's node names must not move the
    # process's counters, which tests comparing auto-named symbols share
    with mx.cpu(), NameManager():
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        net.export(str(tmp_path / "d"))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.gluon.SymbolBlock.imports(str(tmp_path / "d-symbol.json"),
                                     "data", str(tmp_path / "d-0000.params"))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.gluon.Constant("c", [1.0]).initialize()
    # a graph fed numpy (or a host tensor) runs on the card by default:
    # only NDArray inputs and an explicit ctx pick the host
    sym = mx.sym.FullyConnected(mx.sym.var("x"), num_hidden=2, name="fc")
    vals = {"x": np.ones((1, 3), np.float32),
            "fc_weight": np.ones((2, 3), np.float32),
            "fc_bias": torch.zeros(2)}
    with pytest.raises(MXNetError, match="no CUDA device"):
        sym.eval(**vals)
    out = sym.eval(ctx=mx.cpu(), **vals)
    assert out.context == mx.cpu()
    np.testing.assert_array_equal(out.asnumpy(), [[3.0, 3.0]])


def test_gluon_slice_runs_with_jax_and_mxnet_tpu_blocked(tmp_path):
    code = r"""
import os
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image
from mxnet_tpu_torch.example.gluon import dcgan, neural_style, train_resnet
from mxnet_tpu_torch.gluon.data.vision import ImageFolderDataset, transforms
tmp = sys.argv[1]
os.environ["HOME"] = tmp
prefix = os.path.join(tmp, "r18")
res = train_resnet.run(train_resnet.parse_args(
    ["--device", "cpu", "--model", "resnet18_v1", "--batch-size", "4",
     "--image-size", "64", "--num-classes", "10", "--num-batches", "1",
     "--save-prefix", prefix]))
with mx.cpu():
    sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                      prefix + "-0000.params")
    out = sb(mx.nd.array(np.ones((1, 3, 64, 64), np.float32))).asnumpy()
    assert out.shape == (1, 10) and np.isfinite(out).all()
    for c in ("a", "b"):
        os.makedirs(os.path.join(tmp, "img", c))
        with open(os.path.join(tmp, "img", c, "0.png"), "wb") as f:
            f.write(image.imencode(np.full((8, 6, 3), 9, np.uint8), ".png"))
    ds = ImageFolderDataset(os.path.join(tmp, "img")).transform_first(
        transforms.Compose([transforms.RandomResizedCrop(4),
                            transforms.ToTensor()]))
    batches = list(mx.gluon.data.DataLoader(ds, batch_size=2,
                                            num_workers=2))
    cell = mx.gluon.contrib.rnn.Conv2DLSTMCell((2, 4, 4), 3, 3, 3, 1)
    cell.initialize()
    outs, _ = cell.unroll(2, mx.nd.ones((1, 2, 2, 4, 4)))
d = dcgan.run(dcgan.parse_args(["--device", "cpu", "--epochs", "1",
                                "--num-samples", "32"]))
s = neural_style.run(neural_style.parse_args(["--device", "cpu", "--iters",
                                              "3", "--size", "16"]))
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("ran", len(res["losses"]), batches[0][0].shape, len(outs),
      len(d["d_losses"]), len(s["losses"]))
"""
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=subprocess_env(),
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ran 1 (2, 3, 4, 4) 2 1 3" in proc.stdout


def test_scan_covers_the_graph_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ["mxnet_tpu_torch/%s.py" % m for m in (
            "subgraph", "sym_contrib", "ndarray/contrib",
            "ops/control_flow", "module/bucketing_module",
            "module/sequential_module", "example/rnn/bucketing_lstm",
            "example/memcost/memonger")]:
        assert path in names


def test_graph_slice_defaults_to_the_card():
    """BucketingModule, a SequentialModule's modules and the two examples
    raise without a card unless the host is asked for."""
    from mxnet_tpu_torch.example.memcost import memonger
    from mxnet_tpu_torch.example.rnn import bucketing_lstm
    from mxnet_tpu_torch.module import (BucketingModule, Module,
                                        SequentialModule)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")

    def gen(key):
        return (mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                      name="fc"), ("data",), None)

    with pytest.raises(MXNetError, match="no CUDA device"):
        BucketingModule(gen, default_bucket_key=4)
    with pytest.raises(MXNetError, match="no CUDA device"):
        SequentialModule().add(Module(gen(4)[0], label_names=None))
    for example in (bucketing_lstm, memonger):
        assert example.parse_args([]).device == "gpu"
        with pytest.raises(MXNetError, match="no CUDA device"):
            example.main(["--epochs", "1"] if example is bucketing_lstm
                         else ["--depth", "1", "--width", "4",
                               "--batch-size", "2"])
    with mx.cpu():
        mod = BucketingModule(gen, default_bucket_key=4)
        seq = SequentialModule().add(Module(gen(4)[0], label_names=None))
    assert mod._context == [mx.cpu()]
    assert seq._modules[0]._context == [mx.cpu()]


def test_graph_slice_trains_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import subgraph
from mxnet_tpu_torch.example.memcost import memonger
from mxnet_tpu_torch.example.rnn import bucketing_lstm
res = bucketing_lstm.main(["--epochs", "1", "--device", "cpu"])
mem = memonger.main(["--device", "cpu", "--depth", "2", "--width", "8",
                     "--batch-size", "4"])
with mx.cpu():
    x = mx.sym.var("x")
    h0, w = mx.sym.var("h0", shape=(3, 2)), mx.sym.var("w", shape=(2, 2))
    outs, _ = mx.sym.contrib.foreach(
        lambda xt, st: [mx.sym.tanh(mx.sym.dot(xt, w) + st[0])] * 2,
        x, [h0])
    loss = mx.sym.MakeLoss(mx.sym.sum(outs))
    part = subgraph.partition_graph(mx.sym.load_json(loss.tojson()),
                                    ["MakeLoss", "sum"])
    mod = mx.mod.Module(part, data_names=("x",), label_names=None)
    it = mx.io.NDArrayIter(np.ones((4, 3, 2), np.float32), batch_size=4)
    mod.bind(data_shapes=[("x", (4, 3, 2))])
    mod.init_params(arg_params={"h0": mx.nd.zeros((3, 2)),
                                "w": mx.nd.ones((2, 2))})
    mod.init_optimizer()
    mod.forward_backward(next(iter(it)))
    mod.update()
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("ran", res["buckets"], mem["ratio"], mod.get_outputs()[0].shape)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ran [8, 16, 24] 1.0 ()" in proc.stdout


def test_scan_covers_the_fleet_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ["mxnet_tpu_torch/%s.py" % m for m in (
            "profiler", "telemetry/spans", "telemetry/flightrec",
            "telemetry/tracing", "telemetry/slo", "telemetry/exporters",
            "telemetry/httpd", "telemetry/devprof", "resilience/hbm",
            "serving/fleet")]:
        assert path in names


def test_fleet_slice_serves_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.resilience import hbm
from mxnet_tpu_torch.telemetry import devprof, tracing
tracing.set_sample(1.0)
devprof.set_sample(1.0)
m = serving.TinyDecoder(vocab_size=16, num_layers=1, num_heads=2,
                        head_dim=4)
p = m.init_params(0, device="cpu")
fleet = serving.FleetRouter(
    lambda name: serving.DecodeEngine(
        m, p, num_slots=2, max_seq_len=32, page_size=4,
        prefill_buckets=(8,), timeout_ms=0, name=name, device="cpu"),
    replicas=2, name="blocked")
try:
    fleet.warmup()
    outs = [fleet.generate([1 + i, 2, 3, 4, 5], 3, timeout=60)
            for i in range(4)]
    fleet.kill_replica(0)
    outs.append(fleet.generate([9, 9, 9], 2, timeout=60))
finally:
    fleet.close(timeout=60)
for i, o in enumerate(outs[:4]):
    assert np.array_equal(o, m.reference_generate(p, [1 + i, 2, 3, 4, 5], 3))
assert devprof.DEVICE_TIME_MS.series() and tracing.trace_ids()
assert "mxnet_fleet_replicas" in telemetry.render_prometheus()
assert hbm.classify(RuntimeError("CUDA out of memory")) == "device"
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("fleet served", len(outs))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fleet served 5" in proc.stdout


def test_fleet_replicas_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    model = serving.TinyDecoder(vocab_size=16, num_layers=1, num_heads=2,
                                head_dim=4)
    params = model.init_params(0, device="cpu")
    with pytest.raises(MXNetError, match="no CUDA device"):
        serving.FleetRouter(
            lambda name: serving.DecodeEngine(model, params, num_slots=1,
                                              max_seq_len=8, name=name),
            replicas=2, name="card_default")


def test_scan_covers_the_request_server_slice():
    names = {str(f.relative_to(REPO)) for f in _port_files()}
    for path in ["mxnet_tpu_torch/%s.py" % m for m in (
            "aot", "_predict_embed", "serving/engine", "serving/batcher",
            "telemetry/regress", "tools/benchwatch")]:
        assert path in names


def test_request_server_slice_serves_with_jax_and_mxnet_tpu_blocked():
    code = r"""
import sys, tempfile
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None  # any import of them now raises
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import aot, gluon, nd, serving
from mxnet_tpu_torch.telemetry import regress
from mxnet_tpu_torch.tools import benchwatch
with mx.cpu():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu"), gluon.nn.Dense(3))
    net.initialize()
    x = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    want = net(nd.array(x)).asnumpy()
    srv = serving.serve_block(net, (4,), buckets=(1, 2, 4),
                              max_delay_ms=1.0)
    d = tempfile.mkdtemp()
    aot.export_model(net, (1, 4), d, save_tf=False, poly_batch=True)
    asrv = serving.serve_stablehlo(d, buckets=(1, 4), max_delay_ms=1.0)
try:
    assert srv.warmup() == 3 and asrv.warmup() == 2
    got = np.stack([srv.submit(r).result(30) for r in x])
    agot = np.stack([asrv.submit(r).result(30) for r in x])
    assert srv.stats()["steady_state_recompiles"] == 0
finally:
    srv.close()
    asrv.close()
assert np.allclose(got, want, atol=1e-6) and np.allclose(agot, want,
                                                          atol=1e-6)
assert regress.config_signature({"metric": "m"})
assert benchwatch.main([]) == 0
assert not any(k.split(".")[0] in ("jax", "mxnet_tpu")
               for k, v in sys.modules.items() if v is not None)
print("served", len(got), len(agot))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 5 5" in proc.stdout
