"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, for one NVIDIA H100. The layout
mirrors ``mxnet_tpu`` (``serving/``, ``ops/``, ``telemetry/``,
``resilience/``) so each module's counterpart is easy to find; the code
inside is plain PyTorch. Every TPU kernel on a ported path is a kernel
written by hand for Hopper (``ops/csrc/``), built with ``nvcc`` at first
use.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``mxnet_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``; with no card and no such request they raise
:class:`MXNetError`.

Ported so far: the decode-serving plane (``serving.DecodeEngine`` over
``serving.TinyDecoder``) with the paged-attention kernels
(``ops.paged_attention``), and the imperative/gluon training path of the
GPT example (``nd``, ``autograd``, ``gluon``, ``initializer``,
``optimizer``; ``example/transformer/train_gpt.py``) with the
flash-attention kernel (``ops.flash_attention``), and the symbolic path
of the SSD example (``sym``, ``executor``, ``module``, ``io``,
``recordio``, ``image``, the detection ops; ``example/ssd/train_ssd.py``)
with the NMS kernel (``ops.nms``), and the extension path (``rtc``,
whose ``CudaModule`` compiles the user's CUDA-C kernels with NVRTC,
``operator``'s custom ops, ``autograd.Function``, ``metric``,
``callback``, ``Module.fit``; ``example/numpy_ops/``), and the ResNet
training path of the JAX package's ``bench.py`` (``fastpath``'s fused
optimizer apply, BatchNorm and the conv layers, ``gluon.model_zoo``'s
ResNets, ``parallel.TrainStep``/``InferStep`` captured as CUDA graphs,
in float32 and bfloat16, with ``remat`` and ``memory_analysis``;
``optimizer``'s ``multi_precision`` and ``lr_scheduler``; and
``trainplane.TrainPlane``, the whole Trainer step as one CUDA graph; it
runs no hand-written kernel), and checkpoints: the ``.params`` container
(``nd.save``/``nd.load``, byte for byte the JAX package's), symbol files,
``Block``/``Trainer``/``Module`` checkpoints restored in place into a
captured training plane, ``model.FeedForward`` and the atomic commit
(``elastic``), and the word language model: the NDArray surface, every
op of ``ops/tensor.py``, the random samplers (``nd.random``,
``mx.random.get_state``/``set_state``), ``gluon.rnn`` over the ``RNN``
op (cuDNN through torch on the card), ``gluon.utils`` and
``example/gluon/word_language_model/train.py``; it runs no hand-written
kernel; and the Module/kvstore training path of
``example/image_classification/train_mnist.py`` through
``common/fit.py``: ``kvstore`` on one process (``mx.kv`` its alias),
``monitor``, ``io.MNISTIter`` and the 17 optimizers with their 12 update
ops (``ops/optimizer_ops.py``); it runs no hand-written kernel; and
the rest of gluon with ``example/gluon/train_resnet.py`` (BASELINE
workload 2): a block's symbolic trace, ``export`` and ``SymbolBlock``,
``gluon.data`` with the vision datasets and transforms,
``gluon.contrib``'s ``rnn`` and ``data``, every initializer, and the
DCGAN and neural-style examples; it runs no hand-written kernel; and
bucketing and graph features: ``module.BucketingModule`` with
``example/rnn/bucketing_lstm.py``, ``module.SequentialModule``, shared
executors and ``reshape``, symbolic and imperative control flow
(``sym.contrib``/``nd.contrib`` ``foreach``, ``while_loop``, ``cond``)
with ``example/memcost/memonger.py``, and ``subgraph``'s partitioning;
it runs no hand-written kernel. The top-level aliases ``mx.mod``,
``mx.NDArray``, ``mx.Symbol``, ``mx.var`` and ``mx.AttrScope`` are the
JAX package's. The training
paths follow MXNet's entry points, with one departure: the default
context is the card (``gpu(0)``), and without one, code that does not
ask for ``mx.cpu()`` raises.
"""
from __future__ import annotations

from . import autograd, gluon, initializer, ndarray, optimizer, random
from . import attribute, executor, image, io, model, module, recordio
from . import callback, contrib, fastpath, metric, operator, parallel, rtc
from . import elastic, kvstore, lr_scheduler, monitor, trainplane
from . import profiler, resilience, telemetry
from . import kvstore as kv
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import subgraph
from .base import MXNetError, fetch_host, get_env, resolve_device
from .context import Context, cpu, current_context, gpu, num_gpus
from .model import load_checkpoint, save_checkpoint
from .attribute import AttrScope
from .ndarray import NDArray
from .symbol import Symbol, var
from . import module as mod

__all__ = ["MXNetError", "fetch_host", "get_env", "resolve_device",
           "Context", "cpu", "gpu", "current_context", "num_gpus",
           "autograd", "gluon", "initializer", "nd", "ndarray", "optimizer",
           "random", "attribute", "executor", "image", "io", "model",
           "module", "recordio", "sym", "symbol", "subgraph", "callback",
           "contrib",
           "metric", "operator", "rtc", "fastpath", "parallel",
           "lr_scheduler", "trainplane", "elastic", "kvstore", "kv",
           "monitor", "save_checkpoint",
           "load_checkpoint", "AttrScope", "NDArray", "Symbol", "var", "mod"]
