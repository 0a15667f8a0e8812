"""Module API: symbolic training (reference ``python/mxnet/module/``), the
port of ``mxnet_tpu/module/``: ``BaseModule``, ``Module`` and
``DataParallelExecutorGroup`` on one context, ``BucketingModule`` and
``SequentialModule``, plus :func:`params_from_jax`."""
from . import (base_module, bucketing_module, executor_group, module,
               sequential_module)
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module, params_from_jax
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "DataParallelExecutorGroup", "params_from_jax", "base_module",
           "module", "bucketing_module", "sequential_module",
           "executor_group"]
