"""Module API: symbolic training (reference ``python/mxnet/module/``), the
port of ``mxnet_tpu/module/``'s ``BaseModule``, ``Module`` and
``DataParallelExecutorGroup`` on one context, plus
:func:`params_from_jax`."""
from . import base_module, executor_group, module
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module, params_from_jax

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup",
           "params_from_jax", "base_module", "module", "executor_group"]
