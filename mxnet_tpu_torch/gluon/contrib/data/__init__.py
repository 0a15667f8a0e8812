"""Contrib datasets and samplers: the port of
``mxnet_tpu/gluon/contrib/data/``."""
from . import text  # noqa: F401
from .sampler import IntervalSampler  # noqa: F401

__all__ = ["text", "IntervalSampler"]
