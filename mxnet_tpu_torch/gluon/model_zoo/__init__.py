"""Gluon model zoo (the port of ``mxnet_tpu/gluon/model_zoo/``; no
``model_store``: the port downloads nothing)."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
