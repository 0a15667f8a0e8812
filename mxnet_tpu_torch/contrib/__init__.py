"""Experimental / contrib packages (reference ``python/mxnet/contrib/``):
the port has :mod:`.torch_bridge`."""
from . import torch_bridge  # noqa: F401

__all__ = ["torch_bridge"]
