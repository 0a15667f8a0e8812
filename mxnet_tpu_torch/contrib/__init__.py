"""Experimental / contrib packages (reference ``python/mxnet/contrib/``):
the port has :mod:`.torch_bridge` and :mod:`.text`'s ``Vocabulary``."""
from . import text, torch_bridge  # noqa: F401

__all__ = ["text", "torch_bridge"]
