"""Experimental / contrib packages (reference ``python/mxnet/contrib/``):
the port has :mod:`.quantization` (``quantize_model``), :mod:`.torch_bridge`
and :mod:`.text`'s ``Vocabulary``."""
from . import quantization, text, torch_bridge  # noqa: F401

__all__ = ["quantization", "text", "torch_bridge"]
