"""Gluon contrib (the port of ``mxnet_tpu/gluon/contrib/``, as far as its
``nn`` layers; ``rnn`` and ``data`` are not ported yet)."""
from . import nn

__all__ = ["nn"]
