"""Gluon contrib: the port of ``mxnet_tpu/gluon/contrib/`` (``nn``,
``rnn`` and ``data``)."""
from . import data, nn, rnn  # noqa: F401

__all__ = ["data", "nn", "rnn"]
