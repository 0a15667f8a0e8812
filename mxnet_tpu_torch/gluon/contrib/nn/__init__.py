"""Gluon contrib layers (the port of ``mxnet_tpu/gluon/contrib/nn/``)."""
from . import basic_layers
from .basic_layers import *  # noqa: F401,F403
