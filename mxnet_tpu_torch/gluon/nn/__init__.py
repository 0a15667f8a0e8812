"""Gluon neural-network layers (the port's part of
``mxnet_tpu/gluon/nn/``)."""
from . import basic_layers
from .basic_layers import *  # noqa: F401,F403
