"""Gluon neural-network layers (the port's part of
``mxnet_tpu/gluon/nn/``)."""
from . import activations, basic_layers, conv_layers
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
