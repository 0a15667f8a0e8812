"""Gluon recurrent cells and layers, the port of
``mxnet_tpu/gluon/rnn/`` (reference ``python/mxnet/gluon/rnn/``)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
from . import rnn_cell
from . import rnn_layer
