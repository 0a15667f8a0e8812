"""Contrib RNN cells: the port of ``mxnet_tpu/gluon/contrib/rnn/``."""
from .conv_rnn_cell import *  # noqa: F401,F403
from .rnn_cell import *  # noqa: F401,F403
from . import conv_rnn_cell, rnn_cell  # noqa: F401
