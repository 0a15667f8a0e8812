"""Vision datasets and transforms: the port of
``mxnet_tpu/gluon/data/vision/``."""
from .datasets import *  # noqa: F401,F403
from . import datasets, transforms  # noqa: F401
