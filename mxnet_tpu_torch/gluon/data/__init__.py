"""Gluon data API: the port of ``mxnet_tpu/gluon/data/`` (datasets,
samplers, ``DataLoader``, and ``vision``'s datasets and transforms)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import dataset, sampler, dataloader, vision  # noqa: F401
