"""Contrib layers: the port of ``mxnet_tpu/gluon/contrib/nn/
basic_layers.py`` (``:13-102``), whole.

Concurrent and HybridConcurrent run every child on the same input and
concatenate the outputs (Inception's branches); Identity; SparseEmbedding,
which is Embedding with a dense gradient (as in the JAX package); and
SyncBatchNorm, which on the port's one device is BatchNorm (the JAX
package's is BatchNorm on one device too).
"""
from __future__ import annotations

from ...block import Block, HybridBlock
from ...nn import BatchNorm, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class Concurrent(Sequential):
    """Children on the same input, outputs concatenated along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as F

        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis, num_args=len(out))


class HybridConcurrent(HybridSequential):
    """Concurrent as a HybridBlock."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis, num_args=len(out))


class Identity(HybridBlock):
    """Returns its input."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """Embedding whose reference form has a row-sparse gradient; here, as
    in the JAX package, the gradient is dense."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), init=weight_initializer,
            dtype=dtype)

    def forward(self, x):
        from .... import ndarray as F

        return F.Embedding(x, self.weight.data(x.context), **self._kwargs)

    def __repr__(self):
        return "{name}({input_dim} -> {output_dim}, {dtype})".format(
            name=self.__class__.__name__, **self._kwargs)


class SyncBatchNorm(BatchNorm):
    """BatchNorm whose statistics the reference synchronises across
    devices; the port trains on one device, where it is BatchNorm over
    axis 1 (``num_devices`` is accepted and unused)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, **kwargs)
