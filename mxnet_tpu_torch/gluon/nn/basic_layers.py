"""Basic Gluon layers: the port of the part of
``mxnet_tpu/gluon/nn/basic_layers.py`` the GPT and ResNet paths use:
Sequential, HybridSequential, Dense, Activation, Dropout, BatchNorm,
Embedding, Flatten and LayerNorm; for the vision zoo's relatives
InstanceNorm, Lambda and HybridLambda."""
from __future__ import annotations

import numpy as np
import torch

from ... import autograd
from ...base import MXNetError
from ...ndarray.ndarray import NDArray
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "Embedding", "Flatten", "LayerNorm",
           "InstanceNorm", "Lambda", "HybridLambda"]


class Sequential(Block):
    """Stack of Blocks run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __len__(self):
        return len(self._children)


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __len__(self):
        return len(self._children)


class Dense(HybridBlock):
    """Fully-connected layer; weight (units, in_units), in_units deferred
    to the first forward when 0."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def shape_hint(self, x, *args):
        if self.weight.shape[1] == 0:
            in_units = int(np.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act


class Activation(HybridBlock):
    """Activation layer."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """Dropout at ``rate``; ``axes`` share one draw (basic_layers.py:174)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes or None)


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics (basic_layers.py:190).

    In train mode (``autograd.record()`` or ``train_mode()``) the moving
    mean and variance become ``momentum * moving + (1 - momentum) *
    batch``, with the batch's biased variance, as in the JAX package. They
    are written in place into the parameters' tensors, so their addresses
    stay fixed: a captured step (``parallel.TrainStep``) replays the
    update into the same memory. A symbolic trace gets the op's one
    output and leaves the statistics to the graph's auxiliary states. In bfloat16 (after ``cast``) the batch
    statistics and the moving ones are bfloat16, as ``jnp.mean`` and
    ``jnp.var`` of bfloat16 give. The recompute of a ``remat`` step leaves
    them alone: the first forward moved them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True, differentiable=scale)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True, differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def shape_hint(self, x, *args):
        if self.gamma.shape[0] == 0:
            ch = x.shape[self._axis]
            for p in (self.gamma, self.beta, self.running_mean,
                      self.running_var):
                p.shape = (ch,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out = F.invoke("BatchNorm", x, gamma, beta, running_mean,
                       running_var, **self._kwargs)
        if not isinstance(x, NDArray):
            return out  # a symbolic trace: one output, the stats are aux
        y, mean, var = out
        if autograd.is_training() and not self._kwargs["use_global_stats"] \
                and not autograd.is_recomputing():
            m = self._momentum
            with torch.no_grad():
                for run, batch in ((running_mean, mean),
                                   (running_var, var)):
                    run._data.copy_(m * run._data + (1 - m) * batch._data)
        return y


class Embedding(HybridBlock):
    """Index -> vector lookup; weight (input_dim, output_dim)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim),
            init=weight_initializer, dtype=dtype, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class Flatten(HybridBlock):
    """Flatten to (batch, -1) (basic_layers.py:285)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis``; gamma/beta deferred."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def shape_hint(self, x, *args):
        if self.gamma.shape[0] == 0:
            ch = x.shape[self._axis]
            self.gamma.shape = (ch,)
            self.beta.shape = (ch,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.invoke("LayerNorm", x, gamma, beta, axis=self._axis,
                        eps=self._epsilon)[0]


class InstanceNorm(HybridBlock):
    """Instance normalization over ``axis`` (basic_layers.py:295): the
    ``InstanceNorm`` op with the channels moved to axis 1 and back; gamma
    takes no gradient unless ``scale``, beta none unless ``center``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def shape_hint(self, x, *args):
        if self.gamma.shape[0] == 0:
            ch = x.shape[self._axis]
            self.gamma.shape = (ch,)
            self.beta.shape = (ch,)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


def _nd_function(name):
    from ... import ndarray as nd

    if not hasattr(nd, name):
        raise MXNetError("Function name %s is not found in ndarray." % name)
    return getattr(nd, name)


class Lambda(Block):
    """A function (or the name of an ``nd`` function) as a Block
    (basic_layers.py:374)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_impl = _nd_function(function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: {} of type {}"
                             .format(function, type(function)))

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._func_name)


class HybridLambda(HybridBlock):
    """``function(F, x, *args)`` (or the name of an ``F`` function) as a
    HybridBlock (basic_layers.py:401)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            impl = _nd_function(function)
            self._func = lambda F, *args: impl(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: {} of type {}"
                             .format(function, type(function)))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._func_name)
