"""Convolutional RNN cells: the port of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py`` (``Conv1D``/``2D``/
``3D`` x ``RNN``/``LSTM``/``GRU`` cells). Each step is two
``Convolution`` ops (input to hidden, hidden to hidden, the latter
padded to keep the spatial size) and the gates, eagerly through the
port's ``nd`` ops; on the card the convolutions are cuDNN's."""
from __future__ import annotations

import numpy as np

from ....base import MXNetError
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = [
    "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
    "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
    "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
]


def _tup(v, n):
    return (v,) * n if isinstance(v, (int, np.integer)) else tuple(v)


class _BaseConvRNNCell(HybridRecurrentCell):
    """The weights, the state shapes and the two convolutions of a step."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation
        self._dims = dims
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError("Only support odd numbers, got h2h_kernel= "
                                 "%s" % str(h2h_kernel))
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        in_channels = input_shape[0 if conv_layout.startswith("NC") else -1]
        ng = len(self._gate_names)
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(ng * hidden_channels, in_channels) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(ng * hidden_channels, hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ng * hidden_channels,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ng * hidden_channels,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def _spatial_out(self):
        spatial = self._input_shape[1:] \
            if self._conv_layout.startswith("NC") else self._input_shape[:-1]
        return tuple(s + 2 * p - d * (k - 1) for s, k, p, d in
                     zip(spatial, self._i2h_kernel, self._i2h_pad,
                         self._i2h_dilate))

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._spatial_out()
        return [{"shape": shape, "__layout__": self._conv_layout}
                for _ in range(self._num_states)]

    def _conv_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                      i2h_bias, h2h_bias):
        nf = len(self._gate_names) * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel,
                            stride=(1,) * self._dims, pad=self._i2h_pad,
                            dilate=self._i2h_dilate, num_filter=nf,
                            layout=self._conv_layout)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel,
                            stride=(1,) * self._dims, pad=self._h2h_pad,
                            dilate=self._h2h_dilate, num_filter=nf,
                            layout=self._conv_layout)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    _gate_names = ("",)
    _num_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    _gate_names = ("_i", "_f", "_c", "_o")
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        gates = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.Activation(gates[0], act_type="sigmoid")
        forget_gate = F.Activation(gates[1], act_type="sigmoid")
        in_transform = self._get_activation(F, gates[2], self._activation)
        out_gate = F.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _gate_names = ("_r", "_z", "_o")
    _num_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = self._get_activation(F, i2h + reset_gate * h2h,
                                          self._activation)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]


def _make_cells():
    out = {}
    for dims, name in ((1, "Conv1D"), (2, "Conv2D"), (3, "Conv3D")):
        layout = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[dims]
        for base, suffix in ((_ConvRNNCell, "RNNCell"),
                             (_ConvLSTMCell, "LSTMCell"),
                             (_ConvGRUCell, "GRUCell")):
            def make_init(dims=dims, layout=layout):
                def __init__(self, input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad=0, i2h_dilate=1,
                             h2h_dilate=1, i2h_weight_initializer=None,
                             h2h_weight_initializer=None,
                             i2h_bias_initializer="zeros",
                             h2h_bias_initializer="zeros",
                             conv_layout=layout, activation="tanh",
                             prefix=None, params=None):
                    _BaseConvRNNCell.__init__(
                        self, input_shape, hidden_channels, i2h_kernel,
                        h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                        i2h_weight_initializer, h2h_weight_initializer,
                        i2h_bias_initializer, h2h_bias_initializer, dims,
                        conv_layout, activation, prefix=prefix,
                        params=params)
                return __init__

            out[name + suffix] = type(name + suffix, (base,),
                                      {"__init__": make_init(),
                                       "__module__": __name__})
    return out


globals().update(_make_cells())
