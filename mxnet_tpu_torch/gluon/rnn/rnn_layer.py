"""Fused recurrent layers: RNN, LSTM, GRU, the port of
``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference
``python/mxnet/gluon/rnn/rnn_layer.py``, ``_RNNLayer`` :32).

A layer packs its parameters, named ``{l,r}{i}_{i2h,h2h}_{weight,bias}``,
into one flat vector through ``_rnn_param_concat`` (MXNet's cuDNN order:
every weight, layer-major then direction-minor with i2h before h2h, then
every bias), and runs the ``RNN`` op on it: cuDNN through torch on the
card, the step loop on the CPU (``ops/nn.py``). The gradient reaches each
Parameter through the concatenation. A deferred ``input_size`` is taken
from the first input. ``TNC`` and ``NTC`` layouts.
"""
from __future__ import annotations

from ..block import HybridBlock
from ..parameter import DeferredInitializationError
from ...ndarray.ndarray import NDArray

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base fused RNN layer (reference rnn_layer.py:_RNNLayer)."""

    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init, allow_deferred_init=True)
        self._reg_params[name] = p
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as F

        if func is None:
            func = F.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **info))
        return states

    def shape_hint(self, x, *args):
        if self.l0_i2h_weight.shape[1] == 0:
            ni = x.shape[2] if self._layout == "TNC" else x.shape[-1]
            for j in ["l", "r"][:self._dir]:
                getattr(self, "%s0_i2h_weight" % j).shape = \
                    (self._gates * self._hidden_size, ni)

    def forward(self, inputs, states=None):
        """Accepts optional states like the reference (block __call__
        signature is (inputs, states=None))."""
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s."
                    % (str(info["shape"]), str(state.shape)))
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def __call__(self, inputs, *states):
        if len(states) == 1 and (states[0] is None or isinstance(states[0], (list, tuple, NDArray))):
            return super().__call__(inputs, states[0] if not isinstance(states[0], NDArray) else [states[0]])
        if not states:
            return super().__call__(inputs, None)
        return super().__call__(inputs, list(states))

    def _forward_kernel(self, inputs, states):
        from ... import ndarray as F

        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        try:
            pdata = {k: p.data(inputs.context) for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(inputs)
            pdata = {k: p.data(inputs.context) for k, p in self._reg_params.items()}

        # pack parameters in reference rnn-inl.h order: all weights
        # (layer-major, direction-minor, i2h then h2h), then all biases
        names_w = []
        names_b = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                names_w += ["{}{}_i2h_weight".format(j, i), "{}{}_h2h_weight".format(j, i)]
                names_b += ["{}{}_i2h_bias".format(j, i), "{}{}_h2h_bias".format(j, i)]
        flat = F.invoke("_rnn_param_concat",
                        *[pdata[n] for n in names_w + names_b],
                        num_args=len(names_w) + len(names_b), dim=0)

        if self._mode == "lstm":
            outputs = F.invoke(
                "RNN", inputs, flat, states[0], states[1],
                state_size=self._hidden_size, num_layers=self._num_layers,
                bidirectional=self._dir == 2, p=self._dropout,
                state_outputs=True, mode=self._mode)
            out, hT, cT = outputs
            states_out = [hT, cT]
        else:
            outputs = F.invoke(
                "RNN", inputs, flat, states[0],
                state_size=self._hidden_size, num_layers=self._num_layers,
                bidirectional=self._dir == 2, p=self._dropout,
                state_outputs=True, mode=self._mode)
            out, hT = outputs
            states_out = [hT]
        if self._layout == "NTC":
            out = out.swapaxes(0, 1)
        return out, states_out

    def _finish_deferred(self, x):
        self.shape_hint(x if self._layout == "TNC" else x.swapaxes(0, 1))
        for p in self._reg_params.values():
            p._finish_deferred_init()


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (reference rnn_layer.py:RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu", layout="TNC",
                 dropout=0, bidirectional=False, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout, bidirectional,
                         input_size, i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size, self._hidden_size),
                 "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout, bidirectional,
                         input_size, i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size, self._hidden_size),
                 "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size, self._hidden_size),
                 "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout, bidirectional,
                         input_size, i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size, self._hidden_size),
                 "__layout__": "LNC"}]
