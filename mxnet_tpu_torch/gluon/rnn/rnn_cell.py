"""Gluon RNN cells, the port of ``mxnet_tpu/gluon/rnn/rnn_cell.py``
(reference ``python/mxnet/gluon/rnn/rnn_cell.py``): the RecurrentCell
base (``begin_state``, ``unroll`` in ``NTC`` and ``TNC`` with
``merge_outputs`` and ``valid_length``, ``state_info``), RNNCell,
LSTMCell (gates i, f, c, o), GRUCell (gates r, z, n), SequentialRNNCell,
DropoutCell, ModifierCell, ZoneoutCell, ResidualCell and
BidirectionalCell. A cell's step runs eagerly through the port's ``nd``
ops (``FullyConnected``, ``SliceChannel``, ``Activation``), one call a
step; the fused multi-step path is ``rnn_layer``'s ``RNN`` op.
"""
from __future__ import annotations

from ..block import Block, HybridBlock

__all__ = [
    "RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
    "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
    "ModifierCell", "ZoneoutCell", "ResidualCell", "BidirectionalCell",
]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    """Zero states on the inputs' context (the reference's ``with ctx``),
    unless given."""
    if begin_state is None:
        first = inputs if not isinstance(inputs, (list, tuple)) \
            else inputs[0]
        with first.context:
            begin_state = cell.begin_state(batch_size=batch_size)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize (T,N,C)/(N,T,C)/list inputs (reference rnn_cell.py:_format_sequence)."""
    from ... import ndarray as F
    from ...ndarray.ndarray import NDArray

    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[axis]
            inputs = list(F.SliceChannel(
                inputs, axis=axis, num_outputs=inputs.shape[axis], squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = [i.expand_dims(axis=axis) for i in inputs]
            inputs = F.concat(*inputs, dim=axis)
    return inputs, axis, batch_size


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis, merge):
    assert valid_length is not None
    if not isinstance(data, list):
        outputs = F.SequenceMask(data, valid_length, use_sequence_length=True,
                                 axis=time_axis)
    else:
        outputs = []
        for i, x in enumerate(data):
            mask = (valid_length > i).astype("float32").reshape((-1,) + (1,) * (x.ndim - 1))
            outputs.append(x * mask)
    return outputs


class RecurrentCell(Block):
    """Base RNN cell (reference rnn_cell.py:RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    @property
    def _curr_prefix(self):
        return "%st%d_" % (self.prefix, self._counter)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference rnn_cell.py:begin_state)."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        from ... import ndarray as F

        if func is None:
            func = F.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over `length` steps (reference rnn_cell.py:unroll)."""
        from ... import ndarray as F

        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs, batch_size)

        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            # the lengths go in as the op's second input (the JAX
            # package passes them as an attribute, and its SequenceLast
            # then finds no lengths and raises)
            states = [F.SequenceLast(F.stack(*ele_list, axis=0),
                                     valid_length,
                                     use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(
                F, outputs, length, valid_length, axis, True)
        if merge_outputs:
            outputs = [o.expand_dims(axis=axis) for o in outputs]
            outputs = F.concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """RecurrentCell with hybrid_forward (reference rnn_cell.py:HybridRecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        # a cell's step runs eagerly; the fused multi-step path is the
        # RNN op of rnn_layer
        return self._eager_forward(inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell (reference rnn_cell.py:RNNCell)."""

    def __init__(self, hidden_size, activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def shape_hint(self, x, *args):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell (reference rnn_cell.py:LSTMCell). Gate order i,f,c,o
    matches the reference so packed weights transfer."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def shape_hint(self, x, *args):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4, axis=1)
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell (reference rnn_cell.py:GRUCell). Gate order r,z,n matches
    the reference/cuDNN packing."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def shape_hint(self, x, *args):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells (reference rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        return s.format(name=self.__class__.__name__,
                        modstr="\n".join(
                            "({i}): {m}".format(i=i, m=m)
                            for i, m in self._children.items()))

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._children.values())
        for cell in self._children.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F

        self.reset()
        num_cells = len(self._children)
        _, _, batch_size = _format_sequence(length, inputs, layout, None)
        begin_state = _get_begin_state(self, F, begin_state, inputs, batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on inputs (reference rnn_cell.py:DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float)), "rate must be a number"
        self._rate = rate
        self._axes = axes

    def __repr__(self):
        return "{name}(rate={_rate}, axes={_axes})".format(
            name=self.__class__.__name__, **self.__dict__)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes or None)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F

        self.reset()
        inputs, _, _ = _format_sequence(length, inputs, layout, merge_outputs)
        if not isinstance(inputs, (list, tuple)):
            return self.hybrid_forward(F, inputs, begin_state if begin_state else [])
        return super().unroll(
            length, inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)


class ModifierCell(HybridRecurrentCell):
    """Base for cells that modify another cell (reference rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified twice" \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError

    def __repr__(self):
        return "{name}({base_cell})".format(
            name=self.__class__.__name__, base_cell=self.base_cell)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def __repr__(self):
        return ("{name}(p_out={zoneout_outputs}, p_state={zoneout_states}, "
                "{base_cell})").format(name=self.__class__.__name__, **self.__dict__)

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output, prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Residual connection around a cell (reference rnn_cell.py:ResidualCell)."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F
        from ...ndarray.ndarray import NDArray

        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge_outputs = (isinstance(outputs, NDArray)
                         if merge_outputs is None else merge_outputs)
        inputs, axis, _ = _format_sequence(length, inputs, layout, merge_outputs)
        if valid_length is not None:
            inputs = _mask_sequence_variable_length(
                F, inputs, length, valid_length, axis, merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [o + i for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Run two cells over a sequence in both directions
    (reference rnn_cell.py:BidirectionalCell); supports unroll only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please use unroll")

    def __repr__(self):
        return "{name}(forward={l_cell}, backward={r_cell})".format(
            name=self.__class__.__name__,
            l_cell=self._children["l_cell"],
            r_cell=self._children["r_cell"])

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F

        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout, False)
        if valid_length is None:
            reversed_inputs = list(reversed(inputs))
        else:
            # sequence-length-aware reverse so the backward cell sees each
            # sample's last VALID step first (reference uses F.SequenceReverse
            # with use_sequence_length=True)
            merged = F.concat(*[i.expand_dims(axis=0) for i in inputs], dim=0)
            rev = F.SequenceReverse(merged, valid_length,
                                    use_sequence_length=True, axis=0)
            reversed_inputs = list(F.SliceChannel(
                rev, axis=0, num_outputs=length, squeeze_axis=1))
        begin_state = _get_begin_state(self, F, begin_state, inputs, batch_size)

        states = begin_state
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:len(l_cell.state_info())],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs,
            begin_state=states[len(l_cell.state_info()):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is not None:
            merged_r = F.concat(*[o.expand_dims(axis=0) for o in r_outputs], dim=0)
            rev_r = F.SequenceReverse(merged_r, valid_length,
                                      use_sequence_length=True, axis=0)
            r_outputs = list(F.SliceChannel(
                rev_r, axis=0, num_outputs=length, squeeze_axis=1))
            r_outputs = _mask_sequence_variable_length(
                F, r_outputs, length, valid_length, axis, False)
        else:
            r_outputs = list(reversed(r_outputs))
        outputs = [F.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = [o.expand_dims(axis=axis) for o in outputs]
            outputs = F.concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class HybridSequentialRNNCell(SequentialRNNCell):
    """Hybridizable stack of cells (reference
    rnn_cell.py:HybridSequentialRNNCell). It shares the sequential
    implementation (a port block runs eagerly, hybridized or not); the
    class exists so model code constructing it, and its ``hybridize()``
    calls, run unchanged."""

    def hybridize(self, active=True, **kwargs):
        for cell in self._children.values():
            if hasattr(cell, "hybridize"):
                cell.hybridize(active, **kwargs)
