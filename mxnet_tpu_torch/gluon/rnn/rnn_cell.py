"""Gluon recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: the
``RecurrentCell`` protocol (a step through ``__call__``, a sequence
through ``unroll``, states from ``begin_state``),
``HybridRecurrentCell``, the ``RNNCell``, ``LSTMCell`` and ``GRUCell``
(one ``_GatedCell`` template: the i2h and h2h weights and biases and the
two projections; each cell adds its gate count and its transition, gates
i,f,g,o and r,z,n as the fused ``RNN`` op packs them), and the
``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``, ``ResidualCell``
and ``BidirectionalCell`` wrappers.  ``unroll`` steps the cell in Python,
one small graph a step.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _stack_state_info(cells, batch_size):
    infos = []
    for c in cells:
        infos += c.state_info(batch_size)
    return infos


def _stack_begin_state(cells, **kwargs):
    states = []
    for c in cells:
        states += c.begin_state(**kwargs)
    return states


def _as_step_list(length, inputs, layout):
    """Split a merged [*, T, *] tensor (or pass through a list) into
    per-timestep tensors; returns (steps, time_axis, batch_size)."""
    t_axis = layout.find("T")
    n_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        return list(inputs), t_axis, inputs[0].shape[0 if n_axis == 0 else
                                                     n_axis - 1]
    batch_size = inputs.shape[n_axis]
    steps = nd.SliceChannel(inputs, axis=t_axis,
                            num_outputs=inputs.shape[t_axis],
                            squeeze_axis=1)
    if not isinstance(steps, (list, tuple)):
        steps = [steps]
    return list(steps), t_axis, batch_size


def _merge_steps(outputs, t_axis):
    """Stack per-step outputs back into one tensor along the time axis."""
    expanded = [nd.expand_dims(o, axis=t_axis) for o in outputs]
    return nd.concat(*expanded, dim=t_axis)


class RecurrentCell(Block):
    """Recurrent-cell protocol (ref rnn_cell.py:81): step via __call__,
    whole sequences via :meth:`unroll`, states via :meth:`begin_state`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Allocate initial states per :meth:`state_info`
        (ref rnn_cell.py:129)."""
        if self._modified:
            raise AssertionError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        make = func if func is not None else nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            spec = dict(info or {})
            spec.pop("__layout__", None)
            spec.update(kwargs)
            states.append(make(**spec))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Step the cell ``length`` times (ref rnn_cell.py:177)."""
        self.reset()
        steps, t_axis, batch_size = _as_step_list(length, inputs, layout)
        states = begin_state if begin_state is not None \
            else self.begin_state(batch_size=batch_size)
        outputs = []
        for x in steps[:length]:
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs:
            return _merge_steps(outputs, t_axis), states
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """RecurrentCell whose step is a hybrid_forward (ref rnn_cell.py:270)."""

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """Shared template for RNN/LSTM/GRU cells.

    Owns the four parameter tensors (i2h/h2h × weight/bias), sized by the
    subclass's ``num_gates``, and computes the fused input/hidden
    projections; subclasses implement ``_transition``.
    """

    num_gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        wide = self.num_gates * hidden_size
        for tag, shape, init in (
                ("i2h_weight", (wide, input_size), i2h_weight_initializer),
                ("h2h_weight", (wide, hidden_size), h2h_weight_initializer),
                ("i2h_bias", (wide,), i2h_bias_initializer),
                ("h2h_bias", (wide,), h2h_bias_initializer)):
            setattr(self, tag, self.params.get(tag, shape=shape, init=init,
                                               allow_deferred_init=True))

    def state_info(self, batch_size=0):
        one = {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}
        return [dict(one) for _ in range(self.num_states)]

    num_states = 1

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        wide = self.num_gates * self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=wide)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=wide)
        return self._transition(F, i2h, h2h, states)

    def _transition(self, F, i2h, h2h, states):
        raise NotImplementedError


class RNNCell(_GatedCell):
    """Elman cell: ``h' = act(W_i x + b_i + W_h h + b_h)``
    (ref rnn_cell.py:290)."""

    num_gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def _transition(self, F, i2h, h2h, states):
        out = self._get_activation(F, i2h + h2h, self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """LSTM cell (ref rnn_cell.py:374); packed gate order i,f,g,o matches
    the fused RNN op layout."""

    num_gates = 4
    num_states = 2

    def _alias(self):
        return "lstm"

    def _transition(self, F, i2h, h2h, states):
        pre = i2h + h2h
        gi, gf, gc, go = F.SliceChannel(pre, num_outputs=4)
        i = F.Activation(gi, act_type="sigmoid")
        f = F.Activation(gf, act_type="sigmoid")
        c_tilde = F.Activation(gc, act_type="tanh")
        o = F.Activation(go, act_type="sigmoid")
        c = f * states[1] + i * c_tilde
        h = o * F.Activation(c, act_type="tanh")
        return h, [h, c]


class GRUCell(_GatedCell):
    """GRU cell (ref rnn_cell.py:460); packed gate order r,z,n."""

    num_gates = 3

    def _alias(self):
        return "gru"

    def _transition(self, F, i2h, h2h, states):
        prev = states[0]
        ir, iz, in_ = F.SliceChannel(i2h, num_outputs=3)
        hr, hz, hn = F.SliceChannel(h2h, num_outputs=3)
        r = F.Activation(ir + hr, act_type="sigmoid")
        z = F.Activation(iz + hz, act_type="sigmoid")
        candidate = F.Activation(in_ + r * hn, act_type="tanh")
        h = (1. - z) * candidate + z * prev
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Vertically stacked cells (ref rnn_cell.py:543); states of the
    children are concatenated in order."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _stack_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise AssertionError("call the modifier cell instead")
        return _stack_begin_state(self._children, **kwargs)

    def _split_states(self, states):
        """Yield (cell, its slice of the flat state list)."""
        at = 0
        for cell in self._children:
            width = len(cell.state_info())
            yield cell, states[at:at + width]
            at += width

    def __call__(self, inputs, states):
        self._counter += 1
        collected = []
        for cell, sub in self._split_states(states):
            inputs, sub = cell(inputs, sub)
            collected += sub
        return inputs, collected

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, _, batch_size = _as_step_list(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        seq = steps
        collected = []
        last = len(self._children) - 1
        for pos, (cell, sub) in enumerate(self._split_states(begin_state)):
            seq, sub = cell.unroll(
                length, inputs=seq, begin_state=sub, layout=layout,
                merge_outputs=merge_outputs if pos == last else None)
            collected += sub
        return seq, collected

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args):
        raise NotImplementedError


class ModifierCell(HybridRecurrentCell):
    """Wraps a base cell, sharing its parameters (ref rnn_cell.py:637)."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise AssertionError("Cell %s is already modified."
                                 % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + "_", params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        if self._modified:
            raise AssertionError("call the outermost modifier cell")
        self.base_cell._modified = False
        try:
            if func is not None:
                kwargs["func"] = func
            return self.base_cell.begin_state(**kwargs)
        finally:
            self.base_cell._modified = True

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Stateless input-dropout pseudo-cell (ref rnn_cell.py:594)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        if not isinstance(rate, (int, float)):
            raise TypeError("rate must be a number")
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularisation over the base cell (ref rnn_cell.py:701):
    randomly keep previous outputs/states in place of new ones."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        if isinstance(base_cell, BidirectionalCell):
            raise TypeError(
                "BidirectionalCell doesn't support zoneout. "
                "Please add ZoneoutCell to the cells underneath instead.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        new_out, new_states = self.base_cell(inputs, states)

        def keep_mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prior = self._prev_output
        if prior is None:
            prior = F.zeros_like(new_out)
        out = new_out if self.zoneout_outputs == 0. else \
            F.where(keep_mask(self.zoneout_outputs, new_out), new_out, prior)
        if self.zoneout_states != 0.:
            new_states = [F.where(keep_mask(self.zoneout_states, ns), ns, os)
                          for ns, os in zip(new_states, states)]
        self._prev_output = out
        return out, new_states


class ResidualCell(ModifierCell):
    """output = base_cell(input) + input (ref rnn_cell.py:764)."""

    def hybrid_forward(self, F, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state,
                layout=layout, merge_outputs=merge_outputs)
        finally:
            self.base_cell._modified = True
        steps, t_axis, _ = _as_step_list(length, inputs, layout)
        if isinstance(outputs, (list, tuple)):
            outputs = [o + x for o, x in zip(outputs, steps)]
        else:
            outputs = outputs + _merge_steps(steps, t_axis)
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Forward + reversed cell over the sequence, outputs concatenated
    (ref rnn_cell.py:825). Only ``unroll`` makes sense here."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _stack_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise AssertionError("call the modifier cell instead")
        return _stack_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, t_axis, batch_size = _as_step_list(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        fwd_cell, bwd_cell = self._children
        split = len(fwd_cell.state_info())
        fwd_out, fwd_states = fwd_cell.unroll(
            length, inputs=steps, begin_state=begin_state[:split],
            layout=layout, merge_outputs=False)
        bwd_out, bwd_states = bwd_cell.unroll(
            length, inputs=steps[::-1], begin_state=begin_state[split:],
            layout=layout, merge_outputs=False)
        joined = [nd.concat(f, b, dim=1)
                  for f, b in zip(fwd_out, bwd_out[::-1])]
        if merge_outputs:
            return _merge_steps(joined, t_axis), fwd_states + bwd_states
        return joined, fwd_states + bwd_states
