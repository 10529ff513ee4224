"""Symbolic RNN cells of ``mx.rnn``.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py``: ``RNNParams``, the
``BaseRNNCell`` protocol (``unroll``, ``begin_state``,
``unpack_weights``/``pack_weights``), ``RNNCell``, ``LSTMCell``,
``GRUCell``, ``FusedRNNCell`` over the ``RNN`` op with ``unfuse``, and the
``SequentialRNNCell``, ``BidirectionalCell``, ``DropoutCell``,
``ResidualCell`` and ``ZoneoutCell`` wrappers.  Each builds a ``Symbol``
graph as the JAX package's does, node for node, so a
``BucketingModule``'s buckets bind the same parameters in both packages:
the per-step cells unroll into ``FullyConnected`` and gate nodes, the
fused cell into one ``RNN`` node (cuDNN's RNN on the card).  Initial
states default to zeros whose batch size follows the first input step.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell"]


class RNNParams(object):
    """Container of shared symbol variables (ref rnn_cell.py:RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._vars = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._vars:
            self._vars[full] = sym.var(full, **kwargs)
        return self._vars[full]


def _zero_state_like(step, width):
    """A (batch, width) zeros symbol whose batch dim follows *step*'s.

    Built from graph ops (sum-to-column × zero row) because symbol-time
    shapes don't know the batch size yet — the reference gets the same
    effect from 0-dim shape inference.
    """
    column = sym.sum(step * 0.0, axis=1, keepdims=True)     # (N, 1) zeros
    row = sym.zeros((1, width))
    return sym.broadcast_add(column, row)


def _slice_steps(inputs, length, layout):
    """Split a merged (N, T, C) / (T, N, C) symbol into per-step symbols."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    t_axis = layout.find("T")
    parts = sym.SliceChannel(inputs, num_outputs=length, axis=t_axis,
                             squeeze_axis=1)
    return [parts[i] for i in range(length)]


def _merge_steps(outputs, layout):
    t_axis = layout.find("T")
    expanded = [sym.expand_dims(o, axis=t_axis) for o in outputs]
    return sym.concat(*expanded, dim=t_axis)


class BaseRNNCell(object):
    """Symbolic recurrent-cell protocol (ref rnn_cell.py:BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._own_params = params is None
        self.params = params if params is not None else RNNParams(prefix)
        self._modified = False
        self.reset()

    def reset(self):
        self._counter = -1
        self._init_counter = -1

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    def begin_state(self, func=None, **kwargs):
        """Zero initial states; symbolic default derives batch-shaped zeros
        lazily inside unroll (func overrides)."""
        if self._modified:
            raise MXNetError("call begin_state on the outermost modifier")
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if func is not None:
                spec = dict(info)
                spec.pop("__layout__", None)
                spec.update(kwargs)
                states.append(func(**spec))
            else:
                states.append(("__zeros__", info["shape"][-1]))
        return states

    def _materialize_states(self, states, step):
        """Resolve lazy ("__zeros__", width) placeholders against the first
        input step symbol."""
        out = []
        for s in states:
            if isinstance(s, tuple) and len(s) == 2 and s[0] == "__zeros__":
                out.append(_zero_state_like(step, s[1]))
            else:
                out.append(s)
        return out

    def __call__(self, inputs, states):
        raise NotImplementedError()

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Build the length-step graph (ref rnn_cell.py:unroll)."""
        self.reset()
        steps = _slice_steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state()
        states = self._materialize_states(begin_state, steps[0])
        outputs = []
        for x in steps[:length]:
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs:
            return _merge_steps(outputs, layout), states
        return outputs, states

    def unpack_weights(self, args):
        return dict(args)

    def pack_weights(self, args):
        return dict(args)


class _GatedSymCell(BaseRNNCell):
    """Shared template for RNN/LSTM/GRU symbolic cells: owns the i2h/h2h
    parameter variables and the fused projections."""

    num_gates = 1
    num_states = 1

    def __init__(self, num_hidden, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % self._alias()
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        for tag in ("i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias"):
            setattr(self, "_" + tag, self.params.get(tag))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}
                for _ in range(self.num_states)]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        wide = self.num_gates * self._num_hidden
        i2h = sym.FullyConnected(inputs, self._i2h_weight, self._i2h_bias,
                                 num_hidden=wide, name=name + "i2h")
        h2h = sym.FullyConnected(states[0], self._h2h_weight, self._h2h_bias,
                                 num_hidden=wide, name=name + "h2h")
        return self._transition(i2h, h2h, states, name)

    def _transition(self, i2h, h2h, states, name):
        raise NotImplementedError()


class RNNCell(_GatedSymCell):
    """Elman cell (ref rnn_cell.py:RNNCell)."""

    num_gates = 1

    def __init__(self, num_hidden, activation="tanh", prefix=None,
                 params=None):
        super().__init__(num_hidden, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def _transition(self, i2h, h2h, states, name):
        out = sym.Activation(i2h + h2h, act_type=self._activation,
                             name=name + "out")
        return out, [out]


class LSTMCell(_GatedSymCell):
    """LSTM cell, gate order i,f,g,o (ref rnn_cell.py:LSTMCell)."""

    num_gates = 4
    num_states = 2

    def __init__(self, num_hidden, prefix=None, params=None,
                 forget_bias=1.0):
        super().__init__(num_hidden, prefix, params)
        self._forget_bias = forget_bias

    def _alias(self):
        return "lstm"

    def _transition(self, i2h, h2h, states, name):
        pre = i2h + h2h
        gates = sym.SliceChannel(pre, num_outputs=4, name=name + "slice")
        i = sym.Activation(gates[0], act_type="sigmoid")
        f = sym.Activation(gates[1] + self._forget_bias, act_type="sigmoid")
        g = sym.Activation(gates[2], act_type="tanh")
        o = sym.Activation(gates[3], act_type="sigmoid")
        c = f * states[1] + i * g
        h = o * sym.Activation(c, act_type="tanh")
        return h, [h, c]


class GRUCell(_GatedSymCell):
    """GRU cell, gate order r,z,n (ref rnn_cell.py:GRUCell)."""

    num_gates = 3

    def _alias(self):
        return "gru"

    def _transition(self, i2h, h2h, states, name):
        ir, iz, in_ = [sym.SliceChannel(i2h, num_outputs=3)[k]
                       for k in range(3)]
        hr, hz, hn = [sym.SliceChannel(h2h, num_outputs=3)[k]
                      for k in range(3)]
        r = sym.Activation(ir + hr, act_type="sigmoid")
        z = sym.Activation(iz + hz, act_type="sigmoid")
        cand = sym.Activation(in_ + r * hn, act_type="tanh")
        out = (1.0 - z) * cand + z * states[0]
        return out, [out]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused cell over the ``RNN`` op (ref
    rnn_cell.py:FusedRNNCell): ``unroll`` consumes the merged sequence in
    one op call instead of per-step graphs."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._param = self.params.get("parameters")

    def _alias(self):
        return self._mode

    @property
    def state_info(self):
        d = 2 if self._bidirectional else 1
        shape = (d * self._num_layers, 0, self._num_hidden)
        infos = [{"shape": shape, "__layout__": "LNC"}]
        if self._mode == "lstm":
            infos.append({"shape": shape, "__layout__": "LNC"})
        return infos

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if isinstance(inputs, (list, tuple)):
            inputs = _merge_steps(list(inputs), layout)
        if layout == "NTC":                     # RNN op wants time-major
            inputs = sym.swapaxes(inputs, dim1=0, dim2=1)

        if begin_state is None:
            d = 2 if self._bidirectional else 1
            width = self._num_hidden
            anchor = sym.sum(inputs * 0.0, axis=[0, 2], keepdims=False)
            # anchor: (N,) zeros → (L*d, N, H) zeros
            state0 = sym.broadcast_add(
                sym.reshape(anchor, shape=(1, -1, 1)),
                sym.zeros((d * self._num_layers, 1, width)))
            states = [state0, state0] if self._mode == "lstm" else [state0]
        else:
            states = begin_state

        args = [inputs, self._param] + list(states)
        out = sym.RNN(*args, state_size=self._num_hidden,
                      num_layers=self._num_layers,
                      bidirectional=self._bidirectional, mode=self._mode,
                      p=self._dropout, state_outputs=self._get_next_state,
                      name=self._prefix + "rnn")
        if self._get_next_state:
            outputs = out[0]
            next_states = [out[i] for i in range(1, len(self.state_info) + 1)]
        else:
            outputs, next_states = out, []
        if layout == "NTC":
            outputs = sym.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            t_axis = layout.find("T")
            parts = sym.SliceChannel(outputs, num_outputs=length, axis=t_axis,
                                     squeeze_axis=1)
            outputs = [parts[i] for i in range(length)]
        return outputs, next_states

    def unfuse(self):
        """Equivalent stack of unfused cells (ref rnn_cell.py:unfuse)."""
        stack = SequentialRNNCell()
        make = {"rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
                "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
                "lstm": lambda p: LSTMCell(self._num_hidden, p),
                "gru": lambda p: GRUCell(self._num_hidden, p)}[self._mode]
        for layer in range(self._num_layers):
            prefix = "%sl%d_" % (self._prefix, layer)
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make(prefix + "l_"), make(prefix + "r_")))
            else:
                stack.add(make(prefix))
            if self._dropout > 0 and layer != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                layer)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Vertical stack of cells (ref rnn_cell.py:SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        if self._modified:
            raise MXNetError("call begin_state on the outermost modifier")
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def _per_cell_states(self, states):
        at = 0
        for cell in self._cells:
            width = len(cell.state_info)
            yield cell, states[at:at + width]
            at += width

    def __call__(self, inputs, states):
        self._counter += 1
        collected = []
        states = self._materialize_states(states, inputs)
        for cell, sub in self._per_cell_states(states):
            inputs, sub = cell(inputs, sub)
            collected += sub
        return inputs, collected

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        seq = inputs
        collected = []
        last = len(self._cells) - 1
        for pos, (cell, sub) in enumerate(
                self._per_cell_states(begin_state)):
            seq, sub = cell.unroll(
                length, inputs=seq, begin_state=sub, layout=layout,
                merge_outputs=merge_outputs if pos == last else None)
            collected += sub
        return seq, collected


class BidirectionalCell(BaseRNNCell):
    """Two cells over opposite directions (ref rnn_cell.py:
    BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params)
        self._l_cell, self._r_cell = l_cell, r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, **kwargs):
        return (self._l_cell.begin_state(**kwargs)
                + self._r_cell.begin_state(**kwargs))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps = _slice_steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state()
        split = len(self._l_cell.state_info)
        fwd, fwd_states = self._l_cell.unroll(
            length, steps, begin_state[:split], layout, merge_outputs=False)
        bwd, bwd_states = self._r_cell.unroll(
            length, steps[::-1], begin_state[split:], layout,
            merge_outputs=False)
        joined = [sym.concat(f, b, dim=1,
                             name="%sout%d" % (self._output_prefix, t))
                  for t, (f, b) in enumerate(zip(fwd, bwd[::-1]))]
        if merge_outputs:
            return _merge_steps(joined, layout), fwd_states + bwd_states
        return joined, fwd_states + bwd_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout pseudo-cell (ref rnn_cell.py:DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        self._counter += 1
        if self.dropout > 0:
            inputs = sym.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Wrap-and-share-params base (ref rnn_cell.py:ModifierCell)."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise MXNetError("cell is already modified")
        base_cell._modified = True
        super().__init__(base_cell._prefix + "mod_", params=base_cell.params)
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(**kwargs)
        finally:
            self.base_cell._modified = True


class ResidualCell(ModifierCell):
    """output = cell(input) + input (ref rnn_cell.py:ResidualCell)."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout over outputs/states (ref rnn_cell.py:ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)

        def mixed(p, new, old):
            mask = sym.Dropout(sym.ones_like(new), p=p)
            return sym.where(mask, new, old)

        prior = self._prev_output if self._prev_output is not None \
            else sym.zeros_like(out)
        if self.zoneout_outputs > 0:
            out = mixed(self.zoneout_outputs, out, prior)
        if self.zoneout_states > 0:
            new_states = [mixed(self.zoneout_states, ns, os)
                          for ns, os in zip(new_states, states)]
        self._prev_output = out
        return out, new_states
