"""Gluon fused recurrent layers: ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``: ``_RNNLayer`` holds
each layer's and direction's ``i2h``/``h2h`` weights and biases as
Parameters (layer 0's ``i2h`` weight deferred until the input's width is
known), packs them in the ``RNN`` op's layout on each call (a
concatenation: a copy of every weight) and runs the op, cuDNN's RNN on
the card.  As in the JAX package the layer is not hybridizable:
``hybrid_forward`` raises, and ``hybridize()`` leaves it eager.
"""
from __future__ import annotations

from ..block import HybridBlock
from ... import ndarray as nd
from ...ops.nn import rnn_param_size, _gates

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base fused RNN layer (reference rnn_layer.py:33)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super(_RNNLayer, self).__init__(**kwargs)
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

        self._gates = _gates(mode)
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param(
                    "{}{}_i2h_weight".format(j, i), (ng * nh, ni),
                    i2h_weight_initializer)
                self._register_param(
                    "{}{}_h2h_weight".format(j, i), (ng * nh, nh),
                    h2h_weight_initializer)
                self._register_param(
                    "{}{}_i2h_bias".format(j, i), (ng * nh,),
                    i2h_bias_initializer)
                self._register_param(
                    "{}{}_h2h_bias".format(j, i), (ng * nh,),
                    h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
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
        if func is None:
            func = nd.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            info = dict(info)
            info.pop("__layout__", None)
            info.update(kwargs)
            states.append(func(**info))
        return states

    def _collect_ordered_params(self):
        """Pack parameters in the fused op's flat layout
        (per layer, per dir: i2h_W, h2h_W, i2h_b, h2h_b)."""
        flat = []
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                for t in ["i2h_weight", "h2h_weight", "i2h_bias",
                          "h2h_bias"]:
                    p = getattr(self, "{}{}_{}".format(j, i, t))
                    flat.append(p.data().reshape((-1,)))
        return nd.concat(*flat, dim=0)

    def forward(self, inputs, states=None):
        batch_size = inputs.shape[self._layout.find("N")]
        # finish deferred init: layer-0 i2h shape depends on input channels
        in_size = inputs.shape[2]
        for j in (["l", "r"] if self._dir == 2 else ["l"]):
            p = getattr(self, "%s0_i2h_weight" % j)
            if p._data is None:
                p._set_shape_if_deferred((self._gates * self._hidden_size,
                                          in_size))
        for param in self.collect_params().values():
            param._finish_deferred_init()
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, nd.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s."
                    % (str(info["shape"]), str(state.shape)))
        out = self._forward_kernel(inputs, states)
        # out is (output, states)
        return out[0] if skip_states else out

    def _forward_kernel(self, inputs, states):
        if self._layout == "NTC":
            inputs = nd.swapaxes(inputs, 0, 1)
        params = self._collect_ordered_params()
        rnn_args = [inputs, params] + states
        outs = nd.RNN(*rnn_args, state_size=self._hidden_size,
                      num_layers=self._num_layers,
                      bidirectional=self._dir == 2,
                      p=self._dropout, state_outputs=True,
                      mode=self._mode)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        output = outs[0]
        if self._layout == "NTC":
            output = nd.swapaxes(output, 0, 1)
        return output, list(outs[1:])

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh/relu (reference rnn_layer.py:244)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super(RNN, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer,
            "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:318)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super(LSTM, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:397)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super(GRU, self).__init__(
            hidden_size, num_layers, layout, dropout, bidirectional,
            input_size, i2h_weight_initializer, h2h_weight_initializer,
            i2h_bias_initializer, h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
