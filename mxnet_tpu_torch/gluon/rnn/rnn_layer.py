"""Fused recurrent layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and ``GRU``
over the ``RNN`` op (``ops/rnn.py``).

Each matrix and bias is a parameter of its own, named as in the JAX
package (``l0_i2h_weight``, ``l0_h2h_bias``, ``r0_...`` for the reverse
direction), and packed at each forward into the op's flat vector in the
cuDNN order (every weight, layer-major and direction-minor, i2h then
h2h; then every bias in the same order).  The first layer's input size
may be left to the first forward (``input_size=0``).  ``layer(x)``
returns the output; ``layer(x, states)`` returns (output, new states).
States left out are zeros in the input's dtype.  Dropout between layers
draws from the trace scope's generator in training.  Hybridized, the
layer is captured per signature like every other block (under
``autograd.record()`` as a forward and a backward graph).
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ..block import HybridBlock, trace_generator, train_mode

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        self._mode = mode
        super().__init__(prefix, params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout}; must be TNC or NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        g = self._gates
        with self.name_scope():
            for layer in range(num_layers):
                for d in range(self._dir):
                    s = "l" if d == 0 else "r"
                    in_sz = input_size if layer == 0 \
                        else hidden_size * self._dir
                    for name, shape, init, deferred in (
                            ("i2h_weight", (g * hidden_size, in_sz),
                             i2h_weight_initializer, True),
                            ("h2h_weight", (g * hidden_size, hidden_size),
                             h2h_weight_initializer, False),
                            ("i2h_bias", (g * hidden_size,),
                             i2h_bias_initializer, False),
                            ("h2h_bias", (g * hidden_size,),
                             h2h_bias_initializer, False)):
                        full = f"{s}{layer}_{name}"
                        setattr(self, full, self.params.get(
                            full, shape=shape, init=init,
                            allow_deferred_init=deferred))

    def _alias(self):
        return self._mode

    def state_info(self, batch_size=0):
        info = {"shape": (self._num_layers * self._dir, batch_size,
                          self._hidden_size), "__layout__": "LNC"}
        return [info, dict(info)] if self._mode == "lstm" else [info]

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        from ... import ndarray as nd

        if func is None:
            func = nd.zeros
        return [func(tuple(info["shape"]), ctx=ctx, **kwargs)
                for info in self.state_info(batch_size)]

    def _infer_param_shapes(self, x, *args):
        for d in range(self._dir):
            s = "l" if d == 0 else "r"
            self._set_shape(f"{s}0_i2h_weight",
                            (self._gates * self._hidden_size,
                             int(x.shape[-1])))

    def _ordered_params(self):
        """The cuDNN packing: every weight (layer-major, direction-minor,
        i2h then h2h), then every bias."""
        names = []
        for kind in ("weight", "bias"):
            for layer in range(self._num_layers):
                for d in range(self._dir):
                    s = "l" if d == 0 else "r"
                    names += [f"{s}{layer}_i2h_{kind}",
                              f"{s}{layer}_h2h_{kind}"]
        return names

    def hybrid_forward(self, F, inputs, states=None):
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(inputs.shape[1])]
        if not isinstance(states, (list, tuple)):
            states = [states]
        packed = torch.cat([self._value(n).reshape(-1)
                            for n in self._ordered_params()])
        train = train_mode(self)
        gen = trace_generator() if self._dropout > 0 and train else None
        res = F.RNN(inputs, packed, states[0],
                    states[1] if self._mode == "lstm" else None, gen,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True, train=train)
        out, out_states = res[0], list(res[1:])
        if self._layout == "NTC":
            out = out.swapaxes(0, 1)
        return out if skip_states else (out, out_states)


class RNN(_RNNLayer):
    """A tanh or relu recurrence (``activation``)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         "rnn_relu" if activation == "relu" else "rnn_tanh",
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
