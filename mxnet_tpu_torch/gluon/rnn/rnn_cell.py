"""Recurrent cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``):
``RecurrentCell`` (``state_info``, ``begin_state``, ``unroll``),
``RNNCell``, ``LSTMCell``, ``GRUCell``, ``SequentialRNNCell``,
``BidirectionalCell``, ``DropoutCell``, ``ZoneoutCell`` and
``ResidualCell``.

A cell is a ``HybridBlock`` stepped as ``cell(x, states) -> (out,
new_states)`` on tensors, or on NDArrays through the NDArray entry
point (``states`` a list of them).  ``unroll`` steps it ``length``
times over NTC or TNC inputs (a tensor, or a list of per-step ones);
with ``valid_length`` the outputs at or past each sequence's length are
zeros, as in the JAX package (the states are not masked).  Without
``begin_state`` the states are zeros whose batch is dim 0 of the first
step's input in either layout, the JAX package's rule: zeros of the
input's dtype on its device for tensors, float32 ``nd.zeros`` on its
context for NDArrays.  Gate layouts: LSTM [i, f, g, o], GRU [r, z, n],
each cell one i2h and one h2h projection.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import tensor as _t
from ..block import (HybridBlock, _call_on_ndarrays, _ndarrays_in,
                     trace_generator, train_mode)

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "BidirectionalCell", "DropoutCell", "ZoneoutCell", "ResidualCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(inputs, layout):
    """The per-step tensors of ``inputs`` and the time axis."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        return list(inputs), axis
    return list(inputs.unbind(axis)), axis


def _zeros_like_step(x):
    """``begin_state``'s ``func`` for tensor inputs: zeros of the step's
    dtype on its device."""
    def zeros(shape, ctx=None, **kwargs):
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return zeros


def _finish(outputs, axis, merge_outputs, valid_length):
    """The JAX package's tail of ``unroll``: masked by ``valid_length``
    (merged unless ``merge_outputs`` is False), else merged only when
    ``merge_outputs``."""
    if valid_length is not None:
        stacked = _t.sequence_mask(torch.stack(outputs, axis), valid_length,
                                   use_sequence_length=True, axis=axis)
        if merge_outputs is False:
            return list(stacked.unbind(axis))
        return stacked
    if merge_outputs:
        return torch.stack(outputs, axis)
    return outputs


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for c in self.children():
            if hasattr(c, "reset"):
                c.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """One state per ``state_info`` entry, made by ``func`` (default
        ``nd.zeros`` on ``ctx``)."""
        from ... import ndarray as nd

        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(tuple(info["shape"]), ctx=ctx, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """(outputs, states) of ``length`` steps (see the module
        docstring); NDArrays in, NDArrays out."""
        kw = dict(begin_state=begin_state, layout=layout,
                  merge_outputs=merge_outputs, valid_length=valid_length)
        if _ndarrays_in([inputs, begin_state, valid_length]):
            return _call_on_ndarrays(self, (length, inputs), kw,
                                     method=self._unroll_nd)
        return self._unroll(length, inputs, **kw)

    def _unroll_nd(self, length, inputs, begin_state=None, **kw):
        """The unroll of NDArray inputs on their tensors: default states
        are ``nd.zeros`` (float32) on the inputs' device."""
        if begin_state is None:
            steps, _ = _format_sequence(inputs, kw["layout"])
            begin_state = [s._data for s in self.begin_state(
                batch_size=steps[0].shape[0], ctx=steps[0].device)]
        return self._unroll(length, inputs, begin_state=begin_state, **kw)

    def _unroll(self, length, inputs, begin_state=None, layout="NTC",
                merge_outputs=None, valid_length=None):
        self.reset()
        steps, axis = _format_sequence(inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=steps[0].shape[0],
                                           func=_zeros_like_step(steps[0]))
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(steps[i], states)
            outputs.append(output)
        return _finish(outputs, axis, merge_outputs, valid_length), states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)

    def _alias(self):
        return "rnn"


HybridRecurrentCell = RecurrentCell


class _GatedCell(RecurrentCell):
    """A cell with one i2h and one h2h projection of ``gates`` gates."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = self._gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g,), init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _infer_param_shapes(self, x, *args):
        self._set_shape("i2h_weight", (self._gates * self._hidden_size,
                                       int(x.shape[-1])))

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        slices = F.split(i2h + h2h, num_outputs=4, axis=1)
        i = F.sigmoid(slices[0])
        f = F.sigmoid(slices[1])
        g = F.tanh(slices[2])
        o = F.sigmoid(slices[3])
        c = f * states[1] + i * g
        h = o * F.tanh(c)
        return h, [h, c]


class GRUCell(_GatedCell):
    _gates = 3

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev = states[0]
        i2h, h2h = self._projections(F, inputs, prev, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(i2h_r + h2h_r)
        z = F.sigmoid(i2h_z + h2h_z)
        n = F.tanh(i2h_n + r * h2h_n)
        h = (1 - z) * n + z * prev
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self.children(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self.children(), **kwargs)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self.children())[i]

    def hybrid_forward(self, F, inputs, states):
        next_states = []
        p = 0
        for cell in self.children():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states


HybridSequentialRNNCell = SequentialRNNCell


def _dropout(F, block, x, p, axes=()):
    return F.dropout(x, p=p, train=train_mode(block),
                     generator=trace_generator(), axes=tuple(axes))


class DropoutCell(RecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = _dropout(F, self, inputs, self._rate, self._axes)
        return inputs, states


class ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + self._alias() + "_",
                         params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)


class ZoneoutCell(ModifierCell):
    """Each output (state) kept from the step before with probability
    ``zoneout_outputs`` (``zoneout_states``) in training, through a
    dropout mask of ones."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if self.zoneout_outputs > 0:
            mask = _dropout(F, self, torch.ones_like(next_output),
                            self.zoneout_outputs)
            prev = self._prev_output if self._prev_output is not None \
                else torch.zeros_like(next_output)
            next_output = F.where(mask, next_output, prev)
        if self.zoneout_states > 0:
            next_states = [
                F.where(_dropout(F, self, torch.ones_like(ns),
                                 self.zoneout_states), ns, s)
                for ns, s in zip(next_states, states)]
        self._prev_output = next_output
        return next_output, next_states


class ResidualCell(ModifierCell):
    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence and its reverse, their outputs
    concatenated per step; it cannot be stepped, only unrolled.  As in
    the JAX package, the right cell reads the list of steps reversed
    whatever ``valid_length`` says."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        return _cells_state_info(self.children(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self.children(), **kwargs)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll()")

    def _unroll(self, length, inputs, begin_state=None, layout="NTC",
                merge_outputs=None, valid_length=None):
        self.reset()
        steps, axis = _format_sequence(inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=steps[0].shape[0],
                                           func=_zeros_like_step(steps[0]))
        l_cell, r_cell = self.children()
        n_l = len(l_cell.state_info())
        l_out, l_states = l_cell._unroll(length, steps, begin_state[:n_l],
                                         layout, False, valid_length)
        r_out, r_states = r_cell._unroll(length, steps[::-1],
                                         begin_state[n_l:], layout, False,
                                         valid_length)
        outputs = [torch.cat([lo, ro], 1)
                   for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outputs = torch.stack(outputs, axis)
        return outputs, l_states + r_states
