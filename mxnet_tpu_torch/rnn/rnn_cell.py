"""The legacy symbolic RNN cells (counterpart of
``mxnet_tpu/rnn/rnn_cell.py``), over the port's ``sym``.

Cells compose Symbols: parameters are variables the cell owns
(``{prefix}i2h_weight``, ...) and ``unroll`` lays the time loop out as
one node chain per step.  The gate layouts are gluon.rnn's (one i2h and
one h2h projection; LSTM i, f, g, o; GRU r, z, n), so parameters move
between the two APIs by name.  ``FusedRNNCell`` is one ``RNN`` node
over a flat ``{prefix}parameters`` vector; the unrolled cells are the
compatibility path.  Default begin states are zeros with the batch of
the first step's input, made from it in the graph (``sum(x * 0)``
tiled to the state width), as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional

from ..base import MXNetError
from .. import symbol as sym

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ResidualCell", "FusedRNNCell"]


class BaseRNNCell:
    """Abstract symbolic cell (ref: rnn_cell.py::BaseRNNCell)."""

    def __init__(self, prefix: str = ""):
        self._prefix = prefix
        self._counter = -1
        self._own_params: dict = {}

    # ---- parameters ------------------------------------------------------
    def _param(self, name: str):
        full = self._prefix + name
        if full not in self._own_params:
            self._own_params[full] = sym.Variable(full)
        return self._own_params[full]

    @property
    def params(self) -> List[str]:
        """Names of this cell's parameter symbols."""
        return sorted(self._own_params)

    # ---- states ----------------------------------------------------------
    @property
    def state_info(self):
        raise NotImplementedError

    def reset(self):
        self._counter = -1

    def begin_state(self, like=None, **kwargs):
        """Zeros with the batch of ``like`` (an [N, C] symbol; unroll
        passes the first step's input), one per ``state_info`` entry."""
        if like is None:
            raise MXNetError(
                "begin_state needs `like` (a [N, C] symbol) to size the "
                "batch dim; unroll() supplies it automatically")
        states = []
        for i, info in enumerate(self.state_info):
            n = info["shape"][1]
            # (N,1) zeros from the input, tiled to (N, state width)
            z1 = sym.sum(like * 0.0, axis=1, keepdims=True)
            states.append(sym.tile(z1, reps=(1, n)))
        return states

    # ---- stepping --------------------------------------------------------
    def __call__(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length: int, inputs, begin_state=None, layout="NTC",
               merge_outputs: Optional[bool] = None):
        """Unroll `length` steps over `inputs` [N,T,C] ('NTC') or
        [T,N,C] ('TNC'); returns (outputs, states) with outputs merged
        to one [N,T,H] / [T,N,H] symbol when merge_outputs is not False
        (the reference default None merges too)."""
        self.reset()
        taxis = 1 if layout == "NTC" else 0
        xs = []
        for t in range(length):
            s = sym.slice_axis(inputs, axis=taxis, begin=t, end=t + 1)
            xs.append(sym.reshape(s, shape=(0, -1) if taxis == 1
                                  else (-3, -1)))
        if begin_state is None:
            begin_state = self.begin_state(like=xs[0])
        states = list(begin_state)
        outs = []
        for t in range(length):
            out, states = self(xs[t], states)
            outs.append(out)
        if merge_outputs is False:
            return outs, states
        expanded = [sym.expand_dims(o, axis=taxis) for o in outs]
        merged = sym.concat(*expanded, dim=taxis)
        return merged, states


class RNNCell(BaseRNNCell):
    """Vanilla tanh/relu cell (ref: rnn_cell.py::RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_"):
        super().__init__(prefix)
        self._h = num_hidden
        self._act = activation

    @property
    def state_info(self):
        return [{"shape": (0, self._h), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        i2h = sym.FullyConnected(inputs, self._param("i2h_weight"),
                                 self._param("i2h_bias"),
                                 num_hidden=self._h)
        h2h = sym.FullyConnected(states[0], self._param("h2h_weight"),
                                 self._param("h2h_bias"),
                                 num_hidden=self._h)
        out = sym.Activation(i2h + h2h, act_type=self._act)
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM, gate order i,f,g,o (ref: rnn_cell.py::LSTMCell; identical
    to gluon.rnn.LSTMCell so params interchange)."""

    def __init__(self, num_hidden, prefix="lstm_"):
        super().__init__(prefix)
        self._h = num_hidden

    @property
    def state_info(self):
        return [{"shape": (0, self._h), "__layout__": "NC"},
                {"shape": (0, self._h), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        h = self._h
        i2h = sym.FullyConnected(inputs, self._param("i2h_weight"),
                                 self._param("i2h_bias"), num_hidden=4 * h)
        h2h = sym.FullyConnected(states[0], self._param("h2h_weight"),
                                 self._param("h2h_bias"), num_hidden=4 * h)
        gates = i2h + h2h
        sl = sym.split(gates, num_outputs=4, axis=1)
        i = sym.sigmoid(sl[0])
        f = sym.sigmoid(sl[1])
        g = sym.tanh(sl[2])
        o = sym.sigmoid(sl[3])
        c = f * states[1] + i * g
        out = o * sym.tanh(c)
        return out, [out, c]


class GRUCell(BaseRNNCell):
    """GRU, gate order r,z,n (ref: rnn_cell.py::GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_"):
        super().__init__(prefix)
        self._h = num_hidden

    @property
    def state_info(self):
        return [{"shape": (0, self._h), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        h = self._h
        prev = states[0]
        i2h = sym.FullyConnected(inputs, self._param("i2h_weight"),
                                 self._param("i2h_bias"), num_hidden=3 * h)
        h2h = sym.FullyConnected(prev, self._param("h2h_weight"),
                                 self._param("h2h_bias"), num_hidden=3 * h)
        ir, iz, infw = sym.split(i2h, num_outputs=3, axis=1)
        hr, hz, hn = sym.split(h2h, num_outputs=3, axis=1)
        r = sym.sigmoid(ir + hr)
        z = sym.sigmoid(iz + hz)
        n = sym.tanh(infw + r * hn)
        out = (1 - z) * n + z * prev
        return out, [out]


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence (ref: SequentialRNNCell)."""

    def __init__(self):
        super().__init__("")
        self._cells: List[BaseRNNCell] = []

    def add(self, cell: BaseRNNCell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return [i for c in self._cells for i in c.state_info]

    @property
    def params(self):
        return [p for c in self._cells for p in c.params]

    def begin_state(self, like=None, **kwargs):
        return [s for c in self._cells
                for s in c.begin_state(like=like, **kwargs)]

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for c in self._cells:
            n = len(c.state_info)
            inputs, ns = c(inputs, states[p:p + n])
            next_states.extend(ns)
            p += n
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Applies dropout on the output stream (ref: DropoutCell)."""

    def __init__(self, dropout: float, prefix="dropout_"):
        super().__init__(prefix)
        self._p = dropout

    @property
    def state_info(self):
        return []

    def begin_state(self, like=None, **kwargs):
        return []

    def __call__(self, inputs, states):
        if self._p > 0:
            inputs = sym.Dropout(inputs, p=self._p)
        return inputs, states


class ResidualCell(BaseRNNCell):
    """Adds the input to the base cell's output (ref: ResidualCell)."""

    def __init__(self, base_cell: BaseRNNCell):
        super().__init__("")
        self._base = base_cell

    @property
    def state_info(self):
        return self._base.state_info

    @property
    def params(self):
        return self._base.params

    def begin_state(self, like=None, **kwargs):
        return self._base.begin_state(like=like, **kwargs)

    def __call__(self, inputs, states):
        out, states = self._base(inputs, states)
        return out + inputs, states


class BidirectionalCell(BaseRNNCell):
    """Runs two cells over opposite directions and concatenates
    (ref: BidirectionalCell — unroll-only, like the reference)."""

    def __init__(self, l_cell: BaseRNNCell, r_cell: BaseRNNCell):
        super().__init__("")
        self._l, self._r = l_cell, r_cell

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    @property
    def params(self):
        return self._l.params + self._r.params

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell supports only unroll() "
                         "(same restriction as the reference)")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs: Optional[bool] = None):
        taxis = 1 if layout == "NTC" else 0
        if begin_state is None:
            l_begin = r_begin = None
        else:  # split between the two directions (reference contract)
            n_l = len(self._l.state_info)
            l_begin = begin_state[:n_l]
            r_begin = begin_state[n_l:]
        l_out, l_states = self._l.unroll(length, inputs,
                                         begin_state=l_begin,
                                         layout=layout,
                                         merge_outputs=False)
        rev = sym.reverse(inputs, axis=taxis)
        r_out, r_states = self._r.unroll(length, rev,
                                         begin_state=r_begin,
                                         layout=layout,
                                         merge_outputs=False)
        outs = [sym.concat(lo, ro, dim=1)
                for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs is False:
            return outs, l_states + r_states
        expanded = [sym.expand_dims(o, axis=taxis) for o in outs]
        return sym.concat(*expanded, dim=taxis), l_states + r_states


class FusedRNNCell(BaseRNNCell):
    """The fused multi-layer recurrence: one ``RNN`` node (ref:
    FusedRNNCell over sym.RNN)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix="rnn_"):
        super().__init__(prefix)
        self._h = num_hidden
        self._layers = num_layers
        self._mode = mode
        self._bi = bidirectional
        self._dropout = dropout

    @property
    def state_info(self):
        d = 2 if self._bi else 1
        info = [{"shape": (self._layers * d, 0, self._h),
                 "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": (self._layers * d, 0, self._h),
                         "__layout__": "LNC"})
        return info

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs: Optional[bool] = None):
        self.reset()
        x = inputs if layout == "TNC" else sym.transpose(inputs,
                                                         axes=(1, 0, 2))
        kw = {}
        if begin_state is not None:
            kw["state"] = begin_state[0]
            if self._mode == "lstm":
                kw["state_cell"] = begin_state[1]
        # the flat parameter vector, named '{prefix}parameters' as the
        # reference FusedRNNCell names it
        out = sym.RNN(x, self._param("parameters"),
                      state_size=self._h, num_layers=self._layers,
                      mode=self._mode, bidirectional=self._bi,
                      p=self._dropout, state_outputs=False,
                      name=self._prefix + "rnn", **kw)
        if layout == "NTC":
            out = sym.transpose(out, axes=(1, 0, 2))
        if merge_outputs is False:
            taxis = 1 if layout == "NTC" else 0
            outs = [sym.reshape(
                sym.slice_axis(out, axis=taxis, begin=t, end=t + 1),
                shape=(0, -1) if taxis == 1 else (-3, -1))
                for t in range(length)]
            return outs, []
        return out, []
