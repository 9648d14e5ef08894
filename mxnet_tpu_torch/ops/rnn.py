"""The fused multi-layer RNN op (counterpart of ``mxnet_tpu/ops/rnn.py``).

``RNN`` runs LSTM, GRU or a plain tanh/relu recurrence over TNC data,
``num_layers`` deep and one or two directions wide, from one flat
parameter vector in the cuDNN packing the JAX op reads: every layer's
weights first (layer-major, direction-minor, W_i2h then W_h2h, each
row-major), then every bias (b_i2h then b_h2h) in the same order.  Gate
order: LSTM [i, f, g, o]; GRU [r, z, n].

The arithmetic is the JAX op's.  The input projection is one matmul
over all T steps; for RNN and LSTM both biases are folded into it, and
GRU keeps b_h2h inside the recurrent product, before ``r * hn``.  The
reverse direction flips the sequence, runs the same loop and flips the
outputs back, so its final state is the one after t = 0.  Omitted
initial states are zeros in the data's dtype.  Dropout falls between
layers only, when ``p > 0``, ``train`` is set and a generator is given.

The JAX op's ``lax.scan`` is a Python loop of PyTorch ops on the
caller's stream here: one launch sequence per step, which a captured
step (``_graphs``) replays without the host's launch cost.  Where the
JAX op takes ``key`` and ``_train``, this one takes ``generator`` (a
``torch.Generator``, in the same slot) and ``train``, as the port's
Dropout does.  As in the JAX op, ``projection_size``,
``lstm_state_clip_*`` and ``use_sequence_length`` are accepted and
change nothing.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["rnn", "rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, input_size, hidden, num_layers, bidirectional):
    """The length of the packed parameter vector."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden * dirs
        total += dirs * (g * hidden * in_sz + g * hidden * hidden
                         + 2 * g * hidden)
    return total


def _unpack_params(params, mode, input_size, hidden, num_layers, dirs):
    """Views of the packed vector: [(W_i2h, W_h2h)] and [(b_i2h, b_h2h)],
    one pair per layer and direction."""
    g = _GATES[mode]
    mats, biases = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden * dirs
        for _ in range(dirs):
            wi = params[off:off + g * hidden * in_sz].reshape(g * hidden,
                                                             in_sz)
            off += g * hidden * in_sz
            wh = params[off:off + g * hidden * hidden].reshape(g * hidden,
                                                              hidden)
            off += g * hidden * hidden
            mats.append((wi, wh))
    for _ in range(num_layers * dirs):
        biases.append((params[off:off + g * hidden],
                       params[off + g * hidden:off + 2 * g * hidden]))
        off += 2 * g * hidden
    return mats, biases


def _layer_forward(x, w_i2h, w_h2h, b_i2h, b_h2h, h0, c0, mode, reverse):
    """One direction of one layer over x (T, N, I): (ys, hT, cT)."""
    if reverse:
        x = torch.flip(x, (0,))
    wt = w_h2h.t()
    h, c = h0, c0
    ys = []
    if mode == "gru":
        xw = torch.matmul(x, w_i2h.t()) + b_i2h
        for xt in xw.unbind(0):
            hw = torch.addmm(b_h2h, h, wt)
            xr, xz, xn = xt.chunk(3, -1)
            hr, hz, hn = hw.chunk(3, -1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
            ys.append(h)
    else:
        xw = torch.matmul(x, w_i2h.t()) + b_i2h + b_h2h
        hid = h0.shape[-1]
        for xt in xw.unbind(0):
            pre = torch.addmm(xt, h, wt)
            if mode == "lstm":
                # sigmoid over all four gates, of which i, f and o are
                # read: the same values as three separate sigmoids
                sig = torch.sigmoid(pre)
                i, f, o = (sig[:, :hid], sig[:, hid:2 * hid],
                           sig[:, 3 * hid:])
                g = torch.tanh(pre[:, 2 * hid:3 * hid])
                c = f * c + i * g
                h = o * torch.tanh(c)
            elif mode == "rnn_relu":
                h = torch.relu(pre)
            else:
                h = torch.tanh(pre)
            ys.append(h)
    out = torch.stack(ys)
    if reverse:
        out = torch.flip(out, (0,))
    return out, h, c


def _rnn_nout(attrs):
    if not attrs.get("state_outputs", True):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def rnn(data, parameters, state=None, state_cell=None, generator=None,
        state_size=0, num_layers=1, mode="lstm", bidirectional=False,
        p=0.0, state_outputs=True, projection_size=None,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False, use_sequence_length=False, train=False):
    """data (T, N, I), state (L*dirs, N, H) -> out (T, N, H*dirs), and
    with ``state_outputs`` the final h (and for LSTM c) stacked as the
    states are."""
    T, N, I = data.shape
    H = int(state_size)
    dirs = 2 if bidirectional else 1
    if state is None:
        state = data.new_zeros((num_layers * dirs, N, H))
    if state_cell is None and mode == "lstm":
        state_cell = data.new_zeros((num_layers * dirs, N, H))
    mats, biases = _unpack_params(parameters, mode, I, H, num_layers, dirs)
    x = data
    h_outs, c_outs = [], []
    idx = 0
    for layer in range(num_layers):
        ys_dirs = []
        for d in range(dirs):
            wi, wh = mats[idx]
            bi, bh = biases[idx]
            c0 = state_cell[idx] if mode == "lstm" else None
            ys, hT, cT = _layer_forward(x, wi, wh, bi, bh, state[idx], c0,
                                        mode, reverse=d == 1)
            ys_dirs.append(ys)
            h_outs.append(hT)
            if mode == "lstm":
                c_outs.append(cT)
            idx += 1
        x = torch.cat(ys_dirs, -1) if dirs > 1 else ys_dirs[0]
        if p > 0 and train and layer < num_layers - 1 \
                and generator is not None:
            keep = 1.0 - p
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = x * mask.to(x.dtype) / keep
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.stack(h_outs), torch.stack(c_outs)
    return x, torch.stack(h_outs)


register_op("RNN", num_outputs=_rnn_nout)(rnn)
