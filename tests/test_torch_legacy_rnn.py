"""The legacy ``rnn`` namespace of mxnet_tpu_torch (symbolic cells,
``encode_sentences``, ``BucketSentenceIter``) against the JAX package's,
on the CPU: the port's counterparts of ``tests/test_legacy_rnn.py``, each
graph composed through both packages' cells and ``sym`` and bound with
the same seeded feed.

* RNN, LSTM and GRU cells unrolled over NTC data: the same ``tojson``
  text, the forward of both executors within RNN_FWD of (1 + |want|)
  (``torch_parity``), and a backward under a seeded cotangent within
  RNN_BWD; and the port's gluon cell with the same parameters gives the
  same output (the layouts interchange).
* A SequentialRNNCell of LSTM, DropoutCell(0) and ResidualCell(GRU), a
  BidirectionalCell, a FusedRNNCell (two layers, its one
  ``{prefix}parameters`` vector) and a TNC unroll with merge_outputs
  False: outputs against the JAX package's.
* A given begin_state flows into the unroll.
* encode_sentences gives the same codes and vocab, BucketSentenceIter the
  same batches, bucket keys and shapes in the same order (both shuffle
  from numpy's RandomState(1)), its label the data moved one step left.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import rnn as jleg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rnn as tleg
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import rnn as trnn

import torch_parity as tp

N, T, C, H = 2, 5, 4, 6
PKG = {"jax": (mx, jleg, mx.cpu()), "port": (mt, tleg, mt.cpu())}


def _bind(pkg, out, feed, train=False, cts=None):
    """Forward (and with ``cts`` the gradients of every fed input) of the
    symbol bound on the CPU."""
    m, _, ctx = PKG[pkg]
    args = {k: m.nd.array(v, ctx=ctx) for k, v in feed.items()}
    if cts is None:
        ex = out.bind(ctx, args)
        return [o.asnumpy() for o in ex.forward()], {}
    grads = {k: m.nd.zeros(v.shape, ctx=ctx) for k, v in feed.items()}
    ex = out.bind(ctx, args, args_grad=grads, grad_req="write")
    outs = ex.forward(is_train=True)
    ex.backward([m.nd.array(c, ctx=ctx) for c in cts])
    return ([o.asnumpy() for o in outs],
            {k: g.asnumpy() for k, g in ex.grad_dict.items()
             if g is not None})


def _cell_params(kind, rng, c=C):
    mult = {"rnn": 1, "lstm": 4, "gru": 3}[kind]
    return {"i2h_weight": (rng.randn(mult * H, c) * 0.3).astype(np.float32),
            "h2h_weight": (rng.randn(mult * H, H) * 0.3).astype(np.float32),
            "i2h_bias": (rng.randn(mult * H) * 0.1).astype(np.float32),
            "h2h_bias": (rng.randn(mult * H) * 0.1).astype(np.float32)}


def _both(build, feed, cts=None):
    """``build(m, leg) -> symbol`` through both packages, each under a
    fresh NameManager (the automatic node names then start from 0 in
    both, whatever ran before in the process): their JSON and (outputs,
    grads) of each."""
    res = {}
    for pkg in ("jax", "port"):
        m, leg, _ = PKG[pkg]
        with m.name.NameManager():
            out = build(m, leg)
        res[pkg] = (out.tojson(), _bind(pkg, out, feed, cts=cts))
    return res["jax"], res["port"]


def _hold(j, t, cts=None):
    assert t[0] == j[0]
    for a, b in zip(t[1][0], j[1][0]):
        tp.hold_close(a, b, tp.RNN_FWD, "output")
    assert set(t[1][1]) == set(j[1][1])
    for k in j[1][1]:
        tp.hold_close(t[1][1][k], j[1][1][k], tp.RNN_BWD, f"{k} gradient")


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru"])
def test_legacy_cell_matches_jax_and_the_gluon_cell(kind):
    rng = np.random.RandomState(0)
    x = (rng.randn(N, T, C) * 0.5).astype(np.float32)
    params = _cell_params(kind, rng)
    feed = {"data": x, **{f"{kind}0_{k}": v for k, v in params.items()}}
    cts = [rng.randn(N, T, H).astype(np.float32)]

    def build(m, leg):
        cell = {"rnn": leg.RNNCell, "lstm": leg.LSTMCell,
                "gru": leg.GRUCell}[kind](H, prefix=f"{kind}0_")
        return cell.unroll(T, m.sym.Variable("data"), layout="NTC")[0]

    j, t = _both(build, feed, cts)
    _hold(j, t)
    gcell = {"rnn": trnn.RNNCell, "lstm": trnn.LSTMCell,
             "gru": trnn.GRUCell}[kind](H)
    gcell.initialize(ctx=mt.cpu())
    load_numpy_params(gcell, params)
    out, _ = gcell.unroll(T, mt.nd.array(x, ctx=mt.cpu()), layout="NTC",
                          merge_outputs=True)
    tp.hold_close(out.asnumpy(), t[1][0][0], tp.RNN_FWD, "gluon cell")


def test_sequential_residual_dropout_stack_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(N, T, H) * 0.5).astype(np.float32)
    feed = {"data": x}
    for pre, kind in (("l0_", "lstm"), ("l1_", "gru")):
        feed.update({pre + k: v
                     for k, v in _cell_params(kind, rng, H).items()})

    def build(m, leg):
        stack = leg.SequentialRNNCell()
        stack.add(leg.LSTMCell(H, prefix="l0_"))
        stack.add(leg.DropoutCell(0.0))
        stack.add(leg.ResidualCell(leg.GRUCell(H, prefix="l1_")))
        out, states = stack.unroll(T, m.sym.Variable("data"), layout="NTC")
        assert len(states) == 3 and sorted(stack.params) == sorted(
            k for k in feed if k != "data")
        return out

    j, t = _both(build, feed)
    _hold(j, t)


def test_bidirectional_and_tnc_unroll_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(T, N, C).astype(np.float32)
    feed = {"data": x}
    for pre in ("fw_", "bw_"):
        feed.update({pre + k: v
                     for k, v in _cell_params("lstm", rng).items()})

    def build(m, leg):
        bi = leg.BidirectionalCell(leg.LSTMCell(H, prefix="fw_"),
                                   leg.LSTMCell(H, prefix="bw_"))
        outs, states = bi.unroll(T, m.sym.Variable("data"), layout="TNC",
                                 merge_outputs=False)
        assert len(outs) == T and len(states) == 4
        return m.sym.Group(outs)

    j, t = _both(build, feed)
    _hold(j, t)
    assert t[1][0][0].shape == (N, 2 * H)


def test_fused_cell_unroll_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(N, T, C).astype(np.float32)
    size = mt.ops.rnn.rnn_param_size("lstm", C, H, 2, False)
    feed = {"data": x,
            "f_parameters": (rng.randn(size) * 0.2).astype(np.float32)}
    cts = [rng.randn(N, T, H).astype(np.float32)]

    def build(m, leg):
        cell = leg.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="f_")
        out, _ = cell.unroll(T, m.sym.Variable("data"), layout="NTC")
        assert cell.params == ["f_parameters"]
        return out

    j, t = _both(build, feed, cts)
    _hold(j, t)


def test_a_given_begin_state_flows_into_the_unroll():
    rng = np.random.RandomState(4)
    x = (rng.randn(N, 3, C) * 0.3).astype(np.float32)
    h0, c0 = (rng.randn(2, N, H).astype(np.float32))
    params = {"s_" + k: v for k, v in _cell_params("lstm", rng).items()}
    outs = {}
    for pkg in ("jax", "port"):
        m, leg, _ = PKG[pkg]
        cell = leg.LSTMCell(H, prefix="s_")
        with m.name.NameManager():
            merged, _ = cell.unroll(3, m.sym.Variable("data"),
                                    layout="NTC",
                                    begin_state=[m.sym.Variable("h0"),
                                                 m.sym.Variable("c0")])
        outs[pkg] = [_bind(pkg, merged, {"data": x, "h0": h * s, "c0": c0 * s,
                                         **params})[0][0]
                     for h, s in ((h0, 1.0), (h0, 0.0))]
    for a, b in zip(outs["port"], outs["jax"]):
        tp.hold_close(a, b, tp.RNN_FWD)
    assert np.abs(outs["port"][0] - outs["port"][1]).max() > 1e-4


def test_encode_sentences_and_bucket_iter_match_jax():
    sents = [list("abc"), list("ac"), list("bcab"), list("ca"), list("ab"),
             list("bca"), list("abcab"), list("cc")]
    got, want = {}, {}
    for pkg, out in (("jax", want), ("port", got)):
        leg = PKG[pkg][1]
        coded, vocab = leg.encode_sentences(sents, invalid_label=0,
                                            start_label=1)
        it = leg.BucketSentenceIter(coded, batch_size=2, buckets=[2, 4],
                                    invalid_label=0)
        out["codes"], out["vocab"] = coded, vocab
        out["batches"] = [(b.bucket_key, b.data[0].asnumpy(),
                           b.label[0].asnumpy(), b.provide_data[0].shape)
                          for b in it]
        out["default"] = it.default_bucket_key
    assert got["codes"] == want["codes"] and got["vocab"] == want["vocab"]
    assert got["default"] == want["default"] == 4
    assert len(got["batches"]) == len(want["batches"]) >= 2
    for (k, d, lab, shape), (k2, d2, lab2, shape2) in zip(
            got["batches"], want["batches"]):
        assert k == k2 and tuple(shape) == tuple(shape2) == (2, k)
        np.testing.assert_array_equal(d, d2)
        np.testing.assert_array_equal(lab, lab2)
        np.testing.assert_array_equal(lab[:, :-1], d[:, 1:])
    with pytest.raises(mt.MXNetError, match="unknown token"):
        tleg.encode_sentences([["z"]], vocab=dict(got["vocab"]))
