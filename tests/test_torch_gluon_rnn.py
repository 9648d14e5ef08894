"""gluon.rnn of mxnet_tpu_torch against the JAX package's, on the CPU.

Every block is built in both packages (the JAX one with an explicit
prefix, so that no test moves the process-wide name counter), the JAX
block's parameters are carried into the port's by structural name, and
both run the same seeded inputs under ``autograd.record()``; the
outputs, the final states, and the gradients of a seeded weighted sum
of them with respect to the input and every parameter are held within
``torch_parity``'s RNN_FWD and RNN_BWD of (1 + |want|).

* Every cell: RNNCell (tanh and relu), LSTMCell, GRUCell, a
  SequentialRNNCell and a HybridSequentialRNNCell stack, DropoutCell
  at rate 0, ZoneoutCell at rates 0, ResidualCell and BidirectionalCell,
  through ``unroll`` in NTC and TNC, merged and as a list of steps, with
  and without ``valid_length``, from default and from given states; a
  single step ``cell(x, states)`` on NDArrays; ``begin_state`` and
  ``state_info`` shapes, and the default states' batch taken from dim 0
  of the first step in either layout (the JAX package's rule).
* The fused layers RNN (relu, tanh), LSTM and GRU, two layers, one and
  two directions, NTC and TNC, with and without states, not hybridized
  and hybridized (the JAX layer unhybridized where states are given: its
  CachedOp takes no list of them), with the input width left to the
  first forward; the JAX parameter names (``l0_i2h_weight``,
  ``r1_h2h_bias``, ...).
* A tiny LSTM language model (Embedding, LSTM over NTC, Dense) through
  the hybridized gluon.Trainer loop: three SGD steps against the JAX
  package's, and the port's steps through the CachedOp entry (the
  training-mode pair, eager on the CPU) bit for bit those under
  ``_graphs.no_capture()``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _graphs
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn

import torch_parity as tp

N, T, C, H = 3, 5, 4, 6
PKG = {"jax": (mx, jrnn, mx.cpu()), "port": (mt, trnn, mt.cpu())}


def _params(pkg, block):
    if pkg == "jax":
        return block._collect_params_with_prefix()
    return dict(block.collect_params().items())


def _carry(jb, tb):
    """Initialize both, the JAX block's values into the port's."""
    vals = {k: p.data().asnumpy() for k, p in _params("jax", jb).items()}
    load_numpy_params(tb, vals)
    return vals


def _head(m, ctx, tensors, seed):
    rng = np.random.RandomState(seed)
    total = None
    for t in tensors:
        w = m.nd.array(rng.randn(*t.shape).astype(np.float32), ctx=ctx)
        term = (t * w).sum()
        total = term if total is None else total + term
    return total


def _run(pkg, block, call, x, seed=9):
    """``call(m, block, x_nd, ctx) -> (out, states)`` under record();
    returns (out, states, x grad, {param: grad})."""
    m, _, ctx = PKG[pkg]
    xs = m.nd.array(x, ctx=ctx)
    xs.attach_grad()
    with m.autograd.record():
        out, states = call(m, block, xs, ctx)
        head = _head(m, ctx, [out] + list(states), seed)
    head.backward()
    grads = {k: p.grad().asnumpy() for k, p in _params(pkg, block).items()
             if p.grad_req != "null"}
    return (out.asnumpy(), [s.asnumpy() for s in states],
            xs.grad.asnumpy(), grads)


def _hold(j, t):
    tp.hold_close(t[0], j[0], tp.RNN_FWD, "output")
    assert len(t[1]) == len(j[1])
    for i, (a, b) in enumerate(zip(t[1], j[1])):
        tp.hold_close(a, b, tp.RNN_FWD, f"state {i}")
    tp.hold_close(t[2], j[2], tp.RNN_BWD, "input gradient")
    assert set(t[3]) == set(j[3]), (sorted(t[3]), sorted(j[3]))
    for k in j[3]:
        tp.hold_close(t[3][k], j[3][k], tp.RNN_BWD, f"{k} gradient")


def _unroll(layout, merge, valid, given):
    """The call that unrolls a cell over x (NTC data, moved to TNC when
    ``layout`` says so), its steps stacked back when not merged."""
    taxis = layout.find("T")

    def call(m, cell, xs, ctx):
        x = xs if layout == "NTC" else m.nd.transpose(xs, axes=(1, 0, 2))
        kw = dict(layout=layout, merge_outputs=merge)
        if valid:
            kw["valid_length"] = m.nd.array([5, 2, 4], ctx=ctx)
        if given:
            rng = np.random.RandomState(4)
            kw["begin_state"] = [
                m.nd.array(rng.randn(*i["shape"]).astype(np.float32),
                           ctx=ctx) for i in cell.state_info(N)]
        out, states = cell.unroll(T, x, **kw)
        if isinstance(out, (list, tuple)):
            assert len(out) == T
            out = m.nd.stack(*out, axis=taxis)
        return out, states
    return call


def _cells(r, kind):
    """``kind``'s cell in the package of the rnn module ``r``."""
    p = "c_"
    if kind == "rnn_relu":
        return r.RNNCell(H, activation="relu", prefix=p)
    if kind in ("rnn", "lstm", "gru"):
        return {"rnn": r.RNNCell, "lstm": r.LSTMCell,
                "gru": r.GRUCell}[kind](H, prefix=p)
    if kind in ("sequential", "hybrid_sequential"):
        stack = (r.SequentialRNNCell if kind == "sequential"
                 else r.HybridSequentialRNNCell)(prefix="s_")
        stack.add(r.LSTMCell(H, prefix="s0_"))
        stack.add(r.DropoutCell(0.0, prefix="s1_"))
        stack.add(r.GRUCell(H, prefix="s2_"))
        return stack
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, prefix=p), 0.0, 0.0)
    if kind == "residual":
        return r.ResidualCell(r.GRUCell(C, prefix=p))
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="l_"),
                                   r.GRUCell(H, prefix="r_"))
    raise ValueError(kind)


def _both(make, call, x):
    jb = make("jax")
    jb.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jb_first = _run("jax", jb, call, x)     # resolves deferred shapes
    tb = make("port")
    tb.initialize(ctx=mt.cpu())
    _carry(jb, tb)
    return _run("jax", jb, call, x), _run("port", tb, call, x), jb_first


X = np.random.RandomState(1).randn(N, T, C).astype(np.float32)
CELLS = ("rnn", "rnn_relu", "lstm", "gru", "sequential",
         "hybrid_sequential", "zoneout", "residual", "bidirectional")


@pytest.mark.parametrize("kind", CELLS)
def test_cell_unroll_matches_jax(kind):
    make = lambda pkg: _cells(PKG[pkg][1], kind)  # noqa: E731
    j, t, _ = _both(make, _unroll("NTC", True, False, False), X)
    _hold(j, t)


@pytest.mark.parametrize("layout,merge,valid,given", [
    ("TNC", True, False, True), ("NTC", False, False, False),
    ("NTC", None, True, False), ("TNC", False, True, True)])
@pytest.mark.parametrize("kind", ["lstm", "bidirectional"])
def test_cell_unroll_options_match_jax(kind, layout, merge, valid, given):
    make = lambda pkg: _cells(PKG[pkg][1], kind)  # noqa: E731
    j, t, _ = _both(make, _unroll(layout, merge, valid, given), X)
    _hold(j, t)


def test_a_single_step_and_begin_state():
    def step(m, cell, xs, ctx):
        states = cell.begin_state(batch_size=N, ctx=ctx)
        out, states = cell(m.nd.slice_axis(xs, axis=1, begin=0, end=1)
                           .reshape((N, C)), states)
        return out, states

    make = lambda pkg: _cells(PKG[pkg][1], "lstm")  # noqa: E731
    j, t, _ = _both(make, step, X)
    _hold(j, t)
    for kind in CELLS:
        jc, tc = _cells(jrnn, kind), _cells(trnn, kind)
        assert [i["shape"] for i in jc.state_info(N)] == \
            [i["shape"] for i in tc.state_info(N)], kind


def test_default_states_take_the_batch_from_the_first_step():
    cell = trnn.GRUCell(H)
    cell.initialize(ctx=mt.cpu())
    x = torch.from_numpy(X)
    for layout, xin in (("NTC", x), ("TNC", x.transpose(0, 1))):
        out, (h,) = cell.unroll(T, xin, layout=layout, merge_outputs=True)
        assert tuple(h.shape) == (N, H) and h.dtype == x.dtype
        assert out.shape[layout.find("N")] == N
    with pytest.raises(mt.MXNetError, match="cannot be stepped"):
        trnn.BidirectionalCell(trnn.GRUCell(H), trnn.GRUCell(H))(
            x[:, 0], [])


def _layer_call(given):
    def call(m, layer, xs, ctx):
        if not given:
            return layer(xs), []
        rng = np.random.RandomState(6)
        batch = xs.shape[0] if layer._layout == "NTC" else xs.shape[1]
        states = [m.nd.array(rng.randn(*i["shape"]).astype(np.float32),
                             ctx=ctx) for i in layer.state_info(batch)]
        out, new = layer(xs, states)
        return out, new
    return call


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("kind,bi,layout,given", [
    ("LSTM", True, "NTC", True), ("LSTM", False, "TNC", False),
    ("GRU", True, "TNC", True), ("GRU", False, "NTC", False),
    ("RNN_relu", True, "NTC", False), ("RNN_tanh", False, "TNC", True)])
def test_fused_layer_matches_jax(kind, bi, layout, given, hybridize):
    def make(pkg):
        r = PKG[pkg][1]
        name, _, act = kind.partition("_")
        kw = dict(num_layers=2, bidirectional=bi, layout=layout,
                  prefix="f_")
        if act:
            kw["activation"] = act
        layer = getattr(r, name)(H, **kw)
        # the JAX CachedOp takes no list of states: that reference runs
        # unhybridized
        if hybridize and not (given and pkg == "jax"):
            layer.hybridize()
        return layer

    x = X if layout == "NTC" else np.ascontiguousarray(X.transpose(1, 0, 2))
    j, t, _ = _both(make, _layer_call(given), x)
    _hold(j, t)
    names = set(j[3])
    assert {"l0_i2h_weight", "l1_h2h_bias"} <= names
    assert ("r1_i2h_weight" in names) == bi


def _lm(pkg, vocab):
    m, r, _ = PKG[pkg]
    nn = jnn if pkg == "jax" else tnn
    net = nn.HybridSequential(prefix="lm_")
    with net.name_scope():
        net.add(nn.Embedding(vocab, H, prefix="emb_"),
                r.LSTM(H, num_layers=1, layout="NTC", prefix="lstm_"),
                nn.Dense(vocab, flatten=False, prefix="out_"))
    return net


def _lm_steps(pkg, net, xb, yb, steps):
    m, _, ctx = PKG[pkg]
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.5})
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss(prefix="loss_")
    x, y = m.nd.array(xb, ctx=ctx), m.nd.array(yb, ctx=ctx)
    losses = []
    for _ in range(steps):
        with m.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(xb.shape[0])
        losses.append(loss.asnumpy())
    return losses, {k: p.data().asnumpy()
                    for k, p in _params(pkg, net).items()}


def test_lstm_lm_trains_through_the_gluon_loop_as_in_jax():
    vocab = 7
    rng = np.random.RandomState(2)
    xb = rng.randint(1, vocab, (N, T)).astype(np.float32)
    yb = np.roll(xb, -1, 1)
    jnet = _lm("jax", vocab)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jnet(mx.nd.array(xb))
    start = {k: p.data().asnumpy()
             for k, p in _params("jax", jnet).items()}
    jnet.hybridize()
    j_losses, j_params = _lm_steps("jax", jnet, xb, yb, 3)
    runs = []
    for eager in (False, True):
        tnet = _lm("port", vocab)
        tnet.initialize(ctx=mt.cpu())
        load_numpy_params(tnet, start)
        tnet.hybridize()
        if eager:
            with _graphs.no_capture():
                runs.append(_lm_steps("port", tnet, xb, yb, 3))
        else:
            runs.append(_lm_steps("port", tnet, xb, yb, 3))
    (t_losses, t_params), (e_losses, e_params) = runs
    for a, b in zip(t_losses, j_losses):
        tp.hold_close(a, b, tp.RNN_FWD, "loss")
    assert set(t_params) == set(j_params)
    for k in j_params:
        tp.hold_close(t_params[k], j_params[k], tp.RNN_BWD, k)
    for a, b in zip(t_losses, e_losses):
        np.testing.assert_array_equal(a, b)
    for k in t_params:
        np.testing.assert_array_equal(t_params[k], e_params[k])


def test_prefixes_follow_the_jax_aliases():
    # the hint of a default prefix is the block's _alias(), as in the JAX
    # package (only the port's blocks are made here: the JAX counters
    # stay where they are)
    for block, hint in ((trnn.LSTMCell(H), "lstm"), (trnn.GRUCell(H), "gru"),
                        (trnn.RNNCell(H), "rnn"), (trnn.LSTM(H), "lstm"),
                        (trnn.RNN(H), "rnn_relu"),
                        (trnn.RNN(H, activation="tanh"), "rnn_tanh"),
                        (tnn.Dense(3), "dense")):
        assert block.prefix.rstrip("_").rstrip("0123456789") == hint, \
            block.prefix
    cell = trnn.LSTMCell(H, prefix="c_")
    assert trnn.ZoneoutCell(cell).prefix == "c_zoneout_"
    assert trnn.ResidualCell(cell).prefix == "c_residual_"
