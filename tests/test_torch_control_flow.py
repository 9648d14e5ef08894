"""The port's control flow (``mxnet_tpu_torch/contrib/control_flow.py``:
``foreach``, ``while_loop``, ``cond``) against the JAX package's on the
CPU, each case held against the JAX function eagerly and under
``jax.jit`` (its ``lax.scan``/``lax.while_loop``/``lax.cond`` path).

Tolerances: the elementwise cases are exact (the same float32 sums in the
same order); gradients and the small nets within rtol 1e-5 and atol 1e-6;
the narrow foreach LSTM within rtol 1e-5 and atol 1e-6 of the port's
fused ``RNN`` op (the same gates, summed in another order) and of the JAX
foreach.  Also: the ``max_iterations`` error, the false-on-entry case,
``F.contrib.foreach`` in a hybridized block (dropout 0 against the JAX
block; dropout 0.5 draws a fresh mask each call), and the eager-entry
rule: a ``while_loop`` or ``cond`` on an array predicate inside a
hybridized block runs eagerly, counted in ``custom_eager``, while a
``foreach`` is not counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.contrib import ndarray as JC

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import ndarray as TC
from mxnet_tpu_torch.gluon import load_numpy_params

CPU = mt.cpu()
XS = np.arange(12, dtype=np.float32).reshape(4, 3)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the other workers hold
    the cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return mt.nd.array(np.asarray(a, np.float32), ctx=CPU)


def _body(x, s):
    s2 = s + x
    return s2, s2


def _jit(fn, *arrays):
    """``fn`` on NDArrays of the JAX package, under jax.jit."""
    return jax.jit(lambda *vs: fn(*[mx.nd.NDArray(v) for v in vs]))(
        *[jnp.asarray(a) for a in arrays])


def test_foreach_scan():
    outs, final = TC.foreach(_body, _t(XS), _t(np.zeros(3)))
    jo, jf = JC.foreach(_body, mx.nd.array(XS), mx.nd.zeros((3,)))
    ko, kf = _jit(lambda d, s: tuple(a.data for a in JC.foreach(_body, d, s)),
                  XS, np.zeros(3, np.float32))
    for got, want in ((outs, jo.asnumpy()), (final, jf.asnumpy()),
                      (outs, np.asarray(ko)), (final, np.asarray(kf))):
        np.testing.assert_array_equal(got.asnumpy(), want)


def test_foreach_several_data_and_states():
    def body(xs, ss):
        return (xs[0] + xs[1], xs[0]), (ss[0] + xs[1], ss[1])

    outs, states = TC.foreach(body, [_t(XS), _t(XS * 2)],
                              [_t(np.zeros(3)), _t(np.ones(3))])
    jo, js = JC.foreach(body, [mx.nd.array(XS), mx.nd.array(XS * 2)],
                        [mx.nd.zeros((3,)), mx.nd.ones((3,))])
    assert len(outs) == 2 and len(states) == 2
    for a, b in zip(outs + states, jo + js):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_foreach_zero_length_and_mismatched_lengths():
    outs, final = TC.foreach(_body, _t(np.zeros((0, 3))), _t(np.ones(3)))
    jo, jf = JC.foreach(_body, mx.nd.array(np.zeros((0, 3), np.float32)),
                        mx.nd.ones((3,)))
    assert outs.shape == jo.shape == (0, 3)
    np.testing.assert_array_equal(final.asnumpy(), jf.asnumpy())
    with pytest.raises(MXNetError, match="axis-0"):
        TC.foreach(lambda xs, s: (xs[0], s), [_t(XS), _t(XS[:2])],
                   _t(np.zeros(3)))
    with pytest.raises(MXNetError, match="at least one"):
        TC.foreach(_body, [], _t(np.zeros(3)))


def test_foreach_gradient_through_the_tape():
    def run(pkg, arr):
        w = arr(np.ones(3))
        w.attach_grad()
        C = TC if pkg is mt else JC
        with pkg.autograd.record():
            o, _ = C.foreach(lambda x, s: (s + x * w, s + x * w), arr(XS),
                             arr(np.zeros(3)))
            loss = o.sum()
        loss.backward()
        return w.grad.asnumpy()

    got = run(mt, _t)
    want = run(mx, lambda a: mx.nd.array(np.asarray(a, np.float32)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, (XS * np.arange(4, 0, -1)[:, None]).sum(0), rtol=RTOL)


def test_while_loop_eager_and_against_the_traced_one():
    outs, fin = TC.while_loop(lambda i: i < 3, lambda i: (i * 2, i + 1),
                              [_t([0.0])], max_iterations=5)
    jo, jfin = JC.while_loop(lambda i: i < 3, lambda i: (i * 2, i + 1),
                             [mx.nd.array(np.array([0.0], np.float32))],
                             max_iterations=5)
    ko, kf = _jit(lambda i: (lambda o, f: (o.data, f[0].data))(
        *JC.while_loop(lambda i: i.reshape(()) < 3,
                       lambda i: (i * 2, i + 1), [i], max_iterations=5)),
        np.array([0.0], np.float32))
    np.testing.assert_array_equal(fin[0].asnumpy(), [3.0])
    np.testing.assert_array_equal(outs.asnumpy().ravel(), [0, 2, 4, 0, 0])
    for got, want in ((outs, jo.asnumpy()), (outs, np.asarray(ko)),
                      (fin[0], jfin[0].asnumpy()), (fin[0], np.asarray(kf))):
        np.testing.assert_array_equal(got.asnumpy(), want)


def test_while_loop_needs_max_iterations():
    for C, i0 in ((TC, _t([0.0])), (JC, mx.nd.array([0.0]))):
        with pytest.raises(Exception, match="max_iterations"):
            C.while_loop(lambda i: i < 3, lambda i: (i, i), [i0])


def test_while_loop_false_on_entry():
    outs, fin = TC.while_loop(lambda i: i < 0, lambda i: (i * 2, i + 1),
                              [_t([5.0])], max_iterations=4)
    ko, kf = _jit(lambda i: (lambda o, f: (o.data, f[0].data))(
        *JC.while_loop(lambda i: i.reshape(()) < 0,
                       lambda i: (i * 2, i + 1), [i], max_iterations=4)),
        np.array([5.0], np.float32))
    np.testing.assert_array_equal(outs.asnumpy(), np.asarray(ko))
    np.testing.assert_array_equal(outs.asnumpy(), np.zeros((4, 1)))
    np.testing.assert_array_equal(fin[0].asnumpy(), np.asarray(kf))


@pytest.mark.parametrize("kind", ["ndarray", "tensor", "bool"])
def test_while_loop_predicate_kinds(kind):
    def cond_fn(i):
        if kind == "ndarray":
            return i < 3
        if kind == "tensor":
            return i._data.reshape(()) < 3
        return bool(i.asnumpy()[0] < 3)

    _, fin = TC.while_loop(cond_fn, lambda i: (i, i + 1), _t([0.0]),
                           max_iterations=6)
    np.testing.assert_array_equal(fin.asnumpy(), [3.0])


def test_cond_eager_and_against_the_traced_one():
    # one jitted function for both predicates, as the JAX package's test
    # (its traced cond draws a key from the ambient provider)
    jitted = jax.jit(lambda v: JC.cond(mx.nd.NDArray(v),
                                       lambda: mx.nd.ones((2,)),
                                       lambda: mx.nd.zeros((2,))).data)
    for p in (1.0, 0.0):
        got = TC.cond(_t([p]), lambda: _t(np.ones(2)),
                      lambda: _t(np.zeros(2)))
        want = jitted(jnp.asarray(p, jnp.float32))
        np.testing.assert_array_equal(got.asnumpy(), np.asarray(want))
    assert TC.cond(True, lambda: 1, lambda: 2) == 1
    x = _t([2.0])
    x.attach_grad()
    with mt.autograd.record():
        y = TC.cond(x > 1, lambda: x * 3, lambda: x * 5)
    y.backward()
    assert x.grad.asnumpy().tolist() == [3.0]


# ---------------------------------------------------------------------------
# inside hybridized blocks
# ---------------------------------------------------------------------------

def _scan_rnn(rate):
    nn = mt.gluon.nn

    class ScanRNN(mt.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.cell = nn.Dense(8, in_units=12, activation="relu")
            self.drop = nn.Dropout(rate)
            self.out = nn.Dense(2, in_units=8)

        def hybrid_forward(self, F, x):
            init = x.new_zeros((x.shape[1], 8))

            def step(xt, h):
                h2 = self.drop(self.cell(torch.cat([h, xt], 1)))
                return h2, h2

            _, final = F.contrib.foreach(step, x, init)
            return self.out(final)
    return ScanRNN()


def _jax_scan_rnn(vals):
    nn = mx.gluon.nn

    class ScanRNN(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.cell = nn.Dense(8, in_units=12, activation="relu")
            self.out = nn.Dense(2, in_units=8)

        def forward(self, x):
            init = mx.nd.zeros((x.shape[1], 8), ctx=x.ctx)

            def step(xt, h):
                h2 = self.cell(mx.nd.concat(h, xt, dim=1))
                return h2, h2

            _, final = JC.foreach(step, x, init)
            return self.out(final)

    net = ScanRNN()
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(np.zeros((1, 1, 4), np.float32)))
    ps = {"cell.weight": net.cell.weight, "cell.bias": net.cell.bias,
          "out.weight": net.out.weight, "out.bias": net.out.bias}
    for k, p in ps.items():
        p.set_data(mx.nd.array(vals[k]))
    return net, ps


def _scan_vals():
    rng = np.random.RandomState(0)
    return {"cell.weight": rng.randn(8, 12).astype(np.float32) * 0.3,
            "cell.bias": rng.randn(8).astype(np.float32) * 0.1,
            "out.weight": rng.randn(2, 8).astype(np.float32) * 0.3,
            "out.bias": rng.randn(2).astype(np.float32) * 0.1}


def test_foreach_in_a_hybridized_block_against_the_jax_block():
    from mxnet_tpu_torch.gluon.block import cached_op_stats

    vals = _scan_vals()
    X = np.random.RandomState(1).randn(5, 4, 4).astype(np.float32)
    net = _scan_rnn(0.0)
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    net.hybridize()
    c0 = cached_op_stats()["custom_eager"]
    out = net(_t(X))
    with mt.autograd.record():
        loss = (net(_t(X)) ** 2).sum()
    loss.backward()
    assert cached_op_stats()["custom_eager"] == c0  # foreach is captured
    jnet, jps = _jax_scan_rnn(vals)
    jnet.hybridize()
    jout = jnet(mx.nd.array(X))
    with mx.autograd.record():
        jloss = (jnet(mx.nd.array(X)) ** 2).sum()
    jloss.backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    params = dict(net.collect_params().items())
    for k, p in jps.items():
        np.testing.assert_allclose(params[k].grad().asnumpy(),
                                   p.grad().asnumpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_dropout_in_a_foreach_body_draws_a_fresh_mask_each_call():
    net = _scan_rnn(0.5)
    net.initialize(ctx=CPU)
    load_numpy_params(net, _scan_vals())
    net.hybridize()
    X = _t(np.random.RandomState(2).randn(5, 4, 4))
    with mt.autograd.record():
        a = net(X)
        b = net(X)
    assert a.shape == (4, 2) and not np.array_equal(a.asnumpy(),
                                                    b.asnumpy())


class _Loops(mt.gluon.HybridBlock):
    """A while_loop and a cond on array predicates, in a block."""

    def __init__(self):
        super().__init__()
        self.fc = mt.gluon.nn.Dense(3, in_units=3)

    def hybrid_forward(self, F, x):
        outs, fin = F.contrib.while_loop(
            lambda h, i: i < 3, lambda h, i: (self.fc(h), (self.fc(h), i + 1)),
            [x, x.new_zeros((1,))], max_iterations=4)
        return F.contrib.cond(fin[0].sum() > 0, lambda: outs.sum(0) + fin[0],
                              lambda: outs.sum(0) - fin[0])


def test_while_loop_and_cond_in_a_hybridized_block_are_eager_entries():
    from mxnet_tpu_torch.gluon.block import cached_op_stats

    rng = np.random.RandomState(3)
    vals = {"fc.weight": rng.randn(3, 3).astype(np.float32) * 0.5,
            "fc.bias": rng.randn(3).astype(np.float32) * 0.1}
    x = rng.randn(2, 3).astype(np.float32)
    net = _Loops()
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    with mt.autograd.record():
        want = net(_t(x))
        (want ** 2).sum().backward()
    gw = net.fc.weight.grad().asnumpy().copy()
    net.hybridize()
    c0 = cached_op_stats()["custom_eager"]
    got = net(_t(x))
    with mt.autograd.record():
        got2 = net(_t(x))
        (got2 ** 2).sum().backward()
    assert cached_op_stats()["custom_eager"] - c0 == 2
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(net.fc.weight.grad().asnumpy(), gw,
                               rtol=RTOL, atol=ATOL)
    W, b = vals["fc.weight"], vals["fc.bias"]
    h, rows = x, []
    for _ in range(3):
        h = h @ W.T + b
        rows.append(h)
    ref = np.sum(rows, 0) + (h if h.sum() > 0 else -h)
    np.testing.assert_allclose(got.asnumpy(), ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# a narrow foreach LSTM against the fused RNN op and the JAX foreach
# ---------------------------------------------------------------------------

T_STEPS, BATCH, EMB, HID = 5, 3, 6, 8


def _lstm_vals():
    rng = np.random.RandomState(4)
    v = {}
    for layer, isz in ((0, EMB), (1, HID)):
        v[f"l{layer}_i2h_weight"] = rng.randn(4 * HID, isz) * 0.3
        v[f"l{layer}_h2h_weight"] = rng.randn(4 * HID, HID) * 0.3
        v[f"l{layer}_i2h_bias"] = rng.randn(4 * HID) * 0.1
        v[f"l{layer}_h2h_bias"] = rng.randn(4 * HID) * 0.1
    return {k: a.astype(np.float32) for k, a in v.items()}


class _ForeachLSTM(mt.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        rnn = mt.gluon.rnn
        self.cell0 = rnn.LSTMCell(HID, input_size=EMB)
        self.cell1 = rnn.LSTMCell(HID, input_size=HID)

    def hybrid_forward(self, F, x):
        z = x.new_zeros((x.shape[1], HID))

        def step(xt, states):
            o0, s0 = self.cell0(xt, states[:2])
            o1, s1 = self.cell1(o0, states[2:])
            return o1, list(s0) + list(s1)

        outs, _ = F.contrib.foreach(step, x, [z, z, z, z])
        return outs


def _cell_vals(vals):
    return {f"cell{layer}.{n}": vals[f"l{layer}_{n}"] for layer in (0, 1)
            for n in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")}


def _run_lstm(net, x):
    xt = _t(x)
    with mt.autograd.record():
        out = net(xt)
        loss = (out * out).sum()
    loss.backward()
    return out.asnumpy(), {k: p.grad().asnumpy() for k, p in
                           net.collect_params().items()}


def test_a_foreach_lstm_matches_the_fused_rnn_op_and_the_jax_foreach():
    vals = _lstm_vals()
    x = np.random.RandomState(5).randn(T_STEPS, BATCH, EMB).astype(
        np.float32)
    net = _ForeachLSTM()
    net.initialize(ctx=CPU)
    load_numpy_params(net, _cell_vals(vals))
    net.hybridize()
    out, grads = _run_lstm(net, x)
    fused = mt.gluon.rnn.LSTM(HID, num_layers=2, input_size=EMB)
    fused.initialize(ctx=CPU)
    load_numpy_params(fused, vals)
    fout, fgrads = _run_lstm(fused, x)
    np.testing.assert_allclose(out, fout, rtol=RTOL, atol=ATOL)
    for k, g in _cell_vals(fgrads).items():
        np.testing.assert_allclose(grads[k], g, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the JAX package's foreach over its LSTMCells, on the same weights
    rnn = mx.gluon.rnn
    cells = [rnn.LSTMCell(HID, input_size=EMB),
             rnn.LSTMCell(HID, input_size=HID)]
    for layer, c in enumerate(cells):
        c.initialize(ctx=mx.cpu())
        for n in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            getattr(c, n).set_data(mx.nd.array(vals[f"l{layer}_{n}"]))

    def step(xt, states):
        o0, s0 = cells[0](xt, states[:2])
        o1, s1 = cells[1](o0, states[2:])
        return o1, list(s0) + list(s1)

    z = mx.nd.zeros((BATCH, HID))
    jout, _ = JC.foreach(step, mx.nd.array(x), [z, z, z, z])
    np.testing.assert_allclose(out, jout.asnumpy(), rtol=RTOL, atol=ATOL)
