"""mxnet_tpu_torch.autograd against mxnet_tpu.autograd on the CPU.

The flags of record/pause/train_mode/predict_mode, grad_req 'write'
against 'add' over two backward passes, autograd.grad, a non-scalar
head, in-place writes into a leaf under recording, and the train flag
that a block called on NDArrays takes from autograd (BatchNorm's
statistics, Dropout) — each on the same numpy inputs in both packages.
Gradients are fp32 through a few elementwise ops and small matmuls:
they agree within 1e-6 (relative and absolute).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import nn as tnn

CPU = mt.cpu()
RS = np.random.RandomState(5)
X = RS.uniform(-1, 1, (4, 3)).astype(np.float32)
W = RS.uniform(-1, 1, (3, 3)).astype(np.float32)


def _close(j, t):
    jn = j.asnumpy() if hasattr(j, "asnumpy") else np.asarray(j)
    tn = t.asnumpy() if hasattr(t, "asnumpy") else np.asarray(t)
    assert jn.dtype == tn.dtype and jn.shape == tn.shape
    np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=1e-6)


def _flags(ag):
    out = [(ag.is_recording(), ag.is_training())]
    with ag.record():
        out.append((ag.is_recording(), ag.is_training()))
        with ag.pause():
            out.append((ag.is_recording(), ag.is_training()))
            with ag.train_mode():
                out.append((ag.is_recording(), ag.is_training()))
        with ag.predict_mode():
            out.append((ag.is_recording(), ag.is_training()))
        out.append((ag.is_recording(), ag.is_training()))
    with ag.record(train_mode=False):
        out.append((ag.is_recording(), ag.is_training()))
        with ag.pause(train_mode=True):
            out.append((ag.is_recording(), ag.is_training()))
    with ag.train_mode():
        out.append((ag.is_recording(), ag.is_training()))
    out.append((ag.is_recording(), ag.is_training()))
    return out


def test_record_pause_train_and_predict_flags():
    assert _flags(mt.autograd) == _flags(mx.autograd)


def _two_passes(pkg, nd_kw, req):
    """Two record/backward passes without a step: x*x*w summed, then
    x*3 summed; returns x.grad after each."""
    x = pkg.nd.array(X, **nd_kw)
    w = pkg.nd.array(W[:, :1].T.repeat(4, 0), **nd_kw)
    x.attach_grad(grad_req=req)
    grads = []
    for f in (lambda: (x * x * w).sum(), lambda: (x * 3.0).sum()):
        with pkg.autograd.record():
            y = f()
        y.backward()
        grads.append(x.grad.asnumpy().copy())
    return grads


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_overwrites_and_add_accumulates(req):
    j = _two_passes(mx, {}, req)
    t = _two_passes(mt, {"ctx": CPU}, req)
    for a, b in zip(j, t):
        _close(a, b)
    first = 2 * X * W[:, :1].T.repeat(4, 0)
    np.testing.assert_allclose(t[0], first, rtol=1e-6)
    want = 3.0 + (first if req == "add" else 0.0)
    np.testing.assert_allclose(t[1], want, rtol=1e-6)


def test_grad_req_null_leaves_no_gradient():
    x = mt.nd.array(X, ctx=CPU)
    x.attach_grad(grad_req="null")
    assert x.grad is None and x.grad_req == "null"
    with mt.autograd.record():
        y = (x * 2.0).sum()
    y.backward()  # nothing to write
    assert x.grad is None


def _grad_fn(pkg, nd_kw):
    x = pkg.nd.array(X, **nd_kw)
    w = pkg.nd.array(W, **nd_kw)
    x.attach_grad()
    w.attach_grad()
    with pkg.autograd.record():
        z = x @ w
        y = (z * z * x.sum(axis=1, keepdims=True)).sum()
    gx, gw = pkg.autograd.grad(y, [x, w])
    return gx, gw, x.grad, w.grad


def test_autograd_grad_returns_gradients_and_writes_no_buffer():
    j = _grad_fn(mx, {})
    t = _grad_fn(mt, {"ctx": CPU})
    _close(j[0], t[0])
    _close(j[1], t[1])
    for buf in t[2:]:
        assert not buf.asnumpy().any()
    x = mt.nd.array(X, ctx=CPU)
    z = mt.nd.array(W, ctx=CPU)
    x.attach_grad()
    z.attach_grad()
    with mt.autograd.record():
        y = (x * 2.0).sum()
    with pytest.raises(MXNetError, match="does not participate"):
        mt.autograd.grad(y, [x, z])


def _heads(pkg, nd_kw):
    x = pkg.nd.array(X, **nd_kw)
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x + x  # non-scalar: a head gradient of ones
    y.backward()
    g1 = x.grad.asnumpy().copy()
    with pkg.autograd.record():
        y = (x * x).sum(axis=1)
    y.backward(pkg.nd.array(np.array([1.0, -2.0, 0.5, 3.0], np.float32),
                            **nd_kw))
    return g1, x.grad.asnumpy().copy()


def test_non_scalar_head_uses_a_head_gradient_of_ones():
    j, t = _heads(mx, {}), _heads(mt, {"ctx": CPU})
    _close(j[0], t[0])
    _close(j[1], t[1])
    np.testing.assert_allclose(t[0], 2 * X + 1, rtol=1e-6)


def _in_place(pkg, nd_kw):
    x = pkg.nd.array(X, **nd_kw)
    x.attach_grad()
    with pkg.autograd.record():
        x += 1.0        # the leaf's value moves; its gradient follows
        y = (x * x).sum()
    y.backward()
    out = [x.asnumpy().copy(), x.grad.asnumpy().copy()]
    z = pkg.nd.array(X, **nd_kw)
    z.attach_grad()
    with pkg.autograd.record():
        z[:] = 2.0      # a write into the leaf, no graph of its own
        z[0, 1] = -1.0
        y = (z * z * 3.0).sum()
    y.backward()
    return out + [z.asnumpy().copy(), z.grad.asnumpy().copy()]


def test_in_place_writes_into_a_leaf_under_recording():
    j, t = _in_place(mx, {}), _in_place(mt, {"ctx": CPU})
    for a, b in zip(j, t):
        _close(a, b)


def test_second_backward_without_retain_graph_reaches_nothing():
    def run(pkg, nd_kw):
        x = pkg.nd.array(X, **nd_kw)
        x.attach_grad(grad_req="add")
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        y.backward()  # the graph is gone: a no-op in both packages
        return x.grad
    _close(run(mx, {}), run(mt, {"ctx": CPU}))


BN_VALS = {"0.weight": W.repeat(2, 0)[:4], "0.bias": W[0, :1].repeat(4),
           "1.gamma": np.linspace(0.5, 2, 4, dtype=np.float32),
           "1.beta": np.linspace(-1, 1, 4, dtype=np.float32),
           "1.running_mean": np.full(4, 0.1, np.float32),
           "1.running_var": np.full(4, 1.5, np.float32)}


def _bn_net(pkg, nn, hybridize):
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3), nn.BatchNorm(in_channels=4),
            nn.Dropout(0.5))
    if pkg is mx:
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(BN_VALS[k]))
    else:
        net.initialize(ctx=CPU)
        load_numpy_params(net, BN_VALS)
    if hybridize:
        net.hybridize()
    return net


def _stats(pkg, net):
    ps = net._collect_params_with_prefix() if pkg is mx \
        else net.collect_params()
    return [ps[k].data().asnumpy().copy()
            for k in ("1.running_mean", "1.running_var")]


@pytest.mark.parametrize("hybridize", [False, True])
def test_train_flag_comes_from_autograd_not_the_module(hybridize):
    """Outside record() a call is inference (moving statistics kept,
    Dropout the identity); record() trains (batch statistics, the moving
    ones updated in place, Dropout drawn); record(train_mode=False) and
    predict_mode() infer while recording."""
    jnet = _bn_net(mx, jnn, hybridize)
    tnet = _bn_net(mt, tnn, hybridize)
    assert tnet.training  # a torch module starts in training mode
    jx, tx = mx.nd.array(X), mt.nd.array(X, ctx=CPU)
    s0 = _stats(mt, tnet)
    # inference outside record(): equal outputs, statistics bit-identical
    _close(jnet(jx), tnet(tx))
    for a, b in zip(s0, _stats(mt, tnet)):
        np.testing.assert_array_equal(a, b)
    for scope in (lambda ag: ag.record(train_mode=False),
                  lambda ag: _nested_predict(ag)):
        with scope(mx.autograd):
            jo = jnet(jx)
        with scope(mt.autograd):
            to = tnet(tx)
        _close(jo, to)
        for a, b in zip(s0, _stats(mt, tnet)):
            np.testing.assert_array_equal(a, b)
    # training under record(): dropout zeroes about half, the statistics
    # move as the JAX package moves them
    with mx.autograd.record():
        jo = jnet(jx)
    with mt.autograd.record():
        to = tnet(tx)
    for a, b in zip(_stats(mx, jnet), _stats(mt, tnet)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert not np.array_equal(_stats(mt, tnet)[0], s0[0])
    zeros = (to.asnumpy() == 0).mean()
    assert 0.2 < zeros < 0.8 and 0.2 < (jo.asnumpy() == 0).mean() < 0.8


class _nested_predict:
    """record() with predict_mode() inside it."""

    def __init__(self, ag):
        self._scopes = [ag.record(), ag.predict_mode()]

    def __enter__(self):
        for s in self._scopes:
            s.__enter__()

    def __exit__(self, *exc):
        for s in reversed(self._scopes):
            s.__exit__(*exc)


def test_dropout_under_record_draws_from_the_device_generator():
    x = mt.nd.ones((64, 64), ctx=CPU)
    masks = []
    for _ in range(2):
        mt.random.seed(7)
        with mt.autograd.record():
            masks.append(mt.nd.Dropout(x, p=0.5).asnumpy())
    np.testing.assert_array_equal(masks[0], masks[1])
    assert set(np.unique(masks[0])) == {0.0, 2.0}
    np.testing.assert_array_equal(mt.nd.Dropout(x, p=0.5).asnumpy(),
                                  x.asnumpy())  # not training: identity


def test_parameters_take_grad_req_add_through_the_block():
    """A Dense layer's parameters with grad_req 'add': two passes sum,
    as in the JAX package; zero_grad clears them."""
    def run(pkg, nn, nd_kw):
        net = nn.Dense(3, in_units=3)
        if pkg is mx:
            net.initialize(ctx=mx.cpu())
            ps = net.collect_params()
            ws = list(ps.values())
        else:
            net.initialize(ctx=CPU)
            ps = net.collect_params()
            ws = [ps["weight"], ps["bias"]]
        ws[0].set_data(W)
        ws[1].set_data(W[0])
        ps.setattr("grad_req", "add")
        x = pkg.nd.array(X, **nd_kw)
        for _ in range(2):
            with pkg.autograd.record():
                y = (net(x) * net(x)).sum()
            y.backward()
        out = [w.grad().asnumpy().copy() for w in ws]
        ps.zero_grad()
        return out + [ws[0].grad().asnumpy()]
    j = run(mx, jnn, {})
    t = run(mt, tnn, {"ctx": CPU})
    for a, b in zip(j, t):
        _close(a, b)
    assert not t[-1].any()


def test_backward_writes_no_tensor_grad():
    """The buffers are the port's own: PyTorch's .grad stays None."""
    net = tnn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    with mt.autograd.record():
        y = net(mt.nd.array(X, ctx=CPU)).sum()
    y.backward()
    assert net.weight._tensor.grad is None
    assert net.collect_params()["weight"].grad().asnumpy().any()
    assert torch.is_grad_enabled()  # the tensor callers' default is kept
