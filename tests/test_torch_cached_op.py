"""The training-mode CachedOp of mxnet_tpu_torch (a hybridized forward
under ``autograd.record()``) and gradient mirroring, on the CPU.

On CPU tensors the training-mode entry runs its function eagerly behind
the same autograd function and bookkeeping as the captured one on the
card (``_graphs.EagerPair``; ``chip_smoke.py`` holds the graphs' bits):

* builds and hits per signature, the recording flag, a parameter's
  grad_req, an input's requires_grad and the mirror flag each keying a
  new build; ``cached_op_stats()``; an output the loss does not use gets
  a zero cotangent; grad_req 'add' accumulates as eagerly;
* two forwards in flight take two entries (a second build) and give the
  eager gradients; a second backward through a consumed entry raises;
* a narrow ResNet V1 (float64, op-granular, BatchNorm in training) and a
  2-layer BERT at dropout 0 (fp32) trained 3 steps through the
  hybridized gluon.Trainer loop (sgd, momentum 0.9) against the JAX
  package's CachedOp loop, mirror off and on: every parameter, running
  statistic and loss within 1e-9 relative (float64) / 1e-5 (fp32) of
  the tensor's largest magnitude;
* the counterparts of tests/test_gluon.py's test_gradient_mirroring_remat,
  ..._with_batchnorm_aux and ..._env_route, and a dropout net whose
  gradients under mirror equal those without it from one generator
  state.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.bert import get_bert_model as jax_bert
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _graphs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

CPU = mt.cpu()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mlp(mirror=None, dropout=0.0):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, activation="relu", in_units=6))
    if dropout:
        net.add(tnn.Dropout(dropout))
    net.add(tnn.BatchNorm(in_channels=8), tnn.Dense(3, in_units=8))
    net.initialize(mt.initializer.Xavier(), ctx=CPU, seed=3)
    if mirror is None:
        net.hybridize()
    else:
        net.hybridize(mirror=mirror)
    return net


def _step(net, x, req_grad=False):
    x = mt.nd.array(x, ctx=CPU)
    if req_grad:
        x.attach_grad()
    with mt.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    return loss


def _builds():
    return tblock.cached_op_stats()["count"]


def test_builds_and_hits_per_signature(monkeypatch):
    net = _mlp()
    n0 = _builds()
    x = _x(4, 6)
    _step(net, x)
    _step(net, x)
    assert _builds() - n0 == 1  # one training-mode entry, then hits
    net(mt.nd.array(x, ctx=CPU))  # outside record(): the inference entry
    assert _builds() - n0 == 2
    _step(net, _x(5, 6))  # another shape
    assert _builds() - n0 == 3
    _step(net, x, req_grad=True)  # an input that requires a gradient
    assert _builds() - n0 == 4
    net.collect_params()["0.weight"].grad_req = "null"
    _step(net, x)
    assert _builds() - n0 == 5
    net.collect_params()["0.weight"].grad_req = "write"
    _step(net, x)
    assert _builds() - n0 == 5  # back to the first entry
    net.hybridize(mirror=True)
    _step(net, x)
    assert _builds() - n0 == 6
    stats = tblock.cached_op_stats()
    assert set(stats) == {"count", "seconds_total", "cache_loads",
                          "evictions", "size", "eager", "custom_eager"}
    assert len(tblock._FWD_CACHE.entries(net)) >= 5
    with _graphs.no_capture():  # the eager path builds nothing
        _step(net, x)
    assert _builds() - n0 == 6


def test_training_entry_equals_the_eager_forward_and_backward():
    x = _x(4, 6)
    grads = {}
    for mode in ("entry", "eager"):
        net = _mlp()
        xs = mt.nd.array(x, ctx=CPU)
        xs.attach_grad()
        with mt.autograd.record():
            if mode == "eager":
                with _graphs.no_capture():
                    out = net(xs)
            else:
                out = net(xs)
            loss = (out ** 2).sum()
        loss.backward()
        grads[mode] = {k: p.grad().asnumpy() for k, p in
                       net.collect_params().items() if p.grad_req != "null"}
        grads[mode]["x"] = xs.grad.asnumpy()
        grads[mode]["mean"] = net[1].running_mean.data().asnumpy()
    for k in grads["eager"]:
        np.testing.assert_array_equal(grads["entry"][k], grads["eager"][k])


class _TwoHeads(mt.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.a = tnn.Dense(3, in_units=4)
        self.b = tnn.Dense(2, in_units=4)

    def hybrid_forward(self, F, x):
        return self.a(x), self.b(x)


def test_an_unused_output_gets_a_zero_cotangent_and_add_accumulates():
    net = _TwoHeads()
    net.initialize(ctx=CPU)
    net.hybridize()
    ps = net.collect_params()
    ps["a.weight"].grad_req = "add"
    x = mt.nd.array(_x(5, 4), ctx=CPU)
    for _ in range(2):
        with mt.autograd.record():
            a, b = net(x)
            loss = (a * a).sum()  # b is not used
        loss.backward()
    with mt.autograd.record():
        with _graphs.no_capture():
            a, b = net(x)
        ref = (a * a).sum()
    ga = mt.autograd.grad(ref, [ps["a.weight"].data()])[0].asnumpy()
    np.testing.assert_allclose(ps["a.weight"].grad().asnumpy(), 2 * ga,
                               rtol=1e-6)
    assert np.all(ps["b.weight"].grad().asnumpy() == 0)


def test_two_forwards_in_flight_take_two_entries():
    x1, x2 = _x(4, 6, seed=1), _x(4, 6, seed=2)
    res = {}
    for mode in ("entry", "eager"):
        net = _mlp()
        n0 = _builds()
        with mt.autograd.record():
            if mode == "eager":
                with _graphs.no_capture():
                    o1 = net(mt.nd.array(x1, ctx=CPU))
                    o2 = net(mt.nd.array(x2, ctx=CPU))
            else:
                o1 = net(mt.nd.array(x1, ctx=CPU))
                o2 = net(mt.nd.array(x2, ctx=CPU))
            loss = (o1 * o2).sum() + (o1 ** 2).sum()  # a siamese loss
        loss.backward()
        res[mode] = ({k: p.grad().asnumpy() for k, p in
                      net.collect_params().items() if p.grad_req != "null"},
                     _builds() - n0)
    assert res["entry"][1] == 2 and res["eager"][1] == 0
    for k, g in res["eager"][0].items():
        np.testing.assert_allclose(res["entry"][0][k], g, rtol=1e-6,
                                   atol=1e-7)
    # a third call after both backwards reuses a free entry
    net = _mlp()
    _step(net, x1)
    n0 = _builds()
    _step(net, x1)
    assert _builds() == n0


def test_a_second_backward_through_a_consumed_entry_raises():
    net = _mlp()
    x = mt.nd.array(_x(4, 6), ctx=CPU)
    with mt.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward(retain_graph=True)
    with pytest.raises(MXNetError, match="second backward"):
        loss.backward()


# ---------------------------------------------------------------------------
# the hybridized gluon.Trainer loop against the JAX package's CachedOp loop
# ---------------------------------------------------------------------------

RB, RSIZE, STEPS = 4, 16, 3
# scalars exact in fp32: the JAX package's update rounds lr, momentum and
# wd to fp32 even for float64 weights (lr 0.1 steps by 0.100000001490116;
# ROADMAP §C), the port's keeps them in the weights' dtype
OPT = {"learning_rate": 0.125, "momentum": 0.875, "wd": 2.0 ** -13}


def _resnet(pkg):
    return pkg.ResNetV1(pkg.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                        classes=10, thumbnail=True)


def _rdata():
    rs = np.random.RandomState(11)
    return rs.rand(RB, 3, RSIZE, RSIZE), (np.arange(RB) % 10)


def _hold_runs(j, t, rtol):
    for a, b in zip(t[0], j[0]):
        assert abs(a - b) <= rtol * max(1.0, abs(b)), (t[0], j[0])
    assert set(t[1]) == set(j[1])
    for k, v in j[1].items():
        np.testing.assert_allclose(t[1][k], v, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(v).max()),
                                   err_msg=k)


def _jax_resnet_run(mirror):
    x, y = _rdata()
    with jax.enable_x64(True):
        net = _resnet(jres)
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(x.astype(np.float32)))
        net.cast("float64")
        named = net._collect_params_with_prefix()
        vals = {k: p.data().asnumpy() for k, p in named.items()}
        net.hybridize(mirror=mirror)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        xs = mx.nd.array(x, dtype="float64")
        ys = mx.nd.array(y, dtype="float64")
        losses = []
        for _ in range(STEPS):
            with mx.autograd.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            tr.step(RB)
            losses.append(float(loss.mean().asscalar()))
        return vals, (losses, {k: p.data().asnumpy()
                               for k, p in named.items()})


def _port_resnet_run(vals, mirror):
    x, y = _rdata()
    net = _resnet(tres)
    net.initialize(ctx=CPU)
    net.cast("float64")
    load_numpy_params(net, vals)
    net.hybridize(mirror=mirror)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = mt.nd.array(x, ctx=CPU, dtype="float64")
    ys = mt.nd.array(y, ctx=CPU, dtype="float64")
    n0 = _builds()
    losses = []
    for _ in range(STEPS):
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        tr.step(RB)
        losses.append(float(loss.mean().asscalar()))
    assert _builds() - n0 == 1
    return losses, {k: v.detach().numpy() for k, v in
                    net.state_dict(keep_vars=True).items()}


@pytest.mark.parametrize("mirror", [False, True])
def test_resnet_float64_gluon_loop_matches_the_jax_cached_op(mirror):
    vals, j = _jax_resnet_run(mirror)
    t = _port_resnet_run(vals, mirror)
    _hold_runs(j, t, 1e-9)


BERT = dict(vocab_size=60, num_layers=2, units=16, hidden_size=32,
            num_heads=2, max_length=16, dropout=0.0)
BB, BS = 3, 8


def _bert_batch():
    rs = np.random.RandomState(4)
    return (rs.randint(0, 60, (BB, BS)).astype(np.int32),
            rs.randint(0, 2, (BB, BS)).astype(np.int32),
            np.array([8, 5, 3], np.float32),
            rs.randint(0, 60, (BB, BS)).astype(np.float32),
            rs.randint(0, 2, (BB,)).astype(np.float32))


def _bert_loop(m, net, ctx, tr):
    tok, seg, vl, mlm_y, nsp_y = _bert_batch()
    kw = {} if m is mx else {"ctx": ctx}
    tok, seg = (m.nd.array(a, dtype="int32", **kw) for a in (tok, seg))
    vl, mlm_y, nsp_y = (m.nd.array(a, **kw) for a in (vl, mlm_y, nsp_y))
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(STEPS):
        with m.autograd.record():
            seq, pooled = net(tok, seg, vl)
            loss = loss_fn(net.decode_mlm(seq), mlm_y).mean() \
                + loss_fn(net.classify_nsp(pooled), nsp_y).mean()
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asscalar()))
    return losses


@pytest.mark.parametrize("mirror", [False, True])
def test_bert_gluon_loop_matches_the_jax_cached_op(mirror):
    tok, seg, vl, _, _ = _bert_batch()
    jnet = jax_bert("bert_12_768_12", **BERT)
    jnet.initialize(mx.initializer.Normal(0.02), ctx=mx.cpu())
    seq, pooled = jnet(mx.nd.array(tok, dtype="int32"),
                       mx.nd.array(seg, dtype="int32"), mx.nd.array(vl))
    jnet.decode_mlm(seq), jnet.classify_nsp(pooled)
    named = jnet._collect_params_with_prefix()
    vals = {k: p.data().asnumpy() for k, p in named.items()}
    jnet.hybridize(mirror=mirror)
    # the JAX package's hybridized MLM decoder cannot run: its tied
    # embed_weight is not in its collect_params(), so its CachedOp trace
    # misses it; the heads run eagerly there, as the port runs them in the
    # trace scope of the net (ROADMAP §C)
    jnet.mlm_decoder.hybridize(False)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    jl = _bert_loop(mx, jnet, None, jtr)
    j = (jl, {k: p.data().asnumpy() for k, p in named.items()})

    tnet = tbert.get_bert_model("bert_12_768_12", **BERT)
    tnet.initialize(ctx=CPU)
    load_numpy_params(tnet, vals)
    tnet.hybridize(mirror=mirror)
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    n0 = _builds()
    tl = _bert_loop(mt, tnet, CPU, ttr)
    # the net and its two hybridized heads, each its own CachedOp
    assert _builds() - n0 == 3
    t = (tl, {k: v.detach().numpy() for k, v in
              tnet.state_dict(keep_vars=True).items()})
    _hold_runs(j, t, 1e-5)


# ---------------------------------------------------------------------------
# gradient mirroring
# ---------------------------------------------------------------------------

def _segments(monkeypatch):
    """Count the checkpoint segments the forwards make."""
    made = []
    real = _graphs.segment

    def spy():
        made.append(1)
        return real()
    monkeypatch.setattr(_graphs, "segment", spy)
    return made


def test_gradient_mirroring_remat(monkeypatch):
    x = _x(4, 8, seed=1)

    def build(mirror):
        net = tnn.Sequential()
        net.add(tnn.Dense(16, activation="relu", in_units=8))
        net.add(tnn.Dense(4, in_units=16))
        net.initialize(mt.initializer.Xavier(), ctx=CPU)
        net.hybridize(mirror=mirror)
        return net

    made = _segments(monkeypatch)
    grads = []
    for mirror in (False, True):
        net = build(mirror)
        with mt.autograd.record():
            loss = (net(mt.nd.array(x, ctx=CPU)) ** 2).sum()
        loss.backward()
        grads.append(net.collect_params()["0.weight"].grad().asnumpy())
        if not mirror:
            assert not made
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6)
    assert len(made) == 2  # each Dense (it owns parameters) is a segment
    # the JAX package's test of the same name
    np.random.seed(0)
    jnet = jnn.Sequential()
    jnet.add(jnn.Dense(16, activation="relu", in_units=8),
             jnn.Dense(4, in_units=16))
    jnet.initialize(mx.initializer.Xavier())
    jnet.hybridize(mirror=True)
    assert jnet[0]._flags["mirror"] is True


def test_gradient_mirroring_with_batchnorm_aux():
    """The running statistics advance once a step under mirror, and the
    gradients equal those without it."""
    x = (_x(16, 4) * 2 + 1)
    res = {}
    for mirror in (False, True):
        net = tnn.HybridSequential()
        net.add(tnn.Dense(8, in_units=4), tnn.BatchNorm(in_channels=8),
                tnn.Dense(2, in_units=8))
        net.initialize(mt.initializer.Xavier(), ctx=CPU, seed=2)
        net.hybridize(mirror=mirror)
        before = net[1].running_mean.data()._data.detach().clone()
        with mt.autograd.record():
            loss = (net(mt.nd.array(x, ctx=CPU)) ** 2).sum()
        loss.backward()
        res[mirror] = (net[1].running_mean.data()._data.detach().clone(),
                       net[1].running_var.data()._data.detach().clone(),
                       net.collect_params()["0.weight"].grad().asnumpy())
        assert not torch.equal(before, res[mirror][0])
    assert torch.equal(res[False][0], res[True][0])
    assert torch.equal(res[False][1], res[True][1])
    np.testing.assert_allclose(res[True][2], res[False][2], rtol=1e-6,
                               atol=1e-7)
    assert np.isfinite(res[True][2]).all()


def test_gradient_mirroring_env_route(monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    made = _segments(monkeypatch)
    net = tnn.Dense(4, in_units=3)
    net.initialize(ctx=CPU)
    net.hybridize()
    assert net._mirror()
    with mt.autograd.record():
        loss = (net(mt.nd.array(np.ones((2, 3), np.float32), ctx=CPU))
                ** 2).sum()
    loss.backward()
    assert made
    assert np.isfinite(net.collect_params()["weight"].grad().asnumpy()).all()
    net.hybridize(mirror=False)  # hybridize's flag wins over the knob
    assert not net._mirror()


def test_dropout_under_mirror_gives_the_gradients_without_it():
    x = _x(6, 6, seed=3)
    grads = {}
    for mirror in (False, True):
        net = _mlp(mirror=mirror, dropout=0.3)
        mt.random.seed(5)
        with mt.autograd.record():
            loss = (net(mt.nd.array(x, ctx=CPU)) ** 2).sum()
        loss.backward()
        grads[mirror] = {k: p.grad().asnumpy() for k, p in
                         net.collect_params().items()
                         if p.grad_req != "null"}
    for k, g in grads[False].items():
        np.testing.assert_array_equal(grads[True][k], g, err_msg=k)
    assert any(np.abs(g).max() > 0 for g in grads[True].values())
