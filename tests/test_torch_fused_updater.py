"""``gluon.Trainer``'s fused update (``optimizer.FusedUpdater``) of
mxnet_tpu_torch against the JAX package's ``Trainer(fuse_step=True)``, on
the CPU (CPU entries of the graph cache run eagerly; ``chip_smoke.py``
holds the captured update on the card).

* Three steps of a small MLP (16-32-10, batch 8) through both packages'
  ``gluon.Trainer(fuse_step=True)``, fp32: SGD with momentum, NAG and
  Adam, weights and states within 1e-5 relative + 1e-6 of the tensor's
  largest magnitude (as tests/test_torch_adam.py holds Adam's
  SPMDTrainer).  In bf16 with ``multi_precision`` the two packages'
  bf16 forwards round the gradients apart (momenta 1.2% off on a few
  elements), so there the two ``FusedUpdater.update_all`` take the same
  bf16 gradients, three steps: the fp32 master weights and states
  within 1e-5 relative + 1e-6 of the largest magnitude, the bf16
  weights the masters rounded.
* The port's fused update equals its eager per-parameter loop
  (``fuse_step=False``) bit for bit: fp32, bf16 without and with
  ``multi_precision``, the three optimizers, with lr_mult/wd_mult.
* The JAX package's ``FusedUnsupported`` case (an optimizer whose fused
  step carries t, on bf16 weights without a master copy): both packages
  latch the eager loop, and their results equal their own
  ``fuse_step=False`` runs.
* Builds: one entry for the first step, none for ``set_learning_rate``
  or a new batch size (rescale_grad), and a counted new one when a
  gradient buffer is rebound or the weights are reloaded
  (``load_parameters``), with the eager loop's bits after it.
* ``fuse_step=True`` with an optimizer without a fused path warns and
  runs the eager loop, as in the JAX package.
"""
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.optimizer import optimizer as jopt

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.optimizer import fused as tfused

CPU = mt.cpu()
B, STEPS = 8, 3
OPTS = {"sgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-3),
        "nag": dict(learning_rate=0.05, momentum=0.9, wd=1e-3),
        "adam": dict(learning_rate=0.01, wd=1e-3)}


def _values():
    rs = np.random.RandomState(3)
    shapes = {"0.weight": (32, 16), "0.bias": (32,), "1.weight": (10, 32),
              "1.bias": (10,)}
    return {k: (0.3 * rs.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def _batches():
    rs = np.random.RandomState(9)
    return [(rs.randn(B, 16).astype(np.float32),
             rs.randint(0, 10, B).astype(np.int32)) for _ in range(STEPS)]


def _jax_run(opt, vals, dtype, mp, fuse, optimizer=None):
    net = jnn.HybridSequential()
    net.add(jnn.Dense(32, activation="relu"), jnn.Dense(10))
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.zeros((1, 16)))
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
    if dtype != "float32":
        net.cast(dtype)
    net.hybridize()
    kw = dict(OPTS[opt], multi_precision=mp)
    tr = mx.gluon.Trainer(net.collect_params(), optimizer or opt,
                          None if optimizer else kw, fuse_step=fuse)
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in _batches():
        with mx.autograd.record():
            loss = lf(net(mx.nd.array(x).astype(dtype)), mx.nd.array(y))
        loss.backward()
        tr.step(B)
    return tr, {k: p for k, p in params.items()}


def _port_net(vals, dtype, mults=False):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(32, activation="relu", in_units=16),
            tnn.Dense(10, in_units=32))
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    if dtype != "float32":
        net.cast(dtype)
    if mults:
        for k, p in net.collect_params().items():
            if k.endswith("bias"):
                p.wd_mult = 0.0
            if k == "0.weight":
                p.lr_mult = 0.5
    net.hybridize()
    return net


def _port_run(opt, vals, dtype, mp, fuse, mults=False, optimizer=None,
              between=None):
    net = _port_net(vals, dtype, mults)
    kw = dict(OPTS[opt], multi_precision=mp)
    tr = mt.gluon.Trainer(net.collect_params(), optimizer or opt,
                          None if optimizer else kw, fuse_step=fuse)
    lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for i, (x, y) in enumerate(_batches()):
        if between is not None:
            between(i, net, tr)
        with mt.autograd.record():
            loss = lf(net(mt.nd.array(x, ctx=CPU).astype(dtype)),
                      mt.nd.array(y, ctx=CPU))
        loss.backward()
        tr.step(B)
    return tr, net


def _np(t):
    t = t._data if hasattr(t, "_data") else t
    return t.detach().float().numpy()


def _flat(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _flat(v)]
    return [s]


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel[0],
                               atol=rel[1] * np.abs(want).max(), err_msg=what)


REL = (1e-5, 1e-6)


@pytest.mark.parametrize("opt", ["sgd", "nag", "adam"])
def test_fused_update_matches_jax_fuse_step_fp32(opt):
    vals = _values()
    s0 = tfused.compile_stats()["count"]
    jtr, jparams = _jax_run(opt, vals, "float32", False, True)
    ttr, tnet = _port_run(opt, vals, "float32", False, True)
    assert tfused.compile_stats()["count"] - s0 == 1
    assert ttr._fuse_resolved() and ttr._fuse_update_ok
    assert jtr._fuse_resolved() and jtr._fuse_update_ok
    tparams = tnet.collect_params()
    jstates = jtr._updaters[0].states
    tstates = ttr._updater.states
    for i, (k, jp) in enumerate(jparams.items()):
        js, ts = _flat(jstates[i]), _flat(tstates[i])
        assert len(js) == len(ts), k
        for a, b in zip(ts, js):
            _close(_np(a), b.asnumpy(), REL, f"{opt} state {k}")
        _close(_np(tparams[k].data()), jp.data().asnumpy(), REL,
               f"{opt} weight {k}")


@pytest.mark.parametrize("opt", ["sgd", "nag", "adam"])
def test_fused_update_matches_jax_bf16_multi_precision(opt):
    from mxnet_tpu.optimizer.fused import FusedUpdater as JFused

    vals = _values()
    names = list(vals)
    rs = np.random.RandomState(4)
    grads = [[(rs.randn(*vals[k].shape)).astype(ml_dtypes.bfloat16)
              for k in names] for _ in range(STEPS)]
    kw = dict(OPTS[opt], multi_precision=True, rescale_grad=1.0 / B)
    ju = JFused(jopt.create(opt, **kw))
    tu = topt.FusedUpdater(topt.create(opt, **kw))
    jw = [mx.nd.array(vals[k]).astype("bfloat16") for k in names]
    tw = [mt.nd.array(vals[k], ctx=CPU).astype("bfloat16") for k in names]
    idx = list(range(len(names)))
    for g in grads:
        ju.update_all(idx, [mx.nd.array(a) for a in g], jw)
        tu.update_all(idx, [mt.nd.array(a, ctx=CPU) for a in g], tw)
    for i, k in enumerate(names):
        js, ts = _flat(ju.states[i]), _flat(tu.states[i])
        assert len(js) == len(ts) and ts[-1]._data.dtype == torch.float32
        for a, b in zip(ts, js):
            _close(_np(a), b.asnumpy(), REL, f"{opt} state {k}")
        # the bf16 weight is its fp32 master rounded
        assert torch.equal(tw[i]._data, ts[-1]._data.to(torch.bfloat16)), k


@pytest.mark.parametrize("opt", ["sgd", "nag", "adam"])
@pytest.mark.parametrize("prec", ["fp32", "bf16", "bf16_mp"])
def test_fused_update_is_the_eager_loop_bit_for_bit(opt, prec):
    vals = _values()
    dtype = "float32" if prec == "fp32" else "bfloat16"
    mp = prec == "bf16_mp"
    runs = [_port_run(opt, vals, dtype, mp, fuse, mults=True)
            for fuse in (True, False)]
    (ftr, fnet), (etr, enet) = runs
    assert ftr._fuse_update_ok and not etr._fuse_resolved()
    for k, v in fnet.state_dict(keep_vars=True).items():
        assert torch.equal(v, enet.state_dict(keep_vars=True)[k]), k
    for i, s in ftr._updater.states.items():
        for a, b in zip(_flat(s), _flat(etr._updater.states[i])):
            assert torch.equal(a._data, b._data), (k, i)


class _TAdamJ(jopt.Adam):
    _FUSED_T_HYPER = True


class _TAdamT(topt.Adam):
    _FUSED_T_HYPER = True


def test_fused_unsupported_takes_the_eager_loop_in_both_packages():
    vals = _values()
    kw = dict(OPTS["adam"])
    jruns = [_jax_run("adam", vals, "bfloat16", False, fuse,
                      optimizer=_TAdamJ(**kw)) for fuse in (True, False)]
    truns = [_port_run("adam", vals, "bfloat16", False, fuse,
                       optimizer=_TAdamT(**kw)) for fuse in (True, False)]
    assert jruns[0][0]._fuse_resolved() and not jruns[0][0]._fuse_update_ok
    assert truns[0][0]._fuse_resolved() and not truns[0][0]._fuse_update_ok
    for k, p in jruns[0][1].items():
        np.testing.assert_array_equal(
            p.data().asnumpy(), jruns[1][1][k].data().asnumpy())
    tw = [net.state_dict(keep_vars=True) for _, net in truns]
    for k, v in tw[0].items():
        assert torch.equal(v, tw[1][k]), k


def test_builds_once_and_again_only_for_moved_storage(tmp_path):
    vals = _values()
    f = str(tmp_path / "w.params")
    log = []

    def between(i, net, tr):
        log.append(tfused.compile_stats()["count"])
        if i == 1:
            tr.set_learning_rate(0.02)
            p = net.collect_params()["0.weight"]._tensor
            p._mx_grad = p._mx_grad.clone()  # a rebound gradient buffer
        if i == 2:
            net.save_parameters(f)
            net.load_parameters(f)

    s0 = tfused.compile_stats()
    ftr, fnet = _port_run("sgd", vals, "float32", False, True,
                          between=between)
    s1 = tfused.compile_stats()
    # built at step 0; step 1 replays; the rebound buffer builds at step
    # 1's update, the reload at step 2's
    assert [c - s0["count"] for c in log] == [0, 1, 2]
    assert s1["count"] - s0["count"] == 3
    assert s1["evictions"] - s0["evictions"] == 2

    def eager_between(i, net, tr):
        if i == 1:
            tr.set_learning_rate(0.02)
    etr, enet = _port_run("sgd", vals, "float32", False, False,
                          between=eager_between)
    for k, v in fnet.state_dict(keep_vars=True).items():
        assert torch.equal(v, enet.state_dict(keep_vars=True)[k]), k
    # a new batch size (rescale_grad) replays
    lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    x = mt.nd.array(_batches()[0][0][:4], ctx=CPU)
    y = mt.nd.array(_batches()[0][1][:4], ctx=CPU)
    with mt.autograd.record():
        loss = lf(fnet(x), y)
    loss.backward()
    ftr.step(4)
    assert tfused.compile_stats()["count"] == s1["count"]


def test_fuse_step_true_without_a_fused_path_warns():
    class NoFused(topt.SGD):
        _FUSED_STATIC = None

    net = _port_net(_values(), "float32")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = mt.gluon.Trainer(net.collect_params(), NoFused(), fuse_step=True)
        assert not tr._fuse_resolved()
    assert any("fused path" in str(m.message) for m in w)
