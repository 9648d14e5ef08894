"""MXNet's imperative training loop on mxnet_tpu_torch against the JAX
package, on the CPU.

* The MNIST MLP of examples/gluon/mnist.py (784-128-64-10, weights
  carried across) trains 20 steps at batch 50 on the synthetic set
  through each package's autograd.record / backward / gluon.Trainer.step
  (sgd, lr 0.1, momentum 0.9): plain, with lr_mult/wd_mult on one layer
  (and wd 1e-3), and with NAG.  Tolerances (fp32, measured worst over
  the three cases: weights 6.1e-6, momenta 8.9e-5 of the tensor's
  largest element): weights within 3e-5 and momenta within 5e-4 of
  max|tensor|.
* A narrow hybridized NHWC bottleneck ResNet V1, fused forward and
  backward (MXNET_FUSED_CONVBN=1, MXNET_FUSED_CONVBN_BWD=1; CPU tensors
  run the kernels' plain versions), trains two steps through
  gluon.Trainer (lr 1e-3, momentum 0.9, wd 1e-4, running means warm, as
  tests/test_torch_resnet_train.py sets them up and for its reasons):
  against the JAX package's hybridized gluon.Trainer run, with that
  file's fp32 bounds (loss rtol 1e-4; parameters and running statistics
  rtol 1e-4 + 1e-4·max|tensor| + 1e-6; momenta rtol 1e-4 +
  5e-3·max|tensor| + 1e-7); and against the port's SPMDTrainer from the
  same start within 1e-6 relative: the summed loss rescaled by 1/16 and
  the mean loss differ by a power of two only.
* Outside record() a forward leaves the running statistics
  bit-identical, in both packages.
* Two departures from the JAX package, held on both sides: on bf16
  weights the eager update is the port's SPMDTrainer update bit for bit
  (lr promotes lr·g to fp32, where the JAX package's eager update keeps
  it in bf16 and lands one rounding away), and NAG under
  multi_precision runs nag_mom_update on the fp32 master copy (the JAX
  package's NAG inherits SGD's mp_sgd_mom_update there).
* The synthetic MNIST sets equal the JAX package's bit for bit; the
  metrics, the save_states/load_states payloads (across the packages,
  both ways), the data loader, the local KVStore and gluon.utils agree
  with the JAX package; the example script reaches val accuracy > 0.9
  on the CPU.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import ml_dtypes

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import ActiveTrace, load_numpy_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import fused_convbn as tfc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
B, STEPS = 50, 20
MLP_SHAPES = {"0.weight": (128, 784), "0.bias": (128,),
              "1.weight": (64, 128), "1.bias": (64,),
              "2.weight": (10, 64), "2.bias": (10,)}


def _mlp_values():
    rs = np.random.RandomState(0)
    return {k: (rs.uniform(-1, 1, s) * np.sqrt(6.0 / (s[-1] + s[0])))
            .astype(np.float32) for k, s in MLP_SHAPES.items()}


_BATCHES = []


def _mnist_batches():
    """The first STEPS batches of B synthetic training images, in order,
    as the example's transformer makes them (made once)."""
    if not _BATCHES:
        ds = mt.gluon.data.vision.MNIST(train=True)
        for i in range(STEPS):
            sl = slice(i * B, (i + 1) * B)
            _BATCHES.append((ds._data[sl].reshape(B, 784).astype(
                np.float32) / 255.0, ds._label[sl]))
    return _BATCHES


def _states(trainer, tmp_path, tag):
    f = str(tmp_path / f"{tag}.states")
    trainer.save_states(f)
    with open(f, "rb") as fh:
        return pickle.load(fh), f


def _jax_mlp(vals, opt, mults, tmp_path):
    net = jnn.HybridSequential()
    net.add(jnn.Dense(128, activation="relu"), jnn.Dense(64,
                                                         activation="relu"),
            jnn.Dense(10))
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.zeros((1, 784)))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(vals[k]))
    net.hybridize()
    if mults:
        net[1].weight.lr_mult, net[1].weight.wd_mult = 0.5, 2.0
    tr = mx.gluon.Trainer(net.collect_params(), opt, {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3 if mults else 0})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in _mnist_batches():
        x, y = mx.nd.array(x), mx.nd.array(y)
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(B)
    w = {k: p.data().asnumpy() for k, p in
         net._collect_params_with_prefix().items()}
    return w, _states(tr, tmp_path, "jax")


def _port_mlp(vals, opt, mults, tmp_path):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(128, activation="relu", in_units=784),
            tnn.Dense(64, activation="relu", in_units=128),
            tnn.Dense(10, in_units=64))
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    net.hybridize()
    params = net.collect_params()
    if mults:
        params["1.weight"].lr_mult, params["1.weight"].wd_mult = 0.5, 2.0
    tr = mt.gluon.Trainer(params, opt, {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3 if mults else 0})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in _mnist_batches():
        x, y = mt.nd.array(x, ctx=CPU), mt.nd.array(y, ctx=CPU)
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(B)
    w = {k: p.data().asnumpy() for k, p in params.items()}
    return w, _states(tr, tmp_path, "port"), tr, net


_RUNS = {}


def _runs(opt, mults, tmp_path):
    """Both packages' runs of one case (each made once)."""
    if (opt, mults) not in _RUNS:
        vals = _mlp_values()
        _RUNS[opt, mults] = (_jax_mlp(vals, opt, mults, tmp_path),
                             _port_mlp(vals, opt, mults, tmp_path))
    return _RUNS[opt, mults]


@pytest.mark.parametrize("opt,mults", [("sgd", False), ("sgd", True),
                                       ("nag", False)])
def test_mnist_mlp_trains_as_the_jax_package(opt, mults, tmp_path):
    vals = _mlp_values()
    (jw, (js, _)), (tw, (ts, _), _, _) = _runs(opt, mults, tmp_path)
    names = list(MLP_SHAPES)
    assert sorted(js) == sorted(ts) == list(range(len(names)))
    for i, k in enumerate(names):
        np.testing.assert_allclose(
            tw[k], jw[k], rtol=0, atol=3e-5 * np.abs(jw[k]).max(),
            err_msg=k)
        np.testing.assert_allclose(
            ts[i], js[i], rtol=0, atol=5e-4 * np.abs(js[i]).max(),
            err_msg=f"momentum {k}")
        assert np.abs(tw[k] - vals[k]).max() > 1e-2  # it trained
    if mults:  # the multipliers took: 1.weight moved less than in "sgd"
        plain = _runs("sgd", False, tmp_path)[1][0]
        assert np.abs(tw["1.weight"] - vals["1.weight"]).max() < \
            0.8 * np.abs(plain["1.weight"] - vals["1.weight"]).max()


def test_save_and_load_states_across_the_packages(tmp_path):
    (_, (js, jfile)), (_, (ts, tfile), tr, net) = _runs("sgd", False,
                                                        tmp_path)
    # the JAX package's file loads into the port's trainer
    tr.load_states(jfile)
    got, _ = _states(tr, tmp_path, "reloaded")
    for i in js:
        np.testing.assert_array_equal(got[i], js[i])
    # and the port's file into a fresh JAX trainer, bit for bit
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(128, activation="relu"),
             jnn.Dense(64, activation="relu"), jnn.Dense(10))
    jnet.initialize(ctx=mx.cpu())
    jnet(mx.nd.zeros((1, 784)))
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    jtr.load_states(tfile)
    jtr.allreduce_grads()  # initializes the store, which applies them
    back, _ = _states(jtr, tmp_path, "jax_reloaded")
    assert sorted(back) == sorted(ts)
    for i in ts:
        np.testing.assert_array_equal(back[i], ts[i])
    # a fresh port trainer defers the load to its first step, as there
    tr2 = mt.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    tr2.load_states(jfile)
    tr2.allreduce_grads()
    got2, _ = _states(tr2, tmp_path, "deferred")
    for i in js:
        np.testing.assert_array_equal(got2[i], js[i])


@pytest.mark.parametrize("cls,train", [("MNIST", True), ("MNIST", False),
                                       ("FashionMNIST", True)])
def test_synthetic_mnist_equals_the_jax_package(cls, train):
    j = getattr(mx.gluon.data.vision, cls)(train=train)
    t = getattr(mt.gluon.data.vision, cls)(train=train)
    assert j.synthetic and t.synthetic and len(j) == len(t)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    ji, jl = j[5]
    ti, tl = t[5]
    np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
    assert ti.dtype == ji.dtype and ti.ctx == CPU and tl == jl


def test_data_loader_batches_equal_the_jax_package():
    def tf(img, label):
        return img.astype("float32").reshape((-1,)) / 255.0, label

    j = mx.gluon.data.DataLoader(mx.gluon.data.vision.MNIST(
        train=False).transform(tf), batch_size=64, last_batch="keep")
    t = mt.gluon.data.DataLoader(mt.gluon.data.vision.MNIST(
        train=False).transform(tf), batch_size=64, last_batch="keep")
    assert len(t) == 32
    for n, ((jx, jy), (tx, ty)) in enumerate(zip(j, t)):
        assert tx.ctx == CPU and tx.dtype == jx.dtype == np.float32
        assert ty.dtype == jy.dtype
        np.testing.assert_allclose(tx.asnumpy(), jx.asnumpy(), rtol=1e-7)
        np.testing.assert_array_equal(ty.asnumpy(), jy.asnumpy())
        if n == 2:
            break
    ds = mt.gluon.data.ArrayDataset(np.arange(10), np.arange(10) * 2.0)
    batches = list(mt.gluon.data.DataLoader(ds, batch_size=4,
                                            last_batch="discard"))
    assert len(batches) == 2 and batches[1][1].asnumpy().tolist() == \
        [8.0, 10.0, 12.0, 14.0]
    # the worker pool gives the batches of the calling thread
    pooled = list(mt.gluon.data.DataLoader(ds, batch_size=4,
                                           last_batch="discard",
                                           num_workers=2))
    assert len(pooled) == 2
    for a, b in zip(pooled, batches):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.asnumpy(), v.asnumpy())


METRICS = [("Accuracy", "acc", {}), ("TopKAccuracy", "top_k_accuracy",
                                     {"top_k": 3}),
           ("CrossEntropy", "ce", {}), ("F1", "f1", {}), ("MAE", "mae", {}),
           ("RMSE", "rmse", {}), ("Perplexity", "perplexity", {}),
           ("Loss", "loss", {})]


@pytest.mark.parametrize("name,key,kw", METRICS)
def test_metrics_agree_with_the_jax_package(name, key, kw):
    rs = np.random.RandomState(9)
    jm = getattr(mx.metric, name)(**kw)
    tm = getattr(mt.metric, name)(**kw)
    for _ in range(3):
        logits = rs.randn(32, 2 if name == "F1" else 10).astype(np.float32)
        p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        label = rs.randint(0, p.shape[1], 32).astype(np.float32)
        jm.update([mx.nd.array(label)], [mx.nd.array(p)])
        tm.update([mt.nd.array(label, ctx=CPU)], [mt.nd.array(p, ctx=CPU)])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    assert mt.metric.create(key, **kw).name == jn


def test_local_kvstore_and_gluon_utils():
    kv = mt.kvstore.create("local")
    a, b = (mt.nd.array(np.full((2, 3), v, np.float32), ctx=CPU)
            for v in (1.0, 2.5))
    kv.init(3, a)
    kv.push(3, [a, b])
    out = mt.nd.zeros((2, 3), ctx=CPU)
    kv.pull(3, out=out)
    assert (out.asnumpy() == 3.5).all()
    outs = [mt.nd.zeros((2, 3), ctx=CPU) for _ in range(2)]
    kv.pushpull(3, [a, a], out=outs)
    assert all((o.asnumpy() == 2.0).all() for o in outs)
    for name in ("dist_sync", "nccl"):
        with pytest.raises(MXNetError, match="queue A item 7"):
            mt.kvstore.create(name)
    # split_and_load / clip_global_norm against the JAX package
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    js = mx.gluon.utils.split_and_load(mx.nd.array(x), [mx.cpu()] * 3)
    ts = mt.gluon.utils.split_and_load(mt.nd.array(x, ctx=CPU), [CPU] * 3)
    for p, q in zip(js, ts):
        np.testing.assert_array_equal(q.asnumpy(), p.asnumpy())
    ja, ta = [mx.nd.array(x), mx.nd.array(-x)], [mt.nd.array(x, ctx=CPU),
                                                 mt.nd.array(-x, ctx=CPU)]
    jn = mx.gluon.utils.clip_global_norm(ja, 10.0)
    tn = mt.gluon.utils.clip_global_norm(ta, 10.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for p, q in zip(ja, ta):
        np.testing.assert_allclose(q.asnumpy(), p.asnumpy(), rtol=1e-6)


def _bf16(a):
    return torch.from_numpy(a.astype(ml_dtypes.bfloat16).view(np.int16)
                            ).view(torch.bfloat16)


def test_bf16_eager_update_is_the_spmd_update():
    """The port's gluon.Trainer update on bf16 weights equals its
    SPMDTrainer update bit for bit; the JAX package's eager update, whose
    lr is a weak Python float, keeps lr·g in bf16 and differs by a
    rounding on some elements."""
    rs = np.random.RandomState(2)
    w, g, m = (rs.randn(4096) * s for s in (0.5, 2.0, 0.01))
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
    tw, tm = (mt.nd.NDArray(_bf16(a)) for a in (w, m))
    mt.optimizer.SGD(rescale_grad=1 / 32, **kw).update(
        0, tw, mt.nd.NDArray(_bf16(g)), tm)
    fo = tpar.functional_optimizer(mt.optimizer.SGD(**kw))
    nw, (nm,) = fo.apply(_bf16(w), _bf16(g) * (1 / 32), (_bf16(m),), 0.1, 1)
    assert torch.equal(tw.data, nw.to(torch.bfloat16))
    assert torch.equal(tm.data, nm.to(torch.bfloat16))
    jw, jm = (mx.nd.array(a.astype(ml_dtypes.bfloat16)) for a in (w, m))
    mx.optimizer.SGD(rescale_grad=1 / 32, **kw).update(
        0, jw, mx.nd.array(g.astype(ml_dtypes.bfloat16)), jm)
    same = (jm.asnumpy().view(np.uint16) == tm.asnumpy().view(np.uint16))
    assert 0.5 < same.mean() < 1.0  # one rounding apart on some elements
    jm32 = jm.asnumpy().astype(np.float32)
    np.testing.assert_allclose(tm.asnumpy().astype(np.float32), jm32,
                               rtol=0, atol=2 ** -7 * np.abs(jm32).max())


def test_nag_multi_precision_runs_nag_on_the_master_copy():
    rs = np.random.RandomState(4)
    w, g = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    kw = dict(learning_rate=0.1, momentum=0.9, multi_precision=True)
    out = {}
    for pkg, name in ((mx, "jax"), (mt, "port")):
        for opt in ("sgd", "nag"):
            o = pkg.optimizer.create(opt, **kw)
            if pkg is mx:
                wt, gt = (mx.nd.array(a.astype(ml_dtypes.bfloat16))
                          for a in (w, g))
            else:
                wt, gt = mt.nd.NDArray(_bf16(w)), mt.nd.NDArray(_bf16(g))
            st = o.create_state_multi_precision(0, wt)
            for _ in range(2):
                o.update_multi_precision(0, wt, gt, st)
            out[name, opt] = st[-1].asnumpy()
    # the JAX package's NAG takes SGD's momentum update on the master copy
    np.testing.assert_array_equal(out["jax", "nag"], out["jax", "sgd"])
    # (XLA contracts 0.9·mom − lr·g into an FMA: one fp32 ulp apart)
    np.testing.assert_allclose(out["port", "sgd"], out["jax", "sgd"],
                               rtol=1e-6)
    assert np.abs(out["port", "nag"] - out["port", "sgd"]).max() > 1e-3


def test_unported_options_raise():
    net = tnn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    ps = net.collect_params()
    for kw, what in [({"spmd": True}, "item 7"),
                     ({"compression_params": {"type": "2bit"}}, "item 7"),
                     ({"update_on_kvstore": True}, "item 7"),
                     ({"kvstore": "dist_sync"}, "item 7")]:
        with pytest.raises(MXNetError, match=what):
            tr = mt.gluon.Trainer(ps, "sgd", **kw)
            tr.step(1)
    # rmsprop, queued before, takes one step as the JAX Trainer does
    jnet = jnn.Dense(2, in_units=3)
    jnet.initialize(ctx=mx.cpu())
    x = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(ps[k].data().asnumpy()))
    for pkg, n, arr in ((mt, net, mt.nd.array(x, ctx=CPU)),
                        (mx, jnet, mx.nd.array(x))):
        tr = pkg.gluon.Trainer(n.collect_params(), "rmsprop",
                               {"learning_rate": 0.01, "centered": True})
        with pkg.autograd.record():
            loss = (n(arr) ** 2).sum()
        loss.backward()
        tr.step(4)
    assert isinstance(tr.optimizer, mx.optimizer.optimizer.RMSProp)
    np.testing.assert_allclose(net.weight.data().asnumpy(),
                               jnet.weight.data().asnumpy(), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(MXNetError, match="queue A item 7"):
        net.initialize(ctx=[CPU, CPU])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the machine has a CUDA device")
def test_entry_points_raise_without_cuda_unless_given_the_cpu():
    from mxnet_tpu_torch.examples import mnist

    with pytest.raises(MXNetError, match="CUDA"):
        tnn.Dense(2, in_units=3).initialize()
    with pytest.raises(MXNetError, match="CUDA"):
        tnn.Dense(2, in_units=3).collect_params().initialize()
    with pytest.raises(MXNetError, match="CUDA"):
        mt.random.generator()
    with pytest.raises(MXNetError, match="CUDA"):
        mnist.run(epochs=1)
    net = tnn.Dense(2, in_units=3)
    net.collect_params().initialize(ctx=CPU)
    assert net.collect_params()["weight"].list_ctx() == [CPU]


# ---------------------------------------------------------------------------
# the narrow ResNet through gluon.Trainer, fused forward and backward
# ---------------------------------------------------------------------------

RB, RSIZE, RSTEPS = 16, 32, 2
ROPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}


def _rnet(pkg):
    return pkg.ResNetV1(pkg.BottleneckV1, [1, 1, 1, 1], [8, 32, 64, 128, 256],
                        classes=10, layout="NHWC")


def _rdata():
    x = np.random.RandomState(7).rand(RB, RSIZE, RSIZE, 3).astype(np.float32)
    return x, (np.arange(RB) % 10).astype(np.int32)


@pytest.fixture(scope="module")
def rvals():
    """The JAX net's Xavier weights by structural name, the running
    means warm (each layer's batch mean), as test_torch_resnet_train."""
    x, _ = _rdata()
    np.random.seed(0)
    mx.random.seed(0)
    net = _rnet(jres)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(x))
    vals = {k: p.data().asnumpy().copy()
            for k, p in net._collect_params_with_prefix().items()}
    warm = _rnet(tres)
    warm.initialize(ctx=CPU)
    load_numpy_params(warm, vals)
    warm.double()
    with torch.no_grad(), ActiveTrace(train=True):
        warm(torch.from_numpy(x).double())
    for k, v in warm.state_dict(keep_vars=True).items():
        if k.endswith("running_mean"):
            vals[k] = (v.numpy() / 0.1).astype(np.float32)
    return vals


def _fused(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", "1")


def _jax_gluon_resnet(vals, tmp_path):
    x, y = _rdata()
    net = _rnet(jres)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(x))
    named = net._collect_params_with_prefix()
    for k, p in named.items():
        p.set_data(mx.nd.array(vals[k]))
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(ROPT))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(RSTEPS):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        tr.step(RB)
        losses.append(float(loss.mean().asscalar()))
    name_of = {id(p): k for k, p in named.items()}
    states, _ = _states(tr, tmp_path, "jax_resnet")
    mom = {name_of[id(tr._params[i])]: s for i, s in states.items()
           if s is not None}
    return losses, {k: p.data().asnumpy() for k, p in named.items()}, mom


def _port_gluon_resnet(vals, tmp_path, steps=RSTEPS):
    x, y = _rdata()
    net = _rnet(tres)
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    net.hybridize()
    params = net.collect_params()
    tr = mt.gluon.Trainer(params, "sgd", dict(ROPT))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    tfc.reset_launch_count()
    tfc.reset_bwd_launch_count()
    for _ in range(steps):
        with mt.autograd.record():
            loss = loss_fn(net(mt.nd.array(x, ctx=CPU)),
                           mt.nd.array(y, ctx=CPU))
        loss.backward()
        tr.step(RB)
        losses.append(float(loss.mean().asscalar()))
    assert tfc.launch_count() == tfc.bwd_launch_count() == 0  # CPU
    states, _ = _states(tr, tmp_path, "port_resnet")
    mom = {tr._params[i].name: s for i, s in states.items()
           if s is not None}
    return losses, {k: p.data().asnumpy() for k, p in params.items()}, mom


def test_resnet_gluon_trainer_matches_jax_and_spmd_trainer(
        rvals, monkeypatch, tmp_path):
    _fused(monkeypatch)
    calls = []
    real = tfc.fused_conv_unit_bwd
    monkeypatch.setattr(tfc, "fused_conv_unit_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tl, tw, tm = _port_gluon_resnet(rvals, tmp_path)
    assert len(calls) == RSTEPS * 10  # the stride-1 units' fused backward
    jl, jw, jm = _jax_gluon_resnet(rvals, tmp_path)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert set(tw) == set(jw) and set(tm) == set(jm)
    for k in jw:
        np.testing.assert_allclose(
            tw[k], jw[k], rtol=1e-4,
            atol=1e-4 * float(np.abs(jw[k]).max()) + 1e-6, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(
            tm[k], jm[k], rtol=1e-4,
            atol=5e-3 * float(np.abs(jm[k]).max()) + 1e-7,
            err_msg=f"momentum {k}")
    # the port's SPMDTrainer from the same start: the same ops on a loss
    # that differs by the power of two 1/16
    x, y = _rdata()
    net = _rnet(tres)
    net.initialize(ctx=CPU)
    load_numpy_params(net, rvals)
    sp = tpar.SPMDTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                          dict(ROPT), mesh=tpar.make_mesh(dp=1,
                                                          devices=[CPU]))
    sl = [float(sp.step(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(RSTEPS)]
    np.testing.assert_allclose(tl, sl, rtol=1e-6)
    for k, v in net.state_dict(keep_vars=True).items():
        np.testing.assert_allclose(tw[k], v.detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for k, s in sp.opt_state.items():
        np.testing.assert_allclose(tm[k], s[0].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=f"momentum {k}")


@pytest.mark.parametrize("hybridize", [False, True])
def test_forward_outside_record_keeps_the_running_statistics(
        rvals, monkeypatch, hybridize):
    """Inference outside record(), in both packages; the port's fused
    units run only when the net is hybridized (the trace scope), as in
    the JAX package."""
    _fused(monkeypatch)
    calls = []
    real = mt.ops.fused_conv_unit
    monkeypatch.setattr(mt.ops, "fused_conv_unit",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, _ = _rdata()
    jnet = _rnet(jres)
    jnet.initialize(ctx=mx.cpu())
    jnet(mx.nd.array(x))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(rvals[k]))
    tnet = _rnet(tres)
    tnet.initialize(ctx=CPU)
    load_numpy_params(tnet, rvals)
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    jo = jnet(mx.nd.array(x))
    to = tnet(mt.nd.array(x, ctx=CPU))
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(jo.asnumpy()).max())
    for k, p in tnet.collect_params().items():
        if "running" in k:
            np.testing.assert_array_equal(p.data().asnumpy(), rvals[k])
    for k, p in jnet._collect_params_with_prefix().items():
        if "running" in k:
            np.testing.assert_array_equal(p.data().asnumpy(), rvals[k])
    assert not to._data.requires_grad  # no graph outside record()
    assert len(calls) == (16 if hybridize else 0)


def test_mnist_example_reaches_90_percent_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.mnist", "--cpu",
         "--epochs", "1", "--batch-size", "50"], capture_output=True,
        text=True, timeout=300, cwd=REPO, env=env)
    lines = out.stdout.strip().splitlines()
    last = lines[-1] if lines else ""
    why = (f"rc {out.returncode}; last stdout line {last!r}; stderr "
           f"tail:\n{out.stderr[-2000:]}")
    assert out.returncode == 0, why
    assert last.startswith("[val] accuracy="), why
    assert float(last.split("=")[1]) > 0.9, why
    assert "jax" not in out.stderr, why


def test_mnist_example_is_the_same_whatever_ran_before():
    """The example seeds its shuffle and the port's generators, so its
    result does not hang on numpy's global state: a fresh process draws
    that from the OS, and at lr 0.1 / momentum 0.9 / batch 50 about one
    shuffle in ten sends the unseeded run into a loss spike it does not
    recover from (numpy seed 9 after a fresh process's generator seed 0:
    val accuracy 0.106).  Runs after two different global states (numpy's
    and the port's generator's) must give the same accuracy, above the
    bound of the test above."""
    from mxnet_tpu_torch.examples import mnist

    np_state = np.random.get_state()
    gen = mt.random.generator(CPU)
    gen_state = gen.get_state()
    try:
        accs = []
        for s in (9, 123):
            np.random.seed(s)
            gen.manual_seed(0)
            torch.rand(s, generator=gen)
            accs.append(mnist.run(epochs=1, ctx=CPU, batch_size=50))
    finally:
        np.random.set_state(np_state)
        gen.set_state(gen_state)
    assert accs[0] == accs[1], accs
    assert accs[0] > 0.9, accs
