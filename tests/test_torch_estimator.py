"""gluon.contrib.estimator of mxnet_tpu_torch against the JAX package's,
on the CPU.

* The reference MNIST network of examples/gluon/mnist.py (784-128-64-10,
  no in_units: deferred shapes) from the JAX net's Xavier weights,
  carried across by structural name into the port's deferred
  placeholders, trained by ``Estimator.fit`` over the same 12 batches of
  50 synthetic images in order, two epochs (sgd lr 0.1 momentum 0.9),
  hybridized, then ``evaluate`` on 4 other batches: the weights within
  3e-5 of each tensor's largest magnitude (fp32; as
  tests/test_torch_gluon_trainer.py's MNIST loop), the training and
  validation accuracies equal, the handlers fired in the JAX order, and
  the CheckpointHandler's file loads into the JAX net.
* The example's ``--estimator`` path trains the reference network to val
  accuracy > 0.9 on the CPU, its three layers resolved to (128, 784),
  (64, 128), (10, 64).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.contrib import estimator as jest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.contrib import estimator as test_

CPU = mt.cpu()
B, TRAIN, VAL, EPOCHS = 50, 12, 4, 2
OPT = {"learning_rate": 0.1, "momentum": 0.9}


def _net(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"), nn.Dense(64,
                                                       activation="relu"),
            nn.Dense(10))
    return net


def _batches():
    ds = mt.gluon.data.vision.MNIST(train=True)
    x = ds._data[:B * (TRAIN + VAL)].reshape(-1, 784).astype(
        np.float32) / 255.0
    y = ds._label[:B * (TRAIN + VAL)].astype(np.float32)
    return [(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
            for i in range(TRAIN + VAL)]


class _Events:
    def __init__(self, mod, log):
        self.log = log

    def train_begin(self, est):
        self.log.append("train_begin")

    def epoch_begin(self, est):
        self.log.append(f"epoch_begin {est.current_epoch}")

    def batch_end(self, est):
        self.log.append("batch_end")

    def epoch_end(self, est):
        self.log.append(f"epoch_end {est.current_epoch}")

    def train_end(self, est):
        self.log.append("train_end")


def _fit(pkg, ctx, net, batches, tmp_path, tag):
    data = [(pkg.nd.array(x, **ctx), pkg.nd.array(y, **ctx))
            for x, y in batches]
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    est_mod = jest if pkg is mx else test_
    est = est_mod.Estimator(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                            trainer=trainer,
                            context=ctx.get("ctx", mx.cpu()))
    log = []
    ckpt = est_mod.CheckpointHandler(str(tmp_path / tag), "mnist")
    est.fit(data[:TRAIN], epochs=EPOCHS,
            event_handlers=[_Events(est_mod, log), ckpt,
                            est_mod.LoggingHandler(log_interval=5)])
    train_acc = est.train_metrics[0].get()
    val = est.evaluate(data[TRAIN:])
    return est, log, train_acc, val


def test_estimator_fit_and_evaluate_match_the_jax_estimator(tmp_path,
                                                            capsys):
    batches = _batches()
    jnet = _net(jnn)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jnet(mx.nd.array(batches[0][0]))
    named = jnet._collect_params_with_prefix()
    vals = {k: p.data().asnumpy() for k, p in named.items()}
    jnet.hybridize()
    tnet = _net(tnn)
    tnet.initialize(ctx=CPU)
    load_numpy_params(tnet, vals)  # into the deferred placeholders
    tnet.hybridize()
    j = _fit(mx, {}, jnet, batches, tmp_path, "jax")
    t = _fit(mt, {"ctx": CPU}, tnet, batches, tmp_path, "port")
    assert t[1] == j[1]
    assert t[1][:2] == ["train_begin", "epoch_begin 0"] and \
        t[1].count("batch_end") == EPOCHS * TRAIN
    assert t[2][0] == j[2][0] and abs(t[2][1] - j[2][1]) < 1e-12
    assert [n for n, _ in t[3]] == [n for n, _ in j[3]]
    np.testing.assert_allclose([v for _, v in t[3]], [v for _, v in j[3]],
                               rtol=0, atol=1e-12)
    tw = {k: p.data().asnumpy() for k, p in tnet.collect_params().items()}
    for k, p in named.items():
        w = p.data().asnumpy()
        np.testing.assert_allclose(tw[k], w, rtol=0,
                                   atol=3e-5 * np.abs(w).max(), err_msg=k)
    out = capsys.readouterr().out
    assert "[epoch 1]" in out and "[batch 10]" in out
    # the port's checkpoint of the last epoch loads into the JAX net
    f = tmp_path / "port" / f"mnist-epoch{EPOCHS - 1}.params"
    check = _net(jnn)
    check.initialize(ctx=mx.cpu())
    check.load_parameters(str(f))
    for k, p in check._collect_params_with_prefix().items():
        np.testing.assert_array_equal(p.data().asnumpy(), tw[k])


def test_estimator_defaults_and_context():
    net = _net(tnn)
    net.initialize(ctx=CPU)
    est = test_.Estimator(net, mt.gluon.loss.L2Loss(), context=CPU)
    assert [m.name for m in est.train_metrics] == ["accuracy"]
    assert est.trainer.learning_rate == 0.01
    assert est.context == [CPU]


def test_mnist_example_trains_through_the_estimator():
    from mxnet_tpu_torch.examples import mnist

    keep = {}
    acc = mnist.run(epochs=1, ctx=CPU, batch_size=50, keep=keep,
                    estimator=True)
    assert acc > 0.9
    shapes = [tuple(p.shape) for k, p in
              keep["net"].collect_params().items() if k.endswith("weight")]
    assert shapes == [(128, 784), (64, 128), (10, 64)]
    n = len(mt.gluon.data.vision.MNIST(train=True))
    assert keep["steps"] == n // 50 and keep["samples_per_s"] > 0
