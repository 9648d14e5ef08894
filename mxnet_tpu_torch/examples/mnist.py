"""MNIST MLP — the canonical minimum end-to-end workload, through MXNet's
imperative surface on the port (counterpart of examples/gluon/mnist.py,
line for line in the port's names: the reference network, whose layers
take their input widths from the first batch).

Usage:  python -m mxnet_tpu_torch.examples.mnist [--cpu] [--epochs N]
            [--batch-size B] [--no-hybridize] [--estimator]

It trains on gpu(0) and raises without a CUDA device unless --cpu is
given; --estimator trains through gluon.contrib.estimator.Estimator.fit
instead of the explicit loop.  A run seeds the shuffle (the sampler
draws from numpy's global generator, as in the JAX package) and the
port's generators with 0, so it is the same whatever ran before it in
its process.
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.contrib import estimator as estimator_mod


def build_net():
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"),
            nn.Dense(64, activation="relu"),
            nn.Dense(10))
    return net


def transformer(img, label):
    return img.astype("float32").reshape((-1,)) / 255.0, label


def run(epochs=5, ctx=None, hybridize=True, batch_size=100, lr=0.1,
        keep=None, estimator=False):
    """Train and validate; returns the val accuracy.  ``keep``, a dict,
    receives the net, the trainer, the steps and the last epoch's
    samples/s."""
    np.random.seed(0)
    mx.random.seed(0)
    ctx = ctx or mx.current_context()
    train_data = gluon.data.DataLoader(
        gluon.data.vision.MNIST(train=True).transform(transformer),
        batch_size=batch_size, shuffle=True, last_batch="discard")
    val_data = gluon.data.DataLoader(
        gluon.data.vision.MNIST(train=False).transform(transformer),
        batch_size=batch_size, shuffle=False)

    net = build_net()
    net.initialize(mx.initializer.Xavier(magnitude=2.24), ctx=ctx)
    if hybridize:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    if estimator:
        acc, rate, n = _fit_estimator(net, loss_fn, trainer, ctx,
                                      train_data, val_data, epochs)
    else:
        acc, rate, n = _fit_loop(net, loss_fn, trainer, ctx, train_data,
                                 val_data, epochs)
    if keep is not None:
        keep.update(net=net, trainer=trainer, samples_per_s=rate, steps=n
                    // batch_size)
    return acc


def _fit_loop(net, loss_fn, trainer, ctx, train_data, val_data, epochs):
    metric = mx.metric.Accuracy()
    rate = n = 0
    for epoch in range(epochs):
        metric.reset()
        tic = time.time()
        n = 0
        for data, label in train_data:
            data = data.as_in_context(ctx)
            label = label.as_in_context(ctx)
            with autograd.record():
                output = net(data)
                loss = loss_fn(output, label)
            loss.backward()
            trainer.step(data.shape[0])
            metric.update([label], [output])
            n += data.shape[0]
        name, acc = metric.get()
        rate = n / (time.time() - tic)
        print(f"[epoch {epoch}] {name}={acc:.4f} ({rate:.0f} samples/s)")

    metric.reset()
    for data, label in val_data:
        output = net(data.as_in_context(ctx))
        metric.update([label.as_in_context(ctx)], [output])
    name, acc = metric.get()
    print(f"[val] {name}={acc:.4f}")
    return acc, rate, n


class _Throughput(estimator_mod.EpochBegin, estimator_mod.BatchEnd,
                  estimator_mod.EpochEnd):
    """Samples per second of each epoch, printed at its end."""

    def epoch_begin(self, est):
        self.n, self.tic = 0, time.time()

    def batch_end(self, est):
        self.n += est.batch_size

    def epoch_end(self, est):
        self.rate = self.n / (time.time() - self.tic)
        name, acc = est.train_metrics[0].get()
        print(f"[epoch {est.current_epoch}] {name}={acc:.4f} "
              f"({self.rate:.0f} samples/s)")


def _fit_estimator(net, loss_fn, trainer, ctx, train_data, val_data,
                   epochs):
    est = estimator_mod.Estimator(net, loss_fn, trainer=trainer,
                                  context=ctx)
    speed = _Throughput()
    est.fit(train_data, epochs=epochs, event_handlers=[speed])
    (name, acc), = est.evaluate(val_data)
    print(f"[val] {name}={acc:.4f}")
    return acc, speed.rate, speed.n


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--no-hybridize", action="store_true")
    p.add_argument("--estimator", action="store_true")
    args = p.parse_args()
    acc = run(args.epochs, mx.cpu() if args.cpu else None,
              not args.no_hybridize, args.batch_size, args.lr,
              estimator=args.estimator)
    assert acc > 0.9, f"val accuracy too low: {acc}"
