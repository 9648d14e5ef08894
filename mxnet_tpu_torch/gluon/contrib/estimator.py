"""Estimator: the fit loop of Gluon contrib (counterpart of
``mxnet_tpu/gluon/contrib/estimator.py``, ref:
python/mxnet/gluon/contrib/estimator/estimator.py).

``fit`` drives MXNet's own loop per batch — the net under
``autograd.record()``, the loss, ``backward()`` and ``trainer.step`` —
and fires the event handlers; ``evaluate`` runs the validation metrics.
A hybridized net runs its forward and backward through its captured
CachedOp on the card.  The context defaults to gpu(0) (raising without
CUDA unless a context is given); batches move to it by
``split_and_load``, one context per batch (several raise, as everywhere
in the port).
"""
from __future__ import annotations

import os
import time

from ... import autograd
from ... import metric as metric_mod
from ...context import as_context, resolve
from ..trainer import Trainer
from ..utils import split_and_load

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "CheckpointHandler", "LoggingHandler"]


class TrainBegin:
    def train_begin(self, estimator):
        pass


class TrainEnd:
    def train_end(self, estimator):
        pass


class EpochBegin:
    def epoch_begin(self, estimator):
        pass


class EpochEnd:
    def epoch_end(self, estimator):
        pass


class BatchBegin:
    def batch_begin(self, estimator):
        pass


class BatchEnd:
    def batch_end(self, estimator):
        pass


class LoggingHandler(TrainBegin, EpochEnd, BatchEnd):
    """Prints the training metrics every ``log_interval`` batches and at
    each epoch's end."""

    def __init__(self, log_interval=50):
        self.log_interval = log_interval
        self._batch = 0
        self._tic = None

    def train_begin(self, estimator):
        self._tic = time.time()

    def _metrics(self, estimator):
        return [f"{n}={v:.4f}" for n, v in
                (m.get() for m in estimator.train_metrics)]

    def batch_end(self, estimator):
        self._batch += 1
        if self._batch % self.log_interval == 0:
            print(" ".join([f"[batch {self._batch}]"]
                           + self._metrics(estimator)))

    def epoch_end(self, estimator):
        elapsed = time.time() - self._tic
        print(" ".join([f"[epoch {estimator.current_epoch}] "
                        f"time={elapsed:.1f}s"] + self._metrics(estimator)))
        self._tic = time.time()


class CheckpointHandler(EpochEnd):
    """Saves the net's parameters to
    ``model_dir/model_prefix-epoch<N>.params`` at each epoch's end."""

    def __init__(self, model_dir, model_prefix="model", save_best=False,
                 monitor=None):
        self.model_dir = model_dir
        self.model_prefix = model_prefix

    def epoch_end(self, estimator):
        os.makedirs(self.model_dir, exist_ok=True)
        estimator.net.save_parameters(os.path.join(
            self.model_dir,
            f"{self.model_prefix}-epoch{estimator.current_epoch}.params"))


class Estimator:
    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None, val_metrics=None):
        self.net = net
        self.loss = loss
        self.train_metrics = [metric_mod.create(m) for m in
                              (train_metrics or ["accuracy"])]
        self.val_metrics = [metric_mod.create(m) for m in
                            (val_metrics or ["accuracy"])]
        self.context = [as_context(resolve(context))]
        self.trainer = trainer or Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.01})
        self.current_epoch = 0
        self.batch_size = 0

    def _load(self, batch):
        return (split_and_load(batch[0], self.context),
                split_and_load(batch[1], self.context))

    def evaluate(self, val_data):
        """The validation metrics over ``val_data``: [(name, value)]."""
        for m in self.val_metrics:
            m.reset()
        for batch in val_data:
            for x, y in zip(*self._load(batch)):
                out = self.net(x)
                for m in self.val_metrics:
                    m.update([y], [out])
        return [m.get() for m in self.val_metrics]

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batch_size=None):
        handlers = event_handlers or [LoggingHandler()]

        def fire(kind):
            for h in handlers:
                fn = getattr(h, kind, None)
                if fn is not None:
                    fn(self)

        fire("train_begin")
        for epoch in range(epochs):
            self.current_epoch = epoch
            for m in self.train_metrics:
                m.reset()
            fire("epoch_begin")
            for batch in train_data:
                bs = self.batch_size = batch_size or batch[0].shape[0]
                fire("batch_begin")
                xs, ys = self._load(batch)
                losses, outs = [], []
                with autograd.record():
                    for x, y in zip(xs, ys):
                        out = self.net(x)
                        losses.append(self.loss(out, y))
                        outs.append(out)
                for loss in losses:
                    loss.backward()
                self.trainer.step(bs)
                for y, out in zip(ys, outs):
                    for m in self.train_metrics:
                        m.update([y], [out])
                fire("batch_end")
            if val_data is not None:
                self.evaluate(val_data)
            fire("epoch_end")
        fire("train_end")
        return self
