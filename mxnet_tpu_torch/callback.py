"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``):
``Speedometer`` (samples a second every few batches), ``ProgressBar``,
``do_checkpoint`` and ``module_checkpoint`` (epoch-end saves),
``log_train_metric``; ``Module.fit`` calls the batch-end ones with a
``BatchEndParam`` and the epoch-end ones with (epoch, symbol,
arg_params, aux_params)."""
from __future__ import annotations

import logging
import math
import sys
import time
from collections import namedtuple

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint",
           "module_checkpoint", "log_train_metric", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


class Speedometer:
    """Log the samples a second (and the metric, reset when
    ``auto_reset``) every ``frequent`` batches."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                         param.epoch, count, speed,
                         "\t".join(f"{n}={v:f}" for n, v in name_value))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """A text progress bar over ``total`` batches."""

    def __init__(self, total: int, length: int = 80):
        self.total = total
        self.bar_len = length

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        filled = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        bar = "=" * filled + "-" * (self.bar_len - filled)
        sys.stdout.write(f"[{bar}] {percents}%\r")


def do_checkpoint(prefix: str, period: int = 1):
    """An epoch-end callback that saves ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs."""
    from .model import save_checkpoint

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def module_checkpoint(mod, prefix: str, period: int = 1,
                      save_optimizer_states: bool = False):
    """An epoch-end callback that calls ``mod.save_checkpoint``."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def log_train_metric(period: int, auto_reset: bool = False):
    """A batch-end callback that logs the metric every ``period``
    batches."""

    def _callback(param: BatchEndParam):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback
