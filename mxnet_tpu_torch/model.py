"""Checkpoints and the legacy ``FeedForward`` trainer (counterpart of
``mxnet_tpu/model.py``).

``save_checkpoint`` writes the reference's two files, ``prefix-symbol.json``
(the graph, ``Symbol.tojson``) and ``prefix-%04d.params`` (the arrays
named ``arg:<name>`` and ``aux:<name>`` in the ``.params`` format), as
the JAX package does: either package loads the other's checkpoints.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from . import serialization
from .base import MXNetError
from .callback import BatchEndParam
from .ndarray.ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam", "FeedForward"]


def _host(v):
    return (v._data if isinstance(v, NDArray) else v).detach().cpu()


def save_checkpoint(prefix: str, epoch: int, symbol,
                    arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray], remove_amp_cast=True):
    """``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": _host(v) for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": _host(v)
                      for k, v in (aux_params or {}).items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    serialization.save_ndarrays(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_params(prefix: str, epoch: int):
    """(arg_params, aux_params) of ``prefix-%04d.params``, NDArrays on the
    CPU."""
    loaded = serialization.load_ndarrays(f"{prefix}-{epoch:04d}.params")
    if not isinstance(loaded, dict):
        raise MXNetError("checkpoint params file must be a named dict")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tag, name = k.split(":", 1)
        if tag == "arg":
            arg_params[name] = NDArray(v)
        elif tag == "aux":
            aux_params[name] = NDArray(v)
    return arg_params, aux_params


def load_checkpoint(prefix: str, epoch: int):
    """(symbol, arg_params, aux_params) of a checkpoint."""
    from . import symbol as sym

    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """The deprecated trainer, a thin adapter over ``Module`` (use
    ``Module`` or Gluon).  ``ctx`` defaults to gpu(0); a list of
    contexts slices each batch over them (``Module(context=[...])``)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, begin_epoch=0,
                 **kwargs):
        from . import initializer as init_mod

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.numpy_batch_size = numpy_batch_size
        self._kwargs = kwargs
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module

        data_iter = self._ensure_iter(X, y)
        label_names = [d.name for d in (data_iter.provide_label or [])] \
            or None
        mod = Module(self.symbol, context=self.ctx, label_names=label_names)
        mod.fit(data_iter, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self._kwargs.get("optimizer_params",
                                                  {"learning_rate": 0.01}),
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None):
        if self._module is None:
            raise MXNetError("model has not been fit")
        out = self._module.predict(self._ensure_iter(X, None),
                                   num_batch=num_batch)
        return out.asnumpy() if isinstance(out, NDArray) else out

    def _ensure_iter(self, X, y):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size)

    def save(self, prefix: str, epoch: Optional[int] = None):
        save_checkpoint(prefix, epoch if epoch is not None
                        else (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix: str, epoch: int, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)
