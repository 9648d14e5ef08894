"""BaseModule: the symbolic training loop (counterpart of
``mxnet_tpu/module/base_module.py``): ``fit`` (per batch forward,
backward, update and the metric; per epoch the callbacks and the
validation score), ``score``, ``predict``, ``forward_backward``,
``set_params`` and ``save_params``/``load_params`` over the
subclass's bind/init_params/init_optimizer/forward/backward/update."""
from __future__ import annotations

import logging
import time
from typing import List

from .. import metric as metric_mod
from .. import ndarray as nd
from ..callback import BatchEndParam
from ..ndarray.ndarray import NDArray

__all__ = ["BaseModule"]


def _as_metric(eval_metric):
    if isinstance(eval_metric, metric_mod.EvalMetric):
        return eval_metric
    return metric_mod.create(eval_metric)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _check_input_names(symbol, names, typename, throw):
    args = set(symbol.list_arguments())
    for name in names:
        if name not in args:
            msg = (f"You created Module with Module(..., {typename}_names="
                   f"{names}) but input with name '{name}' is not found in "
                   f"symbol.list_arguments(). ")
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


class BaseModule:
    """Subclasses implement bind/init_params/init_optimizer/forward/
    backward/update/get_outputs/get_params/update_metric."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True) -> List[NDArray]:
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    # ---- conveniences ----------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run inference over ``eval_data`` and return the metric's
        (name, value) pairs."""
        assert self.binded and self.params_initialized
        eval_metric = _as_metric(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                  eval_metric=eval_metric, locals=locals())
            for cb in _as_list(batch_end_callback):
                cb(param)
        param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                              eval_metric=eval_metric, locals=locals())
        for cb in _as_list(score_end_callback):
            cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data``, each batch without its pad
        rows; merged along the batch axis by default."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            output_list.append([out[0:out.shape[0] - pad]
                                for out in self.get_outputs()])
        if not output_list or not merge_batches:
            return output_list
        merged = [nd.concatenate([o[i] for o in output_list], axis=0)
                  for i in range(len(output_list[0]))]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The train loop: bind, init_params (Uniform(0.01) by default),
        init_optimizer, then per batch forward_backward, update and the
        metric (between ``monitor.tic()`` and ``monitor.toc_print()``
        when a monitor is given), per epoch the callbacks and the
        validation score."""
        assert num_epoch is not None, "please specify number of epochs"
        from .. import initializer as init_mod

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p, allow_missing=False,
                            force_init=True)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def install_monitor(self, mon):
        raise NotImplementedError

    def save_params(self, fname: str):
        """The parameters as ``arg:``/``aux:`` entries of a ``.params``
        file."""
        from ..model import _host
        from ..serialization import save_ndarrays

        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": _host(v) for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": _host(v)
                          for k, v in aux_params.items()})
        save_ndarrays(fname, save_dict)

    def load_params(self, fname: str):
        from ..serialization import load_ndarrays

        arg_params, aux_params = {}, {}
        for k, v in load_ndarrays(fname).items():
            tag, name = k.split(":", 1)
            (arg_params if tag == "arg" else aux_params)[name] = NDArray(v)
        self.set_params(arg_params, aux_params)
