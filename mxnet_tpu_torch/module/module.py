"""Module: train a symbol (counterpart of ``mxnet_tpu/module/module.py``):
bind, init_params, init_optimizer, forward, backward, update,
get_outputs, get_input_grads, update_metric, reshape, checkpoints and
optimizer states.

On one context the executor's step is captured once per signature
(``symbol/executor.py``), and ``update()`` keeps it valid: the optimizer
writes each new weight into the executor's argument tensor in place
(``FusedUpdater.update_all``, itself one captured update per signature,
for an optimizer with a fused path; the per-parameter ``Updater``
otherwise), where the JAX package rebinds the arrays.  As in the JAX
package the gradients are the batch's sum (``rescale_grad`` stays 1
unless given) and ``Module()`` without a context runs on gpu(0) in the
port (the JAX package's default is cpu()): a CPU run passes
``context=cpu()``.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from .. import initializer as init_mod
from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from .. import random as _random
from ..base import MXNetError
from ..context import resolve
from ..io import DataDesc
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        self._context = [resolve(context)]
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)
        inputs = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params: Dict[str, NDArray] = {}
        self._aux_params: Dict[str, NDArray] = {}
        self._exec_group: Optional[DataParallelExecutorGroup] = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._data_shapes = None
        self._label_shapes = None
        self._preload_opt_states = None

    # ---- properties ------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return [(n, o.shape) for n, o in zip(self.output_names,
                                              self.get_outputs())]

    def _executor(self):
        return self._exec_group.execs[0]

    # ---- bind ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.binded = True
        data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                       for d in data_shapes]
        args = set(self._symbol.list_arguments())
        # only the labels the symbol takes
        label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                        for x in (label_shapes or [])]
        label_shapes = [x for x in label_shapes if x.name in args]
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, data_shapes, label_shapes,
            param_names=self._param_names, for_training=for_training,
            inputs_need_grad=inputs_need_grad,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            logger=self.logger)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # ---- parameters ------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Each parameter from ``arg_params``, else drawn by
        ``initializer`` (by its name; from a CPU generator seeded with
        the last ``mx.random.seed``); aux states from ``aux_params``, else
        ones for a variance and zeros otherwise."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing parameters"
        if initializer is None and not (arg_params or aux_params):
            initializer = init_mod.Uniform(0.01)
        ex = self._executor()
        gen = _random.host_generator()
        for name in self._param_names:
            arr = ex.arg_dict[name]
            if arg_params and name in arg_params:
                ex._assign(arr, arg_params[name])
            elif initializer is not None:
                buf = torch.zeros(arr.shape, dtype=torch.float32)
                initializer(init_mod.InitDesc(name), buf, gen)
                ex._assign(arr, buf.to(arr._data.dtype))
            elif not allow_missing:
                raise MXNetError(f"parameter '{name}' missing and no "
                                 f"initializer given")
            self._arg_params[name] = arr.copy()
        for name in self._aux_names:
            arr = ex.aux_dict[name]
            if aux_params and name in aux_params:
                ex._assign(arr, aux_params[name])
            else:
                with torch.no_grad():
                    arr._data.fill_(1.0 if name.endswith(
                        ("moving_var", "running_var")) else 0.0)
            self._aux_params[name] = arr.copy()
        self.params_initialized = True

    def init_params_from_loaded(self):
        """(Re)initialize from the parameters this Module holds (those of
        ``Module.load``), as the JAX Module does."""
        self.init_params(arg_params=dict(self._arg_params),
                         aux_params=dict(self._aux_params), force_init=True)

    def get_params(self):
        """Copies of the parameters and aux states."""
        assert self.params_initialized
        if self.binded:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        return dict(self._arg_params), dict(self._aux_params)

    # ---- optimizer -------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       **dict(optimizer_params or {}))
        self._optimizer = optimizer
        self._updater = opt_mod.FusedUpdater(optimizer) \
            if optimizer.fused_static_key() is not None \
            else opt_mod.get_updater(optimizer)
        if kvstore:
            kv = kvs_mod.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            self._kvstore = kv
            for i, name in enumerate(self._param_names):
                kv.init(i, self._arg_params[name])
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ---- execution -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter with a gradient, each
        new weight written into the executor's tensor in place."""
        assert self.optimizer_initialized
        ex = self._executor()
        idxs, grads, weights = [], [], []
        for i, name in enumerate(self._param_names):
            g = ex.grad_dict.get(name)
            if g is not None:
                idxs.append(i)
                grads.append(g)
                weights.append(ex.arg_dict[name])
        if isinstance(self._updater, opt_mod.FusedUpdater):
            try:
                self._updater.update_all(idxs, grads, weights)
                return
            except opt_mod.FusedUnsupported:
                pass
        for i, g, w in zip(idxs, grads, weights):
            self._updater(i, g, w)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        raise MXNetError("monitor.py and Module.install_monitor are not "
                         "ported (ROADMAP queue A item 9)")

    def reshape(self, data_shapes, label_shapes=None):
        """Bind again for new shapes, keeping the parameters."""
        assert self.binded
        self.get_params()
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  force_rebind=True)
        self._exec_group.set_params(self._arg_params, self._aux_params)

    # ---- checkpoints -----------------------------------------------------
    def save_checkpoint(self, prefix: str, epoch: int,
                        save_optimizer_states=False):
        from ..model import save_checkpoint as _save

        arg_params, aux_params = self.get_params()
        _save(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    def save_optimizer_states(self, fname: str):
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname: str):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), ctx=self._context[0])

    @staticmethod
    def load(prefix: str, epoch: int, load_optimizer_states=False,
             **kwargs):
        """A Module of a ``save_checkpoint``'s files; with
        ``load_optimizer_states`` its states load at ``init_optimizer``."""
        from ..model import load_checkpoint

        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod
