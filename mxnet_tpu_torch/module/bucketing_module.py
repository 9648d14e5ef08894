"""BucketingModule: sequences of several lengths through one executor
per bucket that share their parameters (counterpart of
``mxnet_tpu/module/bucketing_module.py``).

``sym_gen(bucket_key)`` gives each bucket its symbol.  The default
bucket's ``Module`` is bound first and owns the parameters; every other
bucket's ``Module`` is bound at its first batch with
``shared_module=`` that one, so its executor reads and writes the same
parameter, aux and gradient tensors (a parameter whose shape differs
between buckets raises).  Every bucket uses the default bucket's
optimizer, updater and parameter order, so the optimizer state is one
set and the fused update (``FusedUpdater.update_all``) sees the same
weights and gradients from every bucket: one captured update serves all
of them.  Each bucket's executor step is captured once per signature as
``Module``'s is, and since an update writes the shared tensors in
place, a bucket's replay reads what the last update of any bucket
wrote, where the JAX package copies the master parameters into a
bucket's executor at each switch.  ``save_checkpoint`` writes the
default bucket's symbol, as in the JAX package.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("please specify default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets: Dict[object, Module] = {}
        self._curr_module: Optional[Module] = None
        self._curr_bucket_key = None

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def _gen_module(self, bucket_key) -> Module:
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    # ---- bind / params ---------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training=for_training,
                    inputs_need_grad=inputs_need_grad, grad_req=grad_req)
        self._buckets = {self._default_bucket_key: module}
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self._grad_req = grad_req
        self._inputs_need_grad = inputs_need_grad

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` the current bucket, binding its module at
        its first use onto the default bucket's arrays."""
        assert self.binded, "call bind before switching buckets"
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._gen_module(bucket_key)
            if set(module._param_names) != set(default._param_names):
                raise MXNetError(
                    f"bucket {bucket_key!r} has parameters "
                    f"{sorted(module._param_names)}, the default bucket "
                    f"{sorted(default._param_names)}")
            module._param_names = default._param_names
            module.bind(data_shapes, label_shapes,
                        for_training=self.for_training,
                        inputs_need_grad=self._inputs_need_grad,
                        shared_module=default, grad_req=self._grad_req)
            module._arg_params = default._arg_params
            module._aux_params = default._aux_params
            module.params_initialized = self.params_initialized
            if self.optimizer_initialized:
                self._share_optimizer(module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def _share_optimizer(self, module):
        default = self._buckets[self._default_bucket_key]
        module._optimizer = default._optimizer
        module._updater = default._updater
        module._kvstore = default._kvstore
        module.optimizer_initialized = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def get_params(self):
        assert self.params_initialized
        return self._curr_module.get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore, optimizer, optimizer_params,
                               force_init=force_init)
        for mod in self._buckets.values():
            if mod is not default:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    # ---- execution -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        bucket_key = data_batch.bucket_key
        if bucket_key is None:
            bucket_key = self._curr_bucket_key
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol and the shared parameters."""
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
