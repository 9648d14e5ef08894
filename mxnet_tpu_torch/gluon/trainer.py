"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``): applies
an Optimizer to a ParameterDict, one parameter at a time.

``step(batch_size)`` = ``allreduce_grads()`` + ``update()``, with
``rescale_grad = scale / batch_size``: ``loss.backward()`` on the
per-sample loss sums the gradient over the batch (a head gradient of
ones), and the update op rescales it.  Each trainable parameter goes
through the update op (``sgd_mom_update``, ...) — the ops
``parallel.SPMDTrainer`` runs — written back in place under
``torch.no_grad``.

The update is fused by default, as in the JAX package
(``_fuse_resolved``): ``optimizer.FusedUpdater.update_all`` runs every
parameter's update as one CUDA graph per signature on the card (eagerly,
through the same cache, on the CPU), with the eager loop's bits; the
per-parameter ``Updater`` loop runs under ``fuse_step=False``, for an
optimizer without a fused path, and where ``FusedUnsupported`` says the
fused step cannot be exact.

Each parameter lives on one device, so the KVStore ('local'/'device')
has no replicas to sum and ``allreduce_grads`` moves nothing; a
distributed store raises.  Not ported, and refused rather than ignored:
several contexts per parameter, gradient compression, the kvstore-side
update and the SPMD mesh step (``spmd=True``, the JAX package's ZeRO-1
``SpmdUpdater``) (ROADMAP queue A item 7).  The chaos, goodput and
tracing hooks are item 10.
"""
from __future__ import annotations

import pickle
import warnings
from typing import Dict, List

from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict, _unique

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, fuse_step=None, spmd=None):
        if spmd:
            raise MXNetError("Trainer(spmd=True): the SPMD mesh step is "
                             "ROADMAP queue A item 7; data parallel "
                             "training is parallel.SPMDTrainer")
        if compression_params:
            raise MXNetError("gradient compression is ROADMAP queue A "
                             "item 7")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore=True: the kvstore-side "
                             "update is ROADMAP queue A item 7")
        if isinstance(params, ParameterDict):
            params = list(params.values())
        elif isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/dict/list")
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
        # a tied parameter is updated once, under its first name
        self._params: List[Parameter] = _unique(params)
        self._param2idx: Dict[str, int] = {
            p.name: i for i, p in enumerate(self._params)}
        optimizer_params = optimizer_params or {}
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_kind = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._states_to_load = None
        # None = auto: fuse when the optimizer has a fused path
        self._fuse_step = fuse_step
        self._fuse_active = None
        self._fuse_update_ok = True

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)
        # FusedUpdater extends Updater (the same states, the same saved
        # payload); its per-parameter __call__ is the eager loop
        self._updater = opt_mod.FusedUpdater(self._optimizer)

    def _fuse_resolved(self) -> bool:
        """Whether the fused update is engaged (decided once).  An
        explicit ``fuse_step=True`` with an optimizer that has no fused
        path falls back with one warning: the fused update changes
        nothing but speed."""
        if self._fuse_active is None:
            allowed = self._optimizer.fused_static_key() is not None
            if self._fuse_step and not allowed:
                warnings.warn(
                    "Trainer(fuse_step=True) needs an optimizer with a "
                    "fused path; falling back to the eager per-parameter "
                    "loop.", UserWarning, stacklevel=3)
            self._fuse_active = allowed and self._fuse_step is not False
        return self._fuse_active

    def _init_kvstore(self):
        kind = self._kvstore_kind
        if kind is None or kind is False:
            self._kvstore = None
        else:
            self._kvstore = kind if isinstance(kind, kvs_mod.KVStore) \
                else kvs_mod.create(kind if isinstance(kind, str)
                                    else "device")
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.init(i, p.data())
        self._kv_initialized = True
        if self._states_to_load is not None:
            fname, self._states_to_load = self._states_to_load, None
            self.load_states(fname)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size: int, ignore_stale_grad: bool = False):
        """Rescale by 1/batch_size, reduce the gradients, update."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One context per parameter and a local store: there is no
        replica to sum (the JAX trainer pushes and pulls only with
        several contexts or a distributed store)."""

    def update(self, batch_size: int, ignore_stale_grad: bool = False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad: bool = False):
        if self._fuse_resolved() and self._fuse_update_ok \
                and self._update_fused():
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            self._updater(i, p.grad(), p.data())

    def _update_fused(self) -> bool:
        """One captured update over every trainable parameter; False
        (the caller runs the eager loop) when the parameters live on
        several devices or the fused step cannot be exact."""
        idxs = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not idxs:
            return True
        plist = [self._params[i] for i in idxs]
        if len({p.list_ctx()[0] for p in plist}) != 1:
            return False
        try:
            self._updater.update_all(idxs, [p.grad() for p in plist],
                                     [p.data() for p in plist])
        except opt_mod.FusedUnsupported:
            # fixed for the run (optimizer class, weight dtypes): latch
            self._fuse_update_ok = False
            return False
        return True

    def optimizer_state_bytes(self):
        """(state_bytes, shard_factor): the bytes of the optimizer states
        (fp32 master copies included) one device holds, and 1, as on the
        JAX package's per-replica paths (one context per parameter)."""
        def tree_bytes(s):
            if s is None:
                return 0
            if isinstance(s, (tuple, list)):
                return sum(tree_bytes(x) for x in s)
            return s._data.numel() * s._data.element_size()

        return sum(tree_bytes(s) for s in self._updater.states.values()), 1

    def save_states(self, fname: str):
        """The optimizer states, pickled as numpy arrays by parameter
        index (the JAX package's single-replica format)."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname: str):
        """Restore the optimizer states (a file written by either
        package's ``save_states``), on the parameters' device."""
        if not self._kv_initialized:
            self._states_to_load = fname
            return
        with open(fname, "rb") as f:
            data = f.read()
        obj = pickle.loads(data)
        if isinstance(obj, dict) and "__mx_replica_states__" in obj:
            raise MXNetError(f"{fname} holds the states of several "
                             "replicas; one context per parameter in the "
                             "port (ROADMAP queue A item 7)")
        ctxs = [p.list_ctx()[0] for p in self._params
                if p.grad_req != "null"]
        self._updater.set_states(data, ctx=ctxs[0] if ctxs else None)
