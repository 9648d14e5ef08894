"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py:54-654``):
applies an Optimizer to a ParameterDict, summing the gradients of the
replicas and ranks through a KVStore.

``step(batch_size)`` = ``allreduce_grads()`` + ``update()``, with
``rescale_grad = scale / batch_size``: ``loss.backward()`` on the
per-sample loss sums the gradient over the batch (a head gradient of
ones), and the update op rescales it.

* The store (``_init_kvstore``): ``kvstore`` names one ('device' by
  default; None for none).  ``update_on_kvstore`` defaults to True on a
  dist store and False otherwise: with it the store runs the update
  (``pushpull`` of the gradients into the weights), without it the
  gradients of several replicas, or of a dist job, are summed by
  ``pushpull_fused`` (one key at a time under compression or sparse
  gradients) and each replica updates its own copy.
  ``compression_params`` turns on the store's 2-bit compression.
* One updater per replica, as the JAX package keeps them; each takes
  the fused update (``optimizer.FusedUpdater.update_all``: one CUDA
  graph per signature on the card, the eager loop's bits) unless
  ``fuse_step=False``, the optimizer has no fused path,
  ``FusedUnsupported`` says it cannot be exact, or the store updates.
  The optimizer's update count is shared, so it moves once a replica
  (Adam's t differs between replicas, as in the JAX package).
* ``spmd=True`` (or ``MXNET_SPMD=1``) runs the step through
  ``optimizer.SpmdUpdater``: one update over every replica (and, on a
  dist store, every rank), the states of the large tensors split
  between them (ZeRO-1).  What it cannot take (sparse gradients, ragged
  replica layouts, an optimizer without a fused path) falls back to the
  per-replica path, the states handed over whole (``_spmd_disengage``).
* ``save_states``/``load_states``: one replica's states in the JAX
  package's single-replica format, several replicas' under
  ``__mx_replica_states__``; ``allow_resize`` loads a file of another
  replica count.  Either package's file loads in the other.

The chaos, goodput and tracing hooks of the JAX Trainer are ROADMAP
queue A item 10 (the chaos harness and span tracing they call are
``resilience.chaos`` and ``telemetry.tracing``; these sites are not
wired yet).
"""
from __future__ import annotations

import pickle
import warnings
from typing import Dict, List, Optional

from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..util import env as _env
from .parameter import Parameter, ParameterDict, _unique

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, fuse_step=None, spmd=None):
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
        self._compression_params = compression_params or None
        self._kvstore_kind = kvstore
        self._kvstore: Optional[kvs_mod.KVStore] = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False
        self._states_to_load = None
        # None = auto: fuse when the optimizer has a fused path and the
        # update is local (decided after the store is made)
        self._fuse_step = fuse_step
        self._fuse_active: Optional[bool] = None
        self._fuse_update_ok = True
        # None = follow MXNET_SPMD
        self._spmd_step = spmd
        self._spmd_active: Optional[bool] = None
        self._spmd_updater = None

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
        # one updater per replica, made as the replicas are seen
        # (FusedUpdater extends Updater: the same states, the same file)
        self._updaters: List[opt_mod.FusedUpdater] = []

    def _new_updater(self) -> opt_mod.FusedUpdater:
        return opt_mod.FusedUpdater(self._optimizer)

    @property
    def _updater(self) -> opt_mod.FusedUpdater:
        """The first replica's updater."""
        if not self._updaters:
            self._updaters.append(self._new_updater())
        return self._updaters[0]

    def _local_update_allowed(self) -> bool:
        return (not self._update_on_kvstore
                and self._compression_params is None
                and self._optimizer.fused_static_key() is not None)

    def _fuse_resolved(self) -> bool:
        """Whether the fused update is engaged (decided once, after the
        store is made).  An explicit ``fuse_step=True`` that cannot be
        honoured falls back with one warning: the fused update changes
        nothing but speed."""
        if self._fuse_active is None:
            allowed = self._local_update_allowed()
            if self._fuse_step and not allowed:
                warnings.warn(
                    "Trainer(fuse_step=True) needs a local update (no "
                    "update on the kvstore, no gradient compression) and "
                    "an optimizer with a fused path; falling back to the "
                    "eager per-parameter loop.", UserWarning, stacklevel=3)
            self._fuse_active = allowed and self._fuse_step is not False
        return self._fuse_active

    def _init_kvstore(self):
        kind = self._kvstore_kind
        if kind is None or kind is False:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            self._kvstore = kind if isinstance(kind, kvs_mod.KVStore) \
                else kvs_mod.create(kind if isinstance(kind, str)
                                    else "device")
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            if self._update_on_kvstore is None:
                # one worker: the local update is cheaper (no store copy)
                self._update_on_kvstore = self._kvstore.type.startswith(
                    "dist")
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.init(i, p.data())
        self._kv_initialized = True
        if self._states_to_load is not None:
            fname, allow_resize = self._states_to_load
            self._states_to_load = None
            self.load_states(fname, allow_resize=allow_resize)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size: int, ignore_stale_grad: bool = False):
        """Rescale by 1/batch_size, sum the gradients, update."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._spmd_resolved() and self._step_spmd():
            return
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    # ---- the SPMD step ----------------------------------------------------
    def _spmd_resolved(self) -> bool:
        """Whether the SPMD step is engaged (decided once, after the store
        is made); an explicit ``spmd=True`` that cannot be honoured falls
        back with one warning."""
        if self._spmd_active is None:
            want = self._spmd_step if self._spmd_step is not None \
                else _env.get_bool("MXNET_SPMD")
            allowed = self._local_update_allowed()
            if want and not allowed and self._spmd_step:
                warnings.warn(
                    "Trainer(spmd=True) needs a local update (no update "
                    "on the kvstore, no gradient compression) and an "
                    "optimizer with a fused path; falling back to the "
                    "per-replica step.", UserWarning, stacklevel=3)
            self._spmd_active = bool(want) and allowed
        return self._spmd_active

    def _dense_uniform_params(self):
        """(indices, parameters, replica count) of the trainable
        parameters when every gradient is dense and every parameter has
        the same contexts, else None."""
        from ..ndarray.sparse import BaseSparseNDArray

        idxs: List[int] = []
        plist: List[Parameter] = []
        nrep = None
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            grads = p.list_grad()
            if any(isinstance(g, BaseSparseNDArray) for g in grads):
                return None
            if nrep is None:
                nrep = len(grads)
            elif len(grads) != nrep:
                return None
            idxs.append(i)
            plist.append(p)
        if plist:
            ctxs = plist[0].list_ctx()
            if any(p.list_ctx() != ctxs for p in plist[1:]):
                return None
        return idxs, plist, nrep

    def _step_spmd(self) -> bool:
        """One ``SpmdUpdater`` step; False (the caller runs the
        per-replica path) when this step's gradients are sparse, the
        layout is ragged or mixed, or the optimizer cannot take it."""
        def bail() -> bool:
            # once the SPMD updater holds the (split) states, a fallback
            # step would start from fresh states: hand them over for good
            if self._spmd_updater is not None:
                self._spmd_disengage()
            return False

        collected = self._dense_uniform_params()
        if collected is None:
            return bail()
        idxs, plist, nrep = collected
        if not plist:
            return True
        if nrep > 1 and self._kvstore is None:
            # no store with replicas: the caller does not want them summed
            return bail()
        dist = self._kvstore is not None \
            and self._kvstore.type.startswith("dist")
        if self._spmd_updater is None:
            updater = opt_mod.SpmdUpdater(self._optimizer)
            if not updater.supports(idxs, [p.list_data()[0] for p in plist]):
                self._spmd_active = False
                return False
            if any(u.states for u in self._updaters):
                # states made on the per-replica path: replica 0's are the
                # canonical ones
                updater.set_states(
                    self._updaters[0].get_states(dump_optimizer=False))
            self._spmd_updater = updater
        try:
            self._spmd_updater.update_all_mesh(
                idxs, [p.list_grad() for p in plist],
                [p.list_data() for p in plist], dist=dist)
        except opt_mod.FusedUnsupported:
            self._spmd_disengage()
            return False
        return True

    def _spmd_disengage(self):
        """Leave the SPMD step for good, handing its states to the
        per-replica updaters, so the fallback resumes where it stopped."""
        updater, self._spmd_updater = self._spmd_updater, None
        self._spmd_active = False
        if updater is None or (not updater._bstate and not updater._pstate
                               and not updater._sstate
                               and not updater._pending):
            return
        payload = updater.get_states(dump_optimizer=False)
        ctxs = self._replica_ctxs()
        nrep = len(ctxs) if ctxs else 1
        while len(self._updaters) < nrep:
            self._updaters.append(self._new_updater())
        for r, u in enumerate(self._updaters):
            u.set_states(payload, ctx=ctxs[r] if ctxs else None)

    # ---- the gradient sum -------------------------------------------------
    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        if self._fuse_resolved() and self._allreduce_grads_fused():
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            grads = p.list_grad()
            if self._update_on_kvstore:
                # the store updates: push the gradients, pull the weights
                self._kvstore.pushpull(i, grads, out=p.list_data())
            elif len(grads) > 1 or self._kvstore.type.startswith("dist"):
                self._kvstore.push(i, grads)
                self._kvstore.pull(i, out=grads)

    def _allreduce_grads_fused(self) -> bool:
        """One bucketed pushpull over every dense gradient; False (the
        caller runs the per-key loop) when a sparse gradient needs a key
        of its own this step."""
        from ..ndarray.sparse import BaseSparseNDArray

        dist = self._kvstore.type.startswith("dist")
        keys, grads = [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            g = p.list_grad()
            if len(g) > 1 or dist:
                if any(isinstance(x, BaseSparseNDArray) for x in g):
                    return False
                keys.append(i)
                grads.append(g)
        if keys:
            self._kvstore.pushpull_fused(keys, grads, out=grads)
        return True

    # ---- the update -------------------------------------------------------
    def update(self, batch_size: int, ignore_stale_grad: bool = False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad: bool = False):
        if self._update_on_kvstore:
            return  # the weights came back from the store's update
        if self._spmd_updater is not None:
            # allreduce_grads() + update() by hand while the SPMD updater
            # holds the states: hand them over and stay per replica
            self._spmd_disengage()
        if self._fuse_resolved() and self._fuse_update_ok \
                and self._update_fused():
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            for r, (data, grad) in enumerate(zip(p.list_data(),
                                                 p.list_grad())):
                while len(self._updaters) <= r:
                    self._updaters.append(self._new_updater())
                self._updaters[r](i, grad, data)

    def _update_fused(self) -> bool:
        """One ``FusedUpdater.update_all`` per replica; False (the caller
        runs the eager loop) when this step's gradients are sparse or the
        layout is ragged or mixed, or the fused step cannot be exact."""
        collected = self._dense_uniform_params()
        if collected is None:
            return False
        idxs, plist, nrep = collected
        if not plist:
            return True
        while len(self._updaters) < nrep:
            self._updaters.append(self._new_updater())
        try:
            for r in range(nrep):
                self._updaters[r].update_all(
                    idxs, [p.list_grad()[r] for p in plist],
                    [p.list_data()[r] for p in plist])
        except opt_mod.FusedUnsupported:
            # fixed for the run (optimizer class, weight dtypes): latch
            self._fuse_update_ok = False
            return False
        return True

    def optimizer_state_bytes(self):
        """(state_bytes, shard_factor): a device carries
        ``state_bytes / shard_factor`` bytes of optimizer state (fp32
        master copies included).  Per replica the factor is 1 and the
        bytes are one updater's; under ``SpmdUpdater`` the bytes are the
        whole job's and the factor the shard count of the split
        states."""
        def tree_bytes(s):
            if s is None:
                return 0
            if isinstance(s, (tuple, list)):
                return sum(tree_bytes(x) for x in s)
            t = getattr(s, "_data", s)
            return t.numel() * t.element_size()

        u = self._spmd_updater
        if u is not None:
            return u.state_bytes(), u.shard_factor()
        if not self._updaters:
            return 0, 1
        return sum(tree_bytes(s) for k, s in self._updaters[0].states.items()
                   if not isinstance(k, str)), 1

    # ---- states -----------------------------------------------------------
    def _states_payload(self) -> bytes:
        """The states of every replica's updater: the single-replica
        format for one, ``__mx_replica_states__`` for several."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("the optimizer states live on the kvstore "
                             "(update_on_kvstore); use save_states")
        if self._spmd_updater is not None:
            return self._spmd_updater.get_states(dump_optimizer=False)
        if not self._updaters:
            self._updaters.append(self._new_updater())
        if len(self._updaters) == 1:
            return self._updaters[0].get_states(dump_optimizer=False)
        return pickle.dumps({"__mx_replica_states__": [
            u.get_states(dump_optimizer=False) for u in self._updaters]})

    def save_states(self, fname: str):
        """Write the optimizer states (see :meth:`_states_payload`; with
        the update on the store, the store's)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=False)
            return
        with open(fname, "wb") as f:
            f.write(self._states_payload())

    def _replica_ctxs(self):
        """The contexts the replica updaters map onto: the longest list
        over the trainable parameters (None before any is
        initialized)."""
        best = None
        for p in self._params:
            if p.grad_req == "null":
                continue
            try:
                ctxs = p.list_ctx()
                p._check_ctx(None)
            except MXNetError:
                continue
            if best is None or len(ctxs) > len(best):
                best = ctxs
        return best

    def load_states(self, fname: str, allow_resize: bool = False):
        """Restore the optimizer states (a file of either package's
        ``save_states``), each replica's on its device.
        ``allow_resize=True`` takes a file of another replica count:
        replicas in sync hold the same states, so fewer take a prefix
        and more repeat replica 0's; without it a count that differs
        raises."""
        if not self._kv_initialized:
            self._states_to_load = (fname, allow_resize)
            return
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            data = f.read()
        obj = pickle.loads(data)
        if self._spmd_updater is not None:
            if isinstance(obj, dict) and "__mx_replica_states__" in obj:
                self._spmd_updater.set_states(
                    obj["__mx_replica_states__"][0])
            else:
                self._spmd_updater.set_states(data)
            return
        ctxs = self._replica_ctxs()
        nrep = len(ctxs) if ctxs else max(len(self._updaters), 1)
        while len(self._updaters) < nrep:
            self._updaters.append(self._new_updater())
        if isinstance(obj, dict) and "__mx_replica_states__" in obj:
            blobs = obj["__mx_replica_states__"]
            if len(blobs) != len(self._updaters):
                if not allow_resize:
                    raise MXNetError(
                        f"checkpoint {fname!r} holds {len(blobs)} replica "
                        f"states but this trainer runs "
                        f"{len(self._updaters)} replicas (pass "
                        "allow_resize=True to resume on another count)")
                n = len(self._updaters)
                blobs = blobs[:n] if len(blobs) >= n \
                    else blobs + [blobs[0]] * (n - len(blobs))
            for r, (u, blob) in enumerate(zip(self._updaters, blobs)):
                u.set_states(blob, ctx=ctxs[r] if ctxs else None)
        else:
            for r, u in enumerate(self._updaters):
                u.set_states(data, ctx=ctxs[r] if ctxs else None)
