"""Optimizers of the port (counterpart of
``mxnet_tpu/optimizer/optimizer.py``): the registry, ``create``, the
``Optimizer`` base with its learning-rate bookkeeping (``lr_mult``/
``wd_mult`` through ``param_dict``), ``SGD``, ``NAG`` and ``Adam``, and the
serializable per-parameter ``Updater`` that ``gluon.Trainer`` runs.

Three paths share the update ops of ``ops/optimizer_ops.py``:
``parallel.SPMDTrainer`` runs them through
``parallel.functional_optimizer``; the eager per-parameter path here
(``update``/``update_multi_precision`` on NDArrays, the optimizer states
as NDArrays) writes their results back into the weight and the states
in place under ``torch.no_grad``; and ``fused.FusedUpdater`` runs each
optimizer's ``fused_apply`` — the same ops on tensors, with the per-step
scalars of ``fused_hyper`` as 0-d fp32 tensors — over every parameter
in one captured step, giving the eager path's bits.  The other ten
optimizers of the JAX package are ROADMAP queue A item 4.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "Updater", "create",
           "register", "get_updater"]

_REG: Dict[str, type] = {}
# registered in the JAX package, not ported yet (ROADMAP queue A item 4)
_QUEUED = ("adagrad", "adadelta", "adamax", "nadam", "rmsprop",
           "ftrl", "signum", "signsgd", "lamb", "test")


def register(name: str):
    def deco(cls):
        key = name.lower()
        if key in _REG:
            raise MXNetError(f"optimizer {name!r} already registered")
        _REG[key] = cls
        return cls
    return deco


def create(name, **kwargs) -> "Optimizer":
    """An optimizer by registered name (case-insensitive), or ``name``
    itself when it is an Optimizer already."""
    if isinstance(name, Optimizer):
        return name
    cls = _REG.get(str(name).lower())
    if cls is None:
        queued = " (ROADMAP queue A item 4)" \
            if str(name).lower() in _QUEUED else ""
        raise MXNetError(f"optimizer {name!r} is not ported{queued}; "
                         f"registered: {sorted(_REG)}")
    return cls(**kwargs)


def _write(targets, values):
    """Write update results back into the NDArrays they replace (the
    update methods run under no_grad: the update math stays off the
    autograd graph of a weight that requires grad)."""
    for t, v in zip(targets, values):
        t._data.copy_(v)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    # ---- state -----------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` a half-precision weight gets fp32
        state and an fp32 master copy, as (state, master)."""
        if self.multi_precision and weight._data.dtype in (
                torch.float16, torch.bfloat16):
            w32 = weight.astype("float32")
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    # ---- bookkeeping -----------------------------------------------------
    def _update_count(self, index):
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _get_lr(self, index) -> float:
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _common(self, index) -> Dict[str, float]:
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient
                    if self.clip_gradient is not None else -1.0)

    # ---- the fused step (optimizer/fused.py) -----------------------------
    #
    #   _FUSED_STATIC : the attributes the update math reads as Python
    #       floats; they are part of the captured step's signature.  None
    #       marks an optimizer without a fused path.
    #   fused_hyper   : the per-step scalars of one parameter, on the
    #       host (lr with its mult and any bias correction, wd with its
    #       mult, rescale_grad); the captured step reads them from a
    #       buffer written before each replay.
    #   fused_apply   : the update on tensors, (weight, grad, state,
    #       hyper) -> (new weight, new state), hyper of 0-d tensors.

    _FUSED_STATIC: Optional[Tuple[str, ...]] = None
    # True when fused_hyper carries the step count t (none of the three
    # optimizers of the port): such a step takes the eager loop on half
    # weights without a master copy (FusedUpdater.supports)
    _FUSED_T_HYPER = False

    def fused_static_key(self) -> Optional[Tuple]:
        """The static attributes as a hashable key, or None when this
        optimizer has no fused path."""
        if self._FUSED_STATIC is None:
            return None
        return tuple((a, getattr(self, a)) for a in self._FUSED_STATIC)

    def fused_hyper(self, index, t) -> Dict[str, float]:
        return {"lr": float(self._get_lr(index)),
                "wd": float(self._get_wd(index)),
                "rescale_grad": float(self.rescale_grad)}

    def _fused_common(self, hyper) -> Dict[str, Any]:
        return dict(lr=hyper["lr"], wd=hyper["wd"],
                    rescale_grad=hyper["rescale_grad"],
                    clip_gradient=self.clip_gradient
                    if self.clip_gradient is not None else -1.0)

    def fused_apply(self, weight, grad, state, hyper):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the fused step")

    # ---- the eager update ------------------------------------------------
    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _mp_active(self, weight, state) -> bool:
        return (self.multi_precision and isinstance(state, tuple)
                and state[-1]._data.dtype == torch.float32
                and weight._data.dtype in (torch.float16, torch.bfloat16))

    def update_multi_precision(self, index, weight, grad, state):
        if self._mp_active(weight, state):
            self._update_mp(index, weight, grad, state)
        else:
            self.update(index, weight, grad, state)

    @torch.no_grad()
    def _update_mp(self, index, weight, grad, state):
        inner, w32 = state
        self.update(index, w32, grad.astype("float32"), inner)
        _write([weight], [w32._data])


@register("sgd")
class SGD(Optimizer):
    """SGD with optional momentum: ``sgd_update`` / ``sgd_mom_update``
    (``mp_*`` on an fp32 master copy under ``multi_precision``)."""

    _MOM_OP = "sgd_mom_update"

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        from ..ndarray.ndarray import NDArray

        return NDArray(torch.zeros_like(weight._data))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common(index)
        if state is None:
            _write([weight], [ops.sgd_update(weight._data, grad._data, **kw)])
        else:
            _write([weight, state], getattr(ops, self._MOM_OP)(
                weight._data, grad._data, state._data,
                momentum=self.momentum, **kw))

    @torch.no_grad()
    def _update_mp(self, index, weight, grad, state):
        if self._MOM_OP != SGD._MOM_OP:
            return super()._update_mp(index, weight, grad, state)
        inner, w32 = state
        self._update_count(index)
        kw = self._common(index)
        if inner is None:
            _write([weight, w32], ops.mp_sgd_update(
                weight._data, grad._data, w32._data, **kw))
        else:
            _write([weight, inner, w32], ops.mp_sgd_mom_update(
                weight._data, grad._data, inner._data, w32._data,
                momentum=self.momentum, **kw))


    _FUSED_STATIC = ("momentum", "clip_gradient")

    def fused_apply(self, weight, grad, state, hyper):
        kw = self._fused_common(hyper)
        if state is None:
            return ops.sgd_update(weight, grad, **kw), None
        return getattr(ops, self._MOM_OP)(weight, grad, state,
                                          momentum=self.momentum, **kw)


@register("nag")
class NAG(SGD):
    """SGD with Nesterov momentum (``nag_mom_update``)."""

    _MOM_OP = "nag_mom_update"


@register("adam")
class Adam(Optimizer):
    """Adam through ``adam_update`` (no bias correction in the op): the
    bias correction sqrt(1 - beta2^t) / (1 - beta1^t) is folded into lr on
    the host, in Python floats, from the parameter's own update count.
    Under ``multi_precision`` the moments and the update run on the fp32
    master copy (the base class's ``_update_mp``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        from ..ndarray.ndarray import NDArray

        return (NDArray(torch.zeros_like(weight._data)),
                NDArray(torch.zeros_like(weight._data)))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common(index)
        kw["lr"] *= (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
        _write([weight, mean, var], ops.adam_update(
            weight._data, grad._data, mean._data, var._data,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon, **kw))

    _FUSED_STATIC = ("beta1", "beta2", "epsilon", "clip_gradient")

    def fused_hyper(self, index, t):
        h = super().fused_hyper(index, t)
        # the eager path's host-side bias correction, in Python floats
        h["lr"] *= (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        return h

    def fused_apply(self, weight, grad, state, hyper):
        mean, var = state
        nw, nm, nv = ops.adam_update(weight, grad, mean, var,
                                     beta1=self.beta1, beta2=self.beta2,
                                     epsilon=self.epsilon,
                                     **self._fused_common(hyper))
        return nw, (nm, nv)


class Updater:
    """The per-parameter updater (``Trainer`` runs one): the states by
    index, created on first use; ``get_states``/``set_states`` pickle
    them as numpy arrays, the JAX package's format, so a file written by
    either package loads in the other."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, Any] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False) -> bytes:
        from ..ndarray.ndarray import NDArray

        def to_np(s):
            if isinstance(s, NDArray):
                return s.asnumpy()
            if isinstance(s, (tuple, list)):
                return tuple(to_np(x) for x in s)
            return s

        payload = {k: to_np(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((payload, type(self.optimizer).__name__,
                                 self.optimizer.__dict__.copy()))
        return pickle.dumps(payload)

    def set_states(self, states: bytes, ctx=None):
        """Restore a payload; ``ctx`` places the buffers (the weights'
        device)."""
        data = pickle.loads(states)
        payload = data[0] if isinstance(data, tuple) and len(data) == 3 \
            else data
        for k, v in payload.items():
            self.states[k] = self._restore(v, ctx)

    def _restore(self, v, ctx):
        if isinstance(v, np.ndarray):
            from ..ndarray.ndarray import array

            return array(v, ctx=ctx)
        if isinstance(v, tuple):
            return tuple(self._restore(x, ctx) for x in v)
        return v


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
