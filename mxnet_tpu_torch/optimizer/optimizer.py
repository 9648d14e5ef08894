"""Optimizers of the port (counterpart of
``mxnet_tpu/optimizer/optimizer.py``): the registry, ``create``, the
``Optimizer`` base with its learning-rate bookkeeping (``lr_mult``/
``wd_mult`` through ``param_dict``), the thirteen optimizers the JAX
package registers (``sgd``, ``nag``, ``adam``, ``adagrad``,
``adadelta``, ``adamax``, ``nadam``, ``rmsprop``, ``ftrl``, ``signum``,
``signsgd``, ``lamb``, ``test``), and the serializable per-parameter
``Updater`` that ``gluon.Trainer`` runs.

Three paths share the update ops of ``ops/optimizer_ops.py``:
``parallel.SPMDTrainer`` runs them through
``parallel.functional_optimizer``; the eager per-parameter path here
(``update``/``update_multi_precision`` on NDArrays, the optimizer states
as NDArrays) writes their results back into the weight and the states
in place under ``torch.no_grad``; and ``fused.FusedUpdater`` runs each
optimizer's ``fused_apply`` — the same ops on tensors, with the per-step
scalars of ``fused_hyper`` as 0-d tensors — over every parameter in one
captured step, giving the eager path's bits.  Where an update depends on
the step count t (Adamax, Nadam, LAMB), ``fused_hyper`` carries the
factors the eager op computes on the host from t, in the same Python
floats, rather than t itself.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..base import MXNetError
from ..ops import optimizer_ops as _opt_ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "Adamax", "Nadam", "RMSProp", "Ftrl", "Signum", "SignSGD",
           "LAMB", "Test", "Updater", "create", "register", "get_updater"]

_REG: Dict[str, type] = {}


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
        raise MXNetError(f"optimizer {name!r} is not registered; "
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
    # True when the update depends on the step count t (Adamax, Nadam,
    # LAMB): such a step takes the eager loop on half weights without a
    # master copy, the JAX package's rule (FusedUpdater.update_all)
    _FUSED_T_HYPER = False
    # True when fused_apply is elementwise, so that parameters could be
    # concatenated into flat buckets; LAMB's per-tensor trust ratio sets
    # it False (nothing in the port concatenates parameters yet)
    _FUSED_ELEMENTWISE = True

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

    def _fused_clip(self) -> float:
        return self.clip_gradient if self.clip_gradient is not None \
            else -1.0

    def _fused_common(self, hyper) -> Dict[str, Any]:
        return dict(lr=hyper["lr"], wd=hyper["wd"],
                    rescale_grad=hyper["rescale_grad"],
                    clip_gradient=self._fused_clip())

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


def _zeros(weight, n=1, dtype=None):
    """n zero NDArrays shaped as ``weight`` (its dtype unless given); one
    NDArray when n is 1."""
    from ..ndarray.ndarray import NDArray

    zs = tuple(NDArray(torch.zeros_like(weight._data, dtype=dtype))
               for _ in range(n))
    return zs[0] if n == 1 else zs


def _t_hyper(h, names, values):
    """``h`` with the host floats ``values`` under ``names``."""
    h.update(zip(names, (float(v) for v in values)))
    return h


@register("adagrad")
class AdaGrad(Optimizer):
    """AdaGrad (``adagrad_update``): one accumulator of squared
    gradients."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        _write([weight, state], ops.adagrad_update(
            weight._data, grad._data, state._data,
            epsilon=self.float_stable_eps, **self._common(index)))

    _FUSED_STATIC = ("float_stable_eps", "clip_gradient")

    def fused_apply(self, weight, grad, state, hyper):
        return ops.adagrad_update(weight, grad, state,
                                  epsilon=self.float_stable_eps,
                                  **self._fused_common(hyper))


@register("adadelta")
class AdaDelta(Optimizer):
    """AdaDelta (``adadelta_update`` at lr 1, as the JAX class runs it):
    the accumulated gradients and deltas."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common(index)
        kw["lr"] = 1.0
        acc_g, acc_d = state
        _write([weight, acc_g, acc_d], ops.adadelta_update(
            weight._data, grad._data, acc_g._data, acc_d._data,
            rho=self.rho, epsilon=self.epsilon, **kw))

    _FUSED_STATIC = ("rho", "epsilon", "clip_gradient")

    def fused_apply(self, weight, grad, state, hyper):
        acc_g, acc_d = state
        kw = self._fused_common(hyper)
        kw["lr"] = 1.0
        nw, ng, ndel = ops.adadelta_update(weight, grad, acc_g, acc_d,
                                           rho=self.rho,
                                           epsilon=self.epsilon, **kw)
        return nw, (ng, ndel)


@register("adamax")
class Adamax(Optimizer):
    """Adamax (``adamax_update``): the bias-corrected rate lr / (1 -
    beta1^t) from the parameter's own update count."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        _write([weight, mean, var], ops.adamax_update(
            weight._data, grad._data, mean._data, var._data,
            beta1=self.beta1, beta2=self.beta2, t=t, **self._common(index)))

    _FUSED_STATIC = ("beta1", "beta2", "clip_gradient")
    _FUSED_T_HYPER = True

    def fused_hyper(self, index, t):
        h = super().fused_hyper(index, t)
        # the op's host-side lr / (1 - beta1^t)
        h["lr"] /= _opt_ops.adamax_coef(self.beta1, t)
        return h

    def fused_apply(self, weight, grad, state, hyper):
        mean, var = state
        kw = self._fused_common(hyper)
        lr_t = kw.pop("lr")
        nw, nm, nv = _opt_ops.adamax_step(weight, grad, mean, var, lr_t,
                                          beta1=self.beta1,
                                          beta2=self.beta2, **kw)
        return nw, (nm, nv)


_NADAM_COEFS = ("one_m_t", "m_t1", "one_m_t1", "bc2")


@register("nadam")
class Nadam(Optimizer):
    """Nadam (``nadam_update``): Adam with Nesterov momentum through the
    schedule-decay momentum correction at the parameter's update
    count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        _write([weight, mean, var], ops.nadam_update(
            weight._data, grad._data, mean._data, var._data,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon, t=t,
            schedule_decay=self.schedule_decay, **self._common(index)))

    _FUSED_STATIC = ("beta1", "beta2", "epsilon", "schedule_decay",
                     "clip_gradient")
    _FUSED_T_HYPER = True

    def fused_hyper(self, index, t):
        return _t_hyper(super().fused_hyper(index, t), _NADAM_COEFS,
                        _opt_ops.nadam_coefs(self.beta1, t,
                                             self.schedule_decay)
                        + (1 - self.beta2 ** t,))

    def fused_apply(self, weight, grad, state, hyper):
        mean, var = state
        nw, nm, nv = _opt_ops.nadam_step(
            weight, grad, mean, var, hyper["lr"],
            tuple(hyper[k] for k in _NADAM_COEFS), beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=hyper["wd"],
            rescale_grad=hyper["rescale_grad"],
            clip_gradient=self._fused_clip())
        return nw, (nm, nv)


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp: ``rmsprop_update`` with one state, or, ``centered``,
    ``rmspropalex_update`` (Graves) with three (n, g, delta)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros(weight, 3 if self.centered else 1)

    def _apply(self, weight, grad, state, kw):
        kw["clip_weights"] = self.clip_weights if self.clip_weights \
            else -1.0
        if self.centered:
            n, g, delta = state
            nw, nn, ng, nd = ops.rmspropalex_update(
                weight, grad, n, g, delta, gamma1=self.gamma1,
                gamma2=self.gamma2, epsilon=self.epsilon, **kw)
            return nw, (nn, ng, nd)
        return ops.rmsprop_update(weight, grad, state, gamma1=self.gamma1,
                                  epsilon=self.epsilon, **kw)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        states = state if self.centered else (state,)
        nw, ns = self._apply(weight._data, grad._data,
                             _state_tensors(state), self._common(index))
        _write([weight, *states], (nw,) + (ns if self.centered else (ns,)))

    _FUSED_STATIC = ("gamma1", "gamma2", "epsilon", "centered",
                     "clip_weights", "clip_gradient")

    def fused_apply(self, weight, grad, state, hyper):
        return self._apply(weight, grad, state, self._fused_common(hyper))


@register("ftrl")
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``): the z and n accumulators."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _write([weight, z, n], ops.ftrl_update(
            weight._data, grad._data, z._data, n._data, lamda1=self.lamda1,
            beta=self.beta, **self._common(index)))

    _FUSED_STATIC = ("lamda1", "beta", "clip_gradient")

    def fused_apply(self, weight, grad, state, hyper):
        z, n = state
        nw, nz, nn = ops.ftrl_update(weight, grad, z, n, lamda1=self.lamda1,
                                     beta=self.beta,
                                     **self._fused_common(hyper))
        return nw, (nz, nn)


@register("signum")
class Signum(Optimizer):
    """Signum (``signum_update``, one momentum state), or SignSGD
    (``signsgd_update``, no state) at momentum 0."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def _apply(self, weight, grad, state, kw):
        if state is None:
            return ops.signsgd_update(weight, grad, **kw), None
        return ops.signum_update(weight, grad, state,
                                 momentum=self.momentum, wd_lh=self.wd_lh,
                                 **kw)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        nw, ns = self._apply(weight._data, grad._data,
                             _state_tensors(state), self._common(index))
        _write([weight] + ([] if state is None else [state]), (nw, ns))

    _FUSED_STATIC = ("momentum", "wd_lh", "clip_gradient")

    def fused_apply(self, weight, grad, state, hyper):
        return self._apply(weight, grad, state, self._fused_common(hyper))


@register("signsgd")
class SignSGD(Signum):
    """Signum at momentum 0 unless given."""

    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


_LAMB_COEFS = ("bc1", "bc2")


@register("lamb")
class LAMB(Optimizer):
    """LAMB (``lamb_update_phase1`` then ``lamb_update_phase2``): the Adam
    direction, then a step scaled by the trust ratio ||w|| / ||direction||
    of each tensor (so no concatenation of parameters:
    ``_FUSED_ELEMENTWISE`` is False)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _phase2(self, weight, direction, lr):
        return ops.lamb_update_phase2(
            weight, direction, ops.norm(weight), ops.norm(direction), lr=lr,
            lower_bound=self.lower_bound or -1.0,
            upper_bound=self.upper_bound or -1.0)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        mean, var = state
        direction, nm, nv = ops.lamb_update_phase1(
            weight._data, grad._data, mean._data, var._data,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon, t=t,
            bias_correction=self.bias_correction, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient or -1.0)
        _write([mean, var], (nm, nv))
        _write([weight], [self._phase2(weight._data, direction,
                                       self._get_lr(index))])

    _FUSED_STATIC = ("beta1", "beta2", "epsilon", "lower_bound",
                     "upper_bound", "bias_correction", "clip_gradient")
    _FUSED_T_HYPER = True
    _FUSED_ELEMENTWISE = False

    def fused_hyper(self, index, t):
        h = super().fused_hyper(index, t)
        if not self.bias_correction:
            return h
        return _t_hyper(h, _LAMB_COEFS,
                        _opt_ops.lamb_coefs(self.beta1, self.beta2, t))

    def fused_apply(self, weight, grad, state, hyper):
        mean, var = state
        coefs = tuple(hyper[k] for k in _LAMB_COEFS) \
            if self.bias_correction else None
        direction, nm, nv = _opt_ops.lamb_phase1_step(
            weight, grad, mean, var, coefs, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=hyper["wd"],
            rescale_grad=hyper["rescale_grad"],
            clip_gradient=self._fused_clip())
        return self._phase2(weight, direction, hyper["lr"]), (nm, nv)


@register("test")
class Test(Optimizer):
    """The JAX package's test optimizer: w + rescale_grad * g, one fp32
    state it never changes."""

    def create_state(self, index, weight):
        return _zeros(weight, dtype=torch.float32)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _write([weight], [weight._data + grad._data * self.rescale_grad])

    _FUSED_STATIC = ()

    def fused_apply(self, weight, grad, state, hyper):
        return weight + grad * hyper["rescale_grad"], state


def _state_tensors(state):
    """An NDArray state (None, one, or a tuple) as tensors."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(s._data for s in state)
    return state._data


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
