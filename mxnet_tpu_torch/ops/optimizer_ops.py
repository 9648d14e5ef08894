"""Update ops (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``:
sgd_update, sgd_mom_update, nag_mom_update, mp_sgd_update,
mp_sgd_mom_update, adam_update, mp_adam_update).

Each op is a pure function returning the new weight (and new state
tensors); the caller writes them back.  The dtype rules are the JAX
package's as its SPMD step runs them, which differ from PyTorch's own:

* ``momentum``, ``wd``, ``rescale_grad`` and ``clip_gradient`` are Python
  floats, weakly typed in JAX: against a bf16 tensor they are first
  rounded to bf16 (0.9 becomes 0.8984375), and the result stays bf16.
  :func:`_weak` does that rounding on the host.
* ``lr`` is the fp32 0-d array the step passes (``spmd.py:626``), which
  is not weak: ``lr * g`` promotes a bf16 ``g`` to fp32, and with it the
  new momentum and the new weight.  PyTorch would keep a bf16 tensor
  times a 0-d fp32 tensor in bf16, so the ops cast ``g`` to fp32
  themselves.  The caller casts the results back to the weight's and
  the state's dtype (``spmd.py:480-481``).
* The Adam ops take ``lr`` as the JAX package's Adam callers pass it, a
  Python float (the functional form passes 1.0 and scales the step
  afterwards, the eager ``Adam`` the bias-corrected rate), so it is weak
  like the other scalars: a bf16 weight keeps the whole update in bf16,
  where ``0.999 * v`` rounds back to v.

A captured step (``optimizer.fused``) passes the scalars that change
from step to step as 0-d fp32 tensors on the device, written before
each replay: ``lr`` (``SPMDTrainer``), and ``lr``, ``wd`` and
``rescale_grad`` per parameter (``FusedUpdater``).  They give the bits
of the Python floats they hold: an fp32 ``lr`` multiplies as the float
does after its cast to fp32, and a weak scalar is cast to the tensor's
dtype, as :func:`_weak` rounds the float (through fp32 in both).
``momentum``, the betas, ``epsilon`` and ``clip_gradient`` stay Python
floats: they are part of the captured step's signature.
"""
from __future__ import annotations

import functools

import torch

from .registry import register_op

__all__ = ["sgd_update", "sgd_mom_update", "nag_mom_update",
           "mp_sgd_update", "mp_sgd_mom_update", "adam_update",
           "mp_adam_update"]


@functools.lru_cache(maxsize=256)
def _round_to(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def _weak(value, t):
    """A Python scalar as JAX's weak typing sees it next to tensor ``t``:
    rounded to ``t``'s dtype (a 0-d tensor: cast to it)."""
    if isinstance(value, torch.Tensor):
        return value.to(t.dtype)
    return _round_to(float(value), t.dtype)


def _lr_times(lr, g):
    """``lr * g`` with lr an fp32 scalar (a float or a 0-d fp32 tensor)
    that promotes a half ``g``."""
    acc = torch.promote_types(g.dtype, torch.float32)
    if isinstance(lr, torch.Tensor):
        return g.to(acc) * lr.to(acc)
    return g.to(acc) * float(lr)


def _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight):
    g = grad * _weak(rescale_grad, grad)
    if clip_gradient is not None and clip_gradient > 0:
        c = _weak(clip_gradient, g)
        g = g.clamp(-c, c)
    return g + weight * _weak(wd, weight)


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """w - lr * (rescaled, clipped grad + wd * w)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - _lr_times(lr, g)


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom' = momentum*mom - lr*g; w' = w + mom'.  Returns (w', mom')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = mom * _weak(momentum, mom) - _lr_times(lr, g)
    return weight + new_mom, new_mom


def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov: mom' = momentum*mom + g; w' = w - lr*(g + momentum*mom').
    Returns (w', mom')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = mom * _weak(momentum, mom) + g
    step = g + new_mom * _weak(momentum, new_mom)
    return weight - _lr_times(lr, step), new_mom


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """SGD on the fp32 master copy.  Returns (w cast to weight's dtype,
    new master)."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                      weight32)
    new_w32 = weight32 - _lr_times(lr, g)
    return new_w32.to(weight.dtype), new_w32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """SGD with momentum on the fp32 master copy.  Returns (w cast to
    weight's dtype, new mom, new master)."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                      weight32)
    new_mom = mom * _weak(momentum, mom) - _lr_times(lr, g)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def _adam_moments(g, mean, var, beta1, beta2):
    """beta1*mean + (1-beta1)*g and beta2*var + (1-beta2)*g², each
    Python scalar weak against its tensor."""
    new_mean = mean * _weak(beta1, mean) + g * _weak(1 - beta1, g)
    gg = torch.square(g)
    new_var = var * _weak(beta2, var) + gg * _weak(1 - beta2, gg)
    return new_mean, new_var


def _adam_step(weight, new_mean, new_var, lr, epsilon):
    """weight - lr * mean / (sqrt(var) + epsilon)."""
    root = torch.sqrt(new_var)
    step = new_mean * _weak(lr, new_mean) / (root + _weak(epsilon, root))
    return weight - step


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adam without bias correction (MXNet's convention): the moments'
    EMAs drive w - lr * m / (sqrt(v) + eps).  Returns (w', mean',
    var')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean, new_var = _adam_moments(g, mean, var, beta1, beta2)
    return (_adam_step(weight, new_mean, new_var, lr, epsilon), new_mean,
            new_var)


def mp_adam_update(weight, grad, mean, var, weight32, lr=0.001, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """Adam on the fp32 master copy with fp32 moments.  Returns (w cast
    to weight's dtype, mean', var', new master)."""
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                      weight32)
    new_mean, new_var = _adam_moments(g, mean, var, beta1, beta2)
    new_w32 = _adam_step(weight32, new_mean, new_var, lr, epsilon)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


for _op in (sgd_update, sgd_mom_update, nag_mom_update, mp_sgd_update,
            mp_sgd_mom_update, adam_update, mp_adam_update):
    register_op(_op.__name__)(_op)
