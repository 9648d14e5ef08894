"""Update ops (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``): the
single-tensor updates of SGD, NAG, Adam, RMSProp (plain and centred,
``rmspropalex_update``), FTRL, SignSGD, Signum, AdaGrad (also under
``_sparse_adagrad_update``), AdaDelta, Adamax and Nadam, with the
multi-precision ``mp_*`` forms; the multi-tensor ops
(``multi_sum_sq``, ``multi_sgd_update``, ``multi_sgd_mom_update``,
``multi_mp_sgd_update``, ``multi_mp_sgd_mom_update``,
``preloaded_multi_sgd_update``, ``multi_lars``); and LAMB's two phases.

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

The ops after Adam keep these rules.  ``lr`` is the SGD ops' fp32
scalar, which promotes a half operand (``_lr_times``, and
``_lr_div`` where the JAX op divides by it), since
``SPMDTrainer``'s functional forms pass it as the JAX step's fp32
array.  The factors of the bias corrections (Adamax's ``1 - beta1^t``,
Nadam's momentum schedule, LAMB's ``1 - beta^t``) are computed on the
host in Python floats from the int step ``t``, as the JAX op computes
them from its Python attribute, and weak; a captured step passes the
same host floats (``optimizer.fused``), so it gives the eager op's bits.
A product of two scalars (Signum's ``lr * wd``) and a division by a
scalar run on 0-d tensors on the operand's device (``_scalar``,
``_div``), in both the eager and the captured path: the card divides by
a Python scalar as a product with its reciprocal, but by a tensor
exactly, as the CPU and XLA do.  The multi-tensor ops take their
per-weight ``lrs``/``wds`` as the JAX op takes them, Python floats, weak
(``preloaded_multi_sgd_update``: fp32 tensors, which promote).
"""
from __future__ import annotations

import functools

import torch

from .registry import register_op

__all__ = ["sgd_update", "sgd_mom_update", "nag_mom_update",
           "mp_sgd_update", "mp_sgd_mom_update", "adam_update",
           "mp_adam_update", "rmsprop_update", "rmspropalex_update",
           "ftrl_update", "signsgd_update", "signum_update",
           "adagrad_update", "adadelta_update", "adamax_update",
           "nadam_update", "multi_sum_sq", "multi_sgd_update",
           "multi_sgd_mom_update", "multi_mp_sgd_update",
           "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
           "multi_lars", "lamb_update_phase1", "lamb_update_phase2"]


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


def _scalar(value, like):
    """``value`` as a 0-d tensor: a tensor as it is (the step's fp32
    buffer), a Python scalar on ``like``'s device in the dtype ``lr``
    promotes ``like`` to (fp32; float64 next to float64)."""
    if isinstance(value, torch.Tensor):
        return value
    acc = torch.promote_types(like.dtype, torch.float32)
    return torch.full((), float(value), dtype=acc, device=like.device)


def _lr_div(x, lr):
    """``x / lr`` with lr the fp32 scalar of :func:`_lr_times`."""
    s = _scalar(lr, x)
    dt = torch.promote_types(x.dtype, s.dtype)
    return x.to(dt) / s.to(device=x.device, dtype=dt)


def _div(x, c):
    """``x / c`` with ``c`` a weak scalar (a host float, or a 0-d tensor
    holding one), divided exactly."""
    if isinstance(c, torch.Tensor):
        return x / c.to(device=x.device, dtype=x.dtype)
    return x / torch.full((), _weak(c, x), dtype=x.dtype, device=x.device)


def _mul0(s, x):
    """``s * x`` with ``s`` a 0-d tensor that is not weak: the result takes
    the wider of the two dtypes, as in JAX."""
    dt = torch.promote_types(x.dtype, s.dtype)
    return x.to(dt) * s.to(dt)


def _rescale_clip_only(grad, rescale_grad, clip_gradient):
    g = grad * _weak(rescale_grad, grad)
    if clip_gradient is not None and clip_gradient > 0:
        c = _weak(clip_gradient, g)
        g = g.clamp(-c, c)
    return g


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        c = _weak(clip_weights, w)
        w = w.clamp(-c, c)
    return w


def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """n' = (1-gamma1)*g² + gamma1*n; w' = w - lr*g/sqrt(n' + eps),
    clipped to ±clip_weights when it is positive.  Returns (w', n')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    gg = torch.square(g)
    new_n = gg * _weak(1 - gamma1, gg) + n * _weak(gamma1, n)
    w = weight - _lr_times(lr, g) / torch.sqrt(new_n + _weak(epsilon, new_n))
    return _clip_weights(w, clip_weights), new_n


def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    """Centred RMSProp (Graves): n' = (1-gamma1)*g² + gamma1*n,
    g' = (1-gamma1)*g + gamma1*g_state, delta' = gamma2*delta -
    lr*g/sqrt(n' - g'² + eps), w' = w + delta'.  Returns (w', n', g',
    delta')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    gg = torch.square(g)
    new_n = gg * _weak(1 - gamma1, gg) + n * _weak(gamma1, n)
    new_g = g * _weak(1 - gamma1, g) + g_state * _weak(gamma1, g_state)
    den = torch.sqrt(new_n - torch.square(new_g) + _weak(epsilon, new_n))
    new_delta = delta * _weak(gamma2, delta) - _lr_times(lr, g) / den
    return (_clip_weights(weight + new_delta, clip_weights), new_n, new_g,
            new_delta)


def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal: n' = n + g², z' = z + g - (sqrt(n') - sqrt(n))/lr * w,
    w' = 0 where |z'| <= lamda1, else -(z' - sign(z')*lamda1) /
    ((beta + sqrt(n'))/lr + wd).  Returns (w', z', n')."""
    g = _rescale_clip_only(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    root = torch.sqrt(new_n)
    sigma = _lr_div(root - torch.sqrt(n), lr)
    new_z = z + g - sigma * weight
    den = _lr_div(root + _weak(beta, root), lr)
    den = den + _weak(wd, den)
    val = -(new_z - torch.sign(new_z) * _weak(lamda1, new_z)) / den
    w = torch.where(new_z.abs() <= _weak(lamda1, new_z),
                    torch.zeros_like(weight), val)
    return w, new_z, new_n


def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w' = w - lr*(sign(g) + wd*w)."""
    g = _rescale_clip_only(grad, rescale_grad, clip_gradient)
    return weight - _lr_times(lr, torch.sign(g) + weight * _weak(wd, weight))


def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """mom' = momentum*mom - (1-momentum)*g; w' = (1 - lr*wd_lh)*w +
    lr*sign(mom') - lr*wd*w.  Returns (w', mom')."""
    g = _rescale_clip_only(grad, rescale_grad, clip_gradient)
    new_mom = mom * _weak(momentum, mom) - g * _weak(1 - momentum, g)
    lr_s = _scalar(lr, weight)
    w = _mul0(1 - lr_s * wd_lh, weight) + _mul0(lr_s, torch.sign(new_mom))
    return w - _mul0(lr_s * _weak(wd, lr_s), weight), new_mom


def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """h' = h + g²; w' = w - lr*(g/sqrt(h' + eps) + wd*w).  Returns (w',
    h')."""
    g = _rescale_clip_only(grad, rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    step = g / torch.sqrt(new_hist + _weak(epsilon, new_hist)) + \
        weight * _weak(wd, weight)
    return weight - _lr_times(lr, step), new_hist


def adadelta_update(weight, grad, acc_g, acc_delta, lr=1.0, rho=0.9,
                    epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    """acc_g' = rho*acc_g + (1-rho)*g²; delta = sqrt(acc_delta + eps) /
    sqrt(acc_g' + eps) * g; acc_delta' = rho*acc_delta + (1-rho)*delta²;
    w' = w - lr*delta.  Returns (w', acc_g', acc_delta')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    gg = torch.square(g)
    new_acc_g = acc_g * _weak(rho, acc_g) + gg * _weak(1 - rho, gg)
    delta = torch.sqrt(acc_delta + _weak(epsilon, acc_delta)) / torch.sqrt(
        new_acc_g + _weak(epsilon, new_acc_g)) * g
    dd = torch.square(delta)
    new_acc_delta = acc_delta * _weak(rho, acc_delta) + dd * _weak(1 - rho,
                                                                   dd)
    return weight - _lr_times(lr, delta), new_acc_g, new_acc_delta


def adamax_coef(beta1, t) -> float:
    """Adamax's bias correction 1 - beta1^t, on the host."""
    return 1 - beta1 ** t


def adamax_step(weight, grad, mean, var, lr_t, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adamax with the bias-corrected rate lr_t = lr / (1 - beta1^t)
    given (what ``adamax_update`` computes first)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = mean * _weak(beta1, mean) + g * _weak(1 - beta1, g)
    new_var = torch.maximum(var * _weak(beta2, var), g.abs())
    step = _lr_times(lr_t, new_mean) / (new_var + _weak(epsilon, new_var))
    return weight - step, new_mean, new_var


def adamax_update(weight, grad, mean, var, lr=0.002, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                  t=1):
    """Adam with the infinity norm: mean' = beta1*mean + (1-beta1)*g,
    var' = max(beta2*var, |g|), w' = w - lr/(1-beta1^t) * mean' / (var' +
    eps).  Returns (w', mean', var')."""
    c = adamax_coef(beta1, t)
    lr_t = _div(lr, c) if isinstance(lr, torch.Tensor) else lr / c
    return adamax_step(weight, grad, mean, var, lr_t, beta1, beta2, epsilon,
                       wd, rescale_grad, clip_gradient)


def nadam_coefs(beta1, t, schedule_decay):
    """Nadam's momentum schedule at step t, on the host: (1 - m_t, m_t1,
    1 - m_t1) with m_t = beta1*(1 - 0.5*0.96^(t*decay))."""
    m_t = beta1 * (1 - 0.5 * 0.96 ** (t * schedule_decay))
    m_t1 = beta1 * (1 - 0.5 * 0.96 ** ((t + 1) * schedule_decay))
    return 1 - m_t, m_t1, 1 - m_t1


def nadam_step(weight, grad, mean, var, lr, coefs, beta1=0.9, beta2=0.999,
               epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Nadam with the step's factors given: ``coefs`` = (1 - m_t, m_t1,
    1 - m_t1, 1 - beta2^t), host floats or 0-d tensors holding them."""
    one_m_t, m_t1, one_m_t1, bc2 = coefs
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = mean * _weak(beta1, mean) + g * _weak(1 - beta1, g)
    gg = torch.square(g)
    new_var = var * _weak(beta2, var) + gg * _weak(1 - beta2, gg)
    g_hat = _div(g, one_m_t)
    m_hat = _div(new_mean, one_m_t1)
    m_bar = g_hat * _weak(one_m_t, g_hat) + m_hat * _weak(m_t1, m_hat)
    v_hat = _div(new_var, bc2)
    root = torch.sqrt(v_hat)
    step = _lr_times(lr, m_bar) / (root + _weak(epsilon, root))
    return weight - step, new_mean, new_var


def nadam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 t=1, schedule_decay=0.004):
    """Nadam: Adam with Nesterov momentum through the schedule-decay
    momentum correction.  Returns (w', mean', var')."""
    coefs = nadam_coefs(beta1, t, schedule_decay) + (1 - beta2 ** t,)
    return nadam_step(weight, grad, mean, var, lr, coefs, beta1, beta2,
                      epsilon, wd, rescale_grad, clip_gradient)


def lamb_coefs(beta1, beta2, t):
    """LAMB's bias corrections (1 - beta1^t, 1 - beta2^t), on the host."""
    return 1 - beta1 ** t, 1 - beta2 ** t


def lamb_phase1_step(weight, grad, mean, var, coefs, beta1=0.9,
                     beta2=0.999, epsilon=1e-6, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """LAMB's phase 1 with its bias corrections given (None: none)."""
    g = _rescale_clip_only(grad.float(), rescale_grad, clip_gradient)
    nm = mean * _weak(beta1, mean) + g * _weak(1 - beta1, g)
    gg = torch.square(g)
    nv = var * _weak(beta2, var) + gg * _weak(1 - beta2, gg)
    mh, vh = (nm, nv) if coefs is None else (_div(nm, coefs[0]),
                                            _div(nv, coefs[1]))
    root = torch.sqrt(vh)
    direction = mh / (root + _weak(epsilon, root)) + \
        weight * _weak(wd, weight)
    return direction, nm, nv


def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB phase 1: the Adam direction m̂/(sqrt(v̂)+eps) + wd*w from the
    fp32 gradient.  Returns (direction, mean', var')."""
    coefs = lamb_coefs(beta1, beta2, t) if bias_correction else None
    return lamb_phase1_step(weight, grad, mean, var, coefs, beta1, beta2,
                            epsilon, wd, rescale_grad, clip_gradient)


def lamb_update_phase2(weight, g, r1, r2, lr=0.001, lower_bound=-1.0,
                       upper_bound=-1.0):
    """LAMB phase 2: w - lr * trust * g with the trust ratio r1/r2 (r1 =
    ||w|| clamped to the bounds that are positive, r2 = ||g||; 1 where
    either is 0)."""
    r1v, r2v = r1.reshape(()), r2.reshape(())
    if lower_bound is not None and lower_bound > 0:
        r1v = torch.clamp(r1v, min=_weak(lower_bound, r1v))
    if upper_bound is not None and upper_bound > 0:
        r1v = torch.clamp(r1v, max=_weak(upper_bound, r1v))
    ratio = r1v / r2v
    trust = torch.where((r1v > 0) & (r2v > 0), ratio,
                        torch.ones_like(ratio))
    return weight - g * _lr_times(lr, trust)


def _chunk(arrays, n, per):
    """The flat variadic inputs as n per-weight tuples, interleaved as
    the JAX op takes them: [w0, g0, (m0, ...), w1, g1, ...]."""
    return [tuple(arrays[i * per:(i + 1) * per]) for i in range(n)]


def multi_sum_sq(*arrays, num_arrays=1):
    """Each array's sum of squares in fp32, shape (1,)."""
    return tuple(torch.sum(torch.square(a.float())).reshape(1)
                 for a in arrays)


def multi_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """SGD over [w0, g0, w1, g1, ...] with per-weight lrs/wds; returns
    the new weights."""
    outs = []
    for i, (w, g) in enumerate(_chunk(arrays, num_weights, 2)):
        gg = _rescale_clip(g, rescale_grad, clip_gradient, wds[i], w)
        outs.append(w - gg * _weak(lrs[i], gg))
    return tuple(outs)


def multi_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """SGD with momentum over [w, g, mom] triples; returns the new
    weights (the JAX op returns no momenta)."""
    outs = []
    for i, (w, g, m) in enumerate(_chunk(arrays, num_weights, 3)):
        gg = _rescale_clip(g, rescale_grad, clip_gradient, wds[i], w)
        outs.append(w + (m * _weak(momentum, m) - gg * _weak(lrs[i], gg)))
    return tuple(outs)


def multi_mp_sgd_update(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1):
    """SGD on the fp32 masters of [w, g, w32] triples; returns the new
    weights in their dtype."""
    outs = []
    for i, (w, g, w32) in enumerate(_chunk(arrays, num_weights, 3)):
        gg = _rescale_clip(g.float(), rescale_grad, clip_gradient, wds[i],
                           w32)
        outs.append((w32 - gg * _weak(lrs[i], gg)).to(w.dtype))
    return tuple(outs)


def multi_mp_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    """SGD with momentum on the fp32 masters of [w, g, mom, w32] quads;
    returns the new weights in their dtype."""
    outs = []
    for i, (w, g, m, w32) in enumerate(_chunk(arrays, num_weights, 4)):
        gg = _rescale_clip(g.float(), rescale_grad, clip_gradient, wds[i],
                           w32)
        nm = m * _weak(momentum, m) - gg * _weak(lrs[i], gg)
        outs.append((w32 + nm).to(w.dtype))
    return tuple(outs)


def preloaded_multi_sgd_update(*arrays, rescale_grad=1.0,
                               clip_gradient=-1.0, num_weights=1):
    """``multi_sgd_update`` with lrs and wds as the two trailing fp32
    tensor inputs."""
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g) in enumerate(_chunk(arrays[:-2], num_weights, 2)):
        gg = _rescale_clip_only(g, rescale_grad, clip_gradient) + \
            _mul0(wds[i], w)
        outs.append(w - _mul0(lrs[i], gg))
    return tuple(outs)


def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0):
    """LARS: each layer's lr times eta*||w|| / (||g|| + wd*||w|| + eps),
    where ||w|| > 0."""
    wn = torch.sqrt(weights_sum_sq)
    gn = torch.sqrt(grads_sum_sq)
    gn = gn * _weak(rescale_grad, gn)
    ratio = wn * _weak(eta, wn) / (gn + wds * wn + _weak(eps, wn))
    return torch.where(wn > 0, lrs * ratio, lrs)


def _nout(key):
    return lambda attrs: int(attrs.get(key, 1))


for _op in (sgd_update, sgd_mom_update, nag_mom_update, mp_sgd_update,
            mp_sgd_mom_update, adam_update, mp_adam_update):
    register_op(_op.__name__)(_op)
for _op, _n in ((rmsprop_update, 2), (rmspropalex_update, 4),
                (ftrl_update, 3), (signsgd_update, 1), (signum_update, 2),
                (adadelta_update, 3), (adamax_update, 3),
                (nadam_update, 3), (lamb_update_phase1, 3),
                (lamb_update_phase2, 1)):
    register_op(_op.__name__, num_outputs=_n)(_op)
register_op("adagrad_update", num_outputs=2,
            aliases=("_sparse_adagrad_update",))(adagrad_update)
for _op in (multi_sgd_update, multi_sgd_mom_update, multi_mp_sgd_update,
            multi_mp_sgd_mom_update, preloaded_multi_sgd_update):
    register_op(_op.__name__, num_outputs=_nout("num_weights"))(_op)
register_op("multi_sum_sq", differentiable=False,
            num_outputs=_nout("num_arrays"))(multi_sum_sq)
register_op("multi_lars", differentiable=False)(multi_lars)
