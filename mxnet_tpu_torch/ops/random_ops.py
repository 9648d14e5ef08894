"""Random sampling ops (counterpart of ``mxnet_tpu/ops/random_ops.py``).

The JAX ops take a threefry key as their first input; here that slot
takes a ``torch.Generator`` (``random.generator(ctx)`` for a device),
as ``dot_product_attention``'s ``rng_key`` does.  Each draw runs on the
generator's device and from it: the output lands there, and the host
neither draws nor copies.  The streams are not JAX's (Philox on a card,
the CPU generator on the host), so parity tests hold distributions, not
draws.

* ``_random_*``: ``shape`` draws of one distribution.  Gamma's ``beta``
  is its scale, the exponential's ``lam`` its rate, and the negative
  binomials are the JAX package's gamma-Poisson mixtures.
* ``_sample_*``: per-row draws, the parameters' shape followed by
  ``shape``; ``_sample_multinomial`` draws category indices from
  unnormalised probabilities (``get_prob`` adds the log-probability of
  each draw); ``_shuffle`` permutes axis 0.
* ``_random_pdf_*``: the density (``is_log``: its log) of a sample under
  row-wise parameters, written as ``jax.scipy.stats`` writes it, so it
  is deterministic and differentiable in the sample and the parameters.
"""
from __future__ import annotations

import math

import torch

from ..base import dtype_of
from .registry import register_op

__all__ = ["uniform", "normal", "randint", "gamma", "exponential",
           "poisson", "bernoulli", "gumbel", "laplace", "negative_binomial",
           "multinomial", "shuffle"]


def _dt(dtype):
    return dtype_of(dtype if dtype not in (None, "None") else "float32")


def _draw_dtype(dt):
    """The dtype a draw is made in: float64 for float64, else float32
    (cast to the output dtype after)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _rand(gen, shape, dtype=torch.float32):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _std_gamma(gen, alpha):
    """Gamma(alpha, 1) draws, one per element of ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(gen, lam):
    return torch.poisson(lam, generator=gen)


# ---------------------------------------------------------------------------
# _random_*: shape draws of one distribution
# ---------------------------------------------------------------------------

def uniform(generator, low=0.0, high=1.0, shape=(), dtype="float32"):
    dt = _dt(dtype)
    u = _rand(generator, tuple(shape), _draw_dtype(dt))
    return torch.clamp_min(u * (high - low) + low, low).to(dt)


def normal(generator, loc=0.0, scale=1.0, shape=(), dtype="float32"):
    dt = _dt(dtype)
    z = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=_draw_dtype(dt))
    return (loc + scale * z).to(dt)


def randint(generator, low=0, high=1, shape=(), dtype="int32"):
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=generator, device=generator.device,
                         dtype=_dt(dtype))


def gamma(generator, alpha=1.0, beta=1.0, shape=(), dtype="float32"):
    dt = _dt(dtype)
    a = torch.full(tuple(shape), float(alpha), dtype=_draw_dtype(dt),
                   device=generator.device)
    return _std_gamma(generator, a).to(dt) * beta


def exponential(generator, lam=1.0, shape=(), dtype="float32"):
    dt = _dt(dtype)
    e = torch.empty(tuple(shape), dtype=_draw_dtype(dt),
                    device=generator.device).exponential_(
                        1.0, generator=generator)
    return e.to(dt) / lam


def poisson(generator, lam=1.0, shape=(), dtype="float32"):
    rate = torch.full(tuple(shape), float(lam), device=generator.device)
    return _poisson(generator, rate).to(_dt(dtype))


def bernoulli(generator, p=0.5, shape=(), dtype="float32"):
    return (_rand(generator, tuple(shape)) < p).to(_dt(dtype))


def gumbel(generator, loc=0.0, scale=1.0, shape=(), dtype="float32"):
    """-log(-log(u)) for u uniform on [tiny, 1), as jax.random.gumbel."""
    dt = _dt(dtype)
    wide = _draw_dtype(dt)
    u = _rand(generator, tuple(shape), wide).clamp_min(
        torch.finfo(wide).tiny)
    return (loc + scale * -torch.log(-torch.log(u))).to(dt)


def laplace(generator, loc=0.0, scale=1.0, shape=(), dtype="float32"):
    """sign(u)·log1p(-|u|) for u uniform on (-1, 1), as
    jax.random.laplace."""
    dt = _dt(dtype)
    wide = _draw_dtype(dt)
    lo = -1.0 + torch.finfo(wide).eps / 2   # numpy's epsneg
    u = _rand(generator, tuple(shape), wide) * (1.0 - lo) + lo
    return (loc + scale * (torch.sign(u) * torch.log1p(-u.abs()))).to(dt)


def negative_binomial(generator, k=1, p=1.0, shape=(), dtype="float32"):
    """Poisson(lambda), lambda ~ Gamma(k)·(1 - p)/p."""
    a = torch.full(tuple(shape), float(k), device=generator.device)
    lam = _std_gamma(generator, a) * (1 - p) / p
    return _poisson(generator, lam).to(_dt(dtype))


# ---------------------------------------------------------------------------
# multinomial, shuffle
# ---------------------------------------------------------------------------

def _multinomial_nout(attrs):
    return 2 if attrs.get("get_prob", False) else 1


def multinomial(generator, data, shape=(), get_prob=False, dtype="int32"):
    """shape[0] category draws (one without ``shape``) from each row of
    the unnormalised probabilities ``data`` (floored at 1e-30, as the
    JAX op floors them before its log); with ``get_prob`` also the
    log-probability of each draw."""
    probs = torch.clamp_min(data.to(torch.float32), 1e-30)
    n = int(shape[0]) if shape else 1
    rows = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(rows, n, replacement=True, generator=generator)
    if data.dim() == 1:
        out = out[0]
    if not shape:
        out = out[..., 0]
    sample = out.to(_dt(dtype))
    if not get_prob:
        return sample
    logp = torch.log_softmax(torch.log(probs), dim=-1)
    if data.dim() == 1:
        return sample, logp[out]
    lp = torch.gather(logp, -1, out.reshape(data.shape[0], -1))
    return sample, lp.reshape(out.shape)


def shuffle(generator, data):
    """data with its first axis permuted."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=generator.device)
    return data[perm]


# ---------------------------------------------------------------------------
# _sample_*: per-row draws, output shape = params' shape + shape
# ---------------------------------------------------------------------------

def _multisample(generator, shape, dtype, draw, *params):
    shape = tuple(shape)
    n = params[0].numel()
    cols = [p.reshape((n,) + (1,) * len(shape)).to(torch.float32)
            for p in params]
    out = draw(generator, (n,) + shape, *cols)
    return out.reshape(tuple(params[0].shape) + shape).to(_dt(dtype))


def _nb_draw(gen, full, k, p):
    lam = _std_gamma(gen, k.expand(full).contiguous()) * (1.0 - p) / p
    return _poisson(gen, lam)


def _gnb_draw(gen, full, mu, alpha):
    lam = _std_gamma(gen, (1.0 / alpha).expand(full).contiguous()) \
        * mu * alpha
    return _poisson(gen, lam)


def sample_uniform(generator, low, high, shape=(), dtype="float32"):
    return _multisample(
        generator, shape, dtype,
        lambda g, full, lo, hi: torch.maximum(
            _rand(g, full) * (hi - lo) + lo, lo), low, high)


def sample_normal(generator, mu, sigma, shape=(), dtype="float32"):
    return _multisample(
        generator, shape, dtype,
        lambda g, full, m, sd: m + sd * torch.randn(
            full, generator=g, device=g.device), mu, sigma)


def sample_gamma(generator, alpha, beta, shape=(), dtype="float32"):
    """Gamma(alpha[i]) draws times beta[i] (beta is the scale)."""
    return _multisample(
        generator, shape, dtype,
        lambda g, full, a, b: b * _std_gamma(g, a.expand(full)
                                             .contiguous()), alpha, beta)


def sample_exponential(generator, lam, shape=(), dtype="float32"):
    return _multisample(
        generator, shape, dtype,
        lambda g, full, rate: torch.empty(full, device=g.device)
        .exponential_(1.0, generator=g) / rate, lam)


def sample_poisson(generator, lam, shape=(), dtype="float32"):
    return _multisample(
        generator, shape, dtype,
        lambda g, full, rate: _poisson(g, rate.expand(full).contiguous()),
        lam)


def sample_negative_binomial(generator, k, p, shape=(), dtype="float32"):
    """NB(k[i], p[i]) = Poisson(lambda), lambda ~ Gamma(k)·(1 - p)/p."""
    return _multisample(generator, shape, dtype, _nb_draw, k, p)


def sample_generalized_negative_binomial(generator, mu, alpha, shape=(),
                                         dtype="float32"):
    """GNB(mu[i], alpha[i]) = Poisson(lambda), lambda ~ Gamma(1/alpha)·mu·
    alpha."""
    return _multisample(generator, shape, dtype, _gnb_draw, mu, alpha)


# ---------------------------------------------------------------------------
# _random_pdf_*: densities under row-wise parameters (jax.scipy.stats)
# ---------------------------------------------------------------------------

class _XLogY(torch.autograd.Function):
    """x·log(y), 0 where x = 0; its derivative log(y) in x and x/y in y
    everywhere, as jax.scipy.special.xlogy's custom jvp."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return torch.where(x != 0, x * torch.log(y), torch.zeros_like(x))

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.log(y), g * x / y


def _xlogy(x, y):
    x, y = torch.broadcast_tensors(x, y)
    return _XLogY.apply(x, y)


def _pdf(logpdf, sample, params, is_log):
    sample = sample.to(torch.float32)
    ps = [p.to(torch.float32) for p in params]
    if ps and ps[0].dim() and ps[0].dim() < sample.dim():
        extra = sample.dim() - ps[0].dim()
        ps = [p.reshape(tuple(p.shape) + (1,) * extra) for p in ps]
    out = logpdf(sample, *ps)
    return out if is_log else torch.exp(out)


def _neg_inf(x):
    return torch.full_like(x, float("-inf"))


def _logpdf_uniform(x, lo, hi):
    scale = hi - lo
    lp = torch.neg(torch.log(scale))
    return torch.where((x > lo + scale) | (x < lo), _neg_inf(x), lp)


def _logpdf_normal(x, mu, sigma):
    s2 = sigma.square()
    log_normalizer = torch.log((2 * math.pi) * s2)
    quadratic = (x - mu).square() / s2
    return (log_normalizer + quadratic) / -2.0


def _logpdf_gamma(x, a, b):
    ok = x >= 0
    y = torch.where(ok, x / b, torch.ones_like(x))
    lp = (_xlogy(a - 1, y) - y) - (torch.lgamma(a) + torch.log(b))
    return torch.where(ok, lp, _neg_inf(lp))


def _logpdf_exponential(x, lam):
    scale = 1.0 / lam
    lp = torch.neg(x / scale + torch.log(scale))
    return torch.where(x < 0, _neg_inf(lp), lp)


def _logpmf_poisson(k, mu):
    lp = _xlogy(k, mu) - torch.lgamma(k + 1) - mu
    return torch.where((k < 0) | (torch.round(k) != k), _neg_inf(lp), lp)


def _logpmf_negative_binomial(k, n, p):
    comb = torch.lgamma(k + n) - torch.lgamma(n) - torch.lgamma(k + 1)
    lp = comb + (_xlogy(n, p) + _xlogy(k, 1 - p))
    return torch.where(k < 0, _neg_inf(lp), lp)


def pdf_uniform(sample, low, high, is_log=False):
    return _pdf(_logpdf_uniform, sample, (low, high), is_log)


def pdf_normal(sample, mu, sigma, is_log=False):
    return _pdf(_logpdf_normal, sample, (mu, sigma), is_log)


def pdf_gamma(sample, alpha, beta, is_log=False):
    return _pdf(_logpdf_gamma, sample, (alpha, beta), is_log)


def pdf_exponential(sample, lam, is_log=False):
    return _pdf(_logpdf_exponential, sample, (lam,), is_log)


def pdf_poisson(sample, lam, is_log=False):
    return _pdf(_logpmf_poisson, sample, (lam,), is_log)


def pdf_negative_binomial(sample, k, p, is_log=False):
    return _pdf(_logpmf_negative_binomial, sample, (k, p), is_log)


for _name, _aliases, _fn in (
        ("_random_uniform", ("random_uniform",), uniform),
        ("_random_normal", ("random_normal", "normal_op"), normal),
        ("_random_randint", (), randint),
        ("_random_gamma", (), gamma),
        ("_random_exponential", (), exponential),
        ("_random_poisson", (), poisson),
        ("_random_bernoulli", (), bernoulli),
        ("_random_gumbel", (), gumbel),
        ("_random_laplace", (), laplace),
        ("_random_negative_binomial", (), negative_binomial),
        ("_shuffle", ("shuffle",), shuffle),
        ("_sample_uniform", ("sample_uniform",), sample_uniform),
        ("_sample_normal", ("sample_normal",), sample_normal),
        ("_sample_gamma", ("sample_gamma",), sample_gamma),
        ("_sample_exponential", ("sample_exponential",), sample_exponential),
        ("_sample_poisson", ("sample_poisson",), sample_poisson),
        ("_sample_negative_binomial", ("sample_negative_binomial",),
         sample_negative_binomial),
        ("_sample_generalized_negative_binomial",
         ("sample_generalized_negative_binomial",),
         sample_generalized_negative_binomial)):
    register_op(_name, aliases=_aliases, differentiable=False)(_fn)
register_op("_sample_multinomial", differentiable=False,
            num_outputs=_multinomial_nout)(multinomial)
for _kind, _fn in (("uniform", pdf_uniform), ("normal", pdf_normal),
                   ("gamma", pdf_gamma), ("exponential", pdf_exponential),
                   ("poisson", pdf_poisson),
                   ("negative_binomial", pdf_negative_binomial)):
    register_op(f"_random_pdf_{_kind}", aliases=(f"random_pdf_{_kind}",))(
        _fn)
