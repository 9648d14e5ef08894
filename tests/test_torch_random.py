"""The port's random ops and ``nd.random``/``mx.random`` against the JAX
package on the CPU.

The streams differ (threefry in JAX, the generator of the draw's device
here), so draws are held by distribution: for each ``_random_*`` and
``_sample_*`` op, 20,000 port draws against 20,000 JAX draws with a
two-sample Kolmogorov-Smirnov test (p > 1e-3, fixed seeds), and their
mean and variance within 6 standard errors of the analytic values (the
variance's standard error from the sample's fourth central moment).
Output dtypes and shapes match the JAX op's.  ``_shuffle`` permutes;
``_sample_multinomial``'s ``get_prob`` is the log of the chosen
probability.  The ``_random_pdf_*`` ops are deterministic: each is held
against the JAX op with its gradients, elementwise and with row-wise
parameters (``torch_parity``'s ``sum`` bound, n = 32 for the
log-density's terms; the lgamma family within 2^-16 of XLA's).
The front end: every ``nd.random`` sampler with ``shape``, ``dtype``,
``ctx`` and ``out``, the draw on the device of ``ctx`` from its
generator, the same seed giving the same draws, and a missing ``ctx``
raising without CUDA as every entry point of the port does.
"""
import math

import jax
import numpy as np
import pytest
import scipy.stats
import torch

from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

import torch_parity as tp

CPU = tp.CPU
N = 20000
EULER = 0.5772156649015329

# name: attrs, analytic (mean, variance)
DRAWS = {
    "_random_uniform": ({"low": -1.0, "high": 3.0}, (1.0, 16 / 12)),
    "_random_normal": ({"loc": 0.5, "scale": 2.0}, (0.5, 4.0)),
    "_random_randint": ({"low": -3, "high": 7}, (1.5, 8.25)),
    "_random_gamma": ({"alpha": 2.5, "beta": 0.7}, (1.75, 1.225)),
    "_random_exponential": ({"lam": 2.0}, (0.5, 0.25)),
    "_random_poisson": ({"lam": 3.5}, (3.5, 3.5)),
    "_random_bernoulli": ({"p": 0.3}, (0.3, 0.21)),
    "_random_gumbel": ({"loc": 0.5, "scale": 2.0},
                       (0.5 + 2 * EULER, math.pi ** 2 / 6 * 4)),
    "_random_laplace": ({"loc": -0.5, "scale": 1.5}, (-0.5, 4.5)),
    "_random_negative_binomial": ({"k": 3, "p": 0.4}, (4.5, 11.25)),
}
# name: parameter arrays (two rows), analytic (mean, variance) per row
SAMPLES = {
    "_sample_uniform": ([[-1.0, 2.0], [3.0, 2.5]],
                        [(1.0, 16 / 12), (2.25, 0.25 / 12)]),
    "_sample_normal": ([[0.0, -3.0], [1.0, 0.5]],
                       [(0.0, 1.0), (-3.0, 0.25)]),
    "_sample_gamma": ([[1.5, 4.0], [2.0, 0.5]],
                      [(3.0, 6.0), (2.0, 1.0)]),
    "_sample_exponential": ([[0.5, 4.0]], [(2.0, 4.0), (0.25, 0.0625)]),
    "_sample_poisson": ([[1.5, 9.0]], [(1.5, 1.5), (9.0, 9.0)]),
    "_sample_negative_binomial": ([[2.0, 5.0], [0.5, 0.25]],
                                  [(2.0, 4.0), (15.0, 60.0)]),
    "_sample_generalized_negative_binomial": (
        [[2.0, 4.0], [0.5, 0.25]], [(2.0, 4.0), (4.0, 8.0)]),
}


def _moments_within(x, mean, var, what):
    x = np.asarray(x, np.float64).ravel()
    m, v = x.mean(), x.var()
    m4 = ((x - m) ** 4).mean()
    se_m = math.sqrt(var / x.size)
    se_v = math.sqrt(max(m4 - v * v, 1e-300) / x.size)
    assert abs(m - mean) <= 6 * se_m, (what, m, mean, se_m)
    assert abs(v - var) <= 6 * se_v, (what, v, var, se_v)


def _ks(a, b, what):
    p = scipy.stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > 1e-3, (what, p)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draws_match_the_jax_distribution(name):
    attrs, (mean, var) = DRAWS[name]
    port = treg.invoke(name, _gen(17), shape=(N,), **attrs).asnumpy()
    want = np.asarray(jreg.get_op(name).fn(jax.random.PRNGKey(17),
                                           shape=(N,), **attrs))
    assert port.dtype == want.dtype and port.shape == want.shape
    _ks(port, want, name)
    _moments_within(port, mean, var, name)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_per_row_draws_match_the_jax_distribution(name):
    params, moments = SAMPLES[name]
    params = [np.asarray(p, np.float32) for p in params]
    port = treg.invoke(name, _gen(23), *[mt.nd.array(p, ctx=CPU)
                                         for p in params],
                       shape=(N // 2,)).asnumpy()
    want = np.asarray(jreg.get_op(name).fn(jax.random.PRNGKey(23),
                                           *params, shape=(N // 2,)))
    assert port.dtype == want.dtype and port.shape == want.shape == (
        2, N // 2)
    for row, (mean, var) in enumerate(moments):
        _ks(port[row], want[row], f"{name} row {row}")
        _moments_within(port[row], mean, var, f"{name} row {row}")


def test_multinomial_matches_the_jax_distribution_and_its_log_probs():
    probs = np.array([[0.1, 0.6, 0.3], [2.0, 1.0, 1.0]], np.float32)
    data = mt.nd.array(probs, ctx=CPU)
    draw, logp = treg.invoke("_sample_multinomial", _gen(5), data,
                             shape=(N // 2,), get_prob=True)
    jdraw, jlogp = jreg.get_op("_sample_multinomial").fn(
        jax.random.PRNGKey(5), probs, shape=(N // 2,), get_prob=True)
    draw, logp = draw.asnumpy(), logp.asnumpy()
    assert draw.dtype == np.asarray(jdraw).dtype == np.int32
    assert draw.shape == np.asarray(jdraw).shape == (2, N // 2)
    assert logp.dtype == np.asarray(jlogp).dtype
    norm = probs / probs.sum(-1, keepdims=True)
    for row in range(2):
        counts = np.bincount(draw[row], minlength=3)
        jcounts = np.bincount(np.asarray(jdraw)[row], minlength=3)
        p = scipy.stats.chi2_contingency([counts, jcounts]).pvalue
        assert p > 1e-3, (row, counts, jcounts)
        np.testing.assert_allclose(logp[row], np.log(norm[row][draw[row]]),
                                   rtol=1e-6)
    for shape, want in (((), (2,)), ((4,), (2, 4))):
        out = treg.invoke("_sample_multinomial", _gen(1), data,
                          shape=shape)
        jout = jreg.get_op("_sample_multinomial").fn(
            jax.random.PRNGKey(1), probs, shape=shape)
        assert out.shape == np.asarray(jout).shape == want
    one = treg.invoke("_sample_multinomial", _gen(1),
                      mt.nd.array(probs[0], ctx=CPU))
    assert one.shape == np.asarray(jreg.get_op("_sample_multinomial").fn(
        jax.random.PRNGKey(1), probs[0])).shape == ()


def test_shuffle_permutes_the_first_axis():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    out = treg.invoke("_shuffle", _gen(3), mt.nd.array(x, ctx=CPU))
    got = out.asnumpy()
    assert got.shape == x.shape and not np.array_equal(got, x)
    np.testing.assert_array_equal(np.sort(got[:, 0]), x[:, 0])
    np.testing.assert_array_equal(got[:, 1:] - got[:, :1],
                                  x[:, 1:] - x[:, :1])
    assert treg.get_op("shuffle") is treg.get_op("_shuffle")


PDF = ("uniform normal gamma exponential poisson negative_binomial").split()


@pytest.mark.parametrize("name", [f"{p}random_pdf_{k}" for k in PDF
                                  for p in ("_", "")])
def test_pdf_matches_jax(name):
    tp.hold_case(name)


PER_ROW = {
    "uniform": ([(-1.0, 3.0), (0.0, 0.5)], (-1.5, 3.5)),
    "normal": ([(0.5, -1.0), (2.0, 0.7)], (-3.0, 3.0)),
    "gamma": ([(2.5, 0.8), (0.7, 1.5)], (0.05, 5.0)),
    "exponential": ([(2.0, 0.5)], (-0.5, 6.0)),
    "poisson": ([(3.5, 0.8)], None),
    "negative_binomial": ([(3.0, 1.5), (0.4, 0.7)], None),
}


@pytest.mark.parametrize("is_log", [False, True])
@pytest.mark.parametrize("kind", PDF)
def test_pdf_with_row_wise_parameters(kind, is_log):
    """Parameters of shape (2,) for samples (2, 6): each row's density
    under its own parameters, and their gradients (sums over a row)."""
    params, span = PER_ROW[kind]
    rs = np.random.RandomState(len(kind))
    sample = (rs.uniform(*span, (2, 6)) if span else
              np.concatenate([rs.randint(0, 9, (2, 5)),
                              np.array([[-1], [2.5]])], 1)).astype(np.float32)
    arrays = [sample] + [np.asarray(p, np.float32) for p in params]
    name = f"_random_pdf_{kind}"
    attrs = {"is_log": is_log}
    t_outs, _ = tp.port_run(name, arrays, attrs)
    cts = tp.cotangents(t_outs)
    (j,), j_grads = tp.jax_run(name, arrays, attrs, cts)
    (t,), t_grads = tp.port_run(name, arrays, attrs, cts)
    lg = kind in ("gamma", "poisson", "negative_binomial")
    tp.hold_array("lgamma" if lg else "sum", t, j, n=32, what=name)
    for g, jg in zip(t_grads, j_grads):
        tp.hold_array("lgamma" if lg else "sum", g, jg, n=32 * 6,
                      what=f"{name} gradient")


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------

FRONT = [
    ("uniform", {"low": -1.0, "high": 2.0}, np.float32),
    ("normal", {"loc": 1.0, "scale": 0.5}, np.float32),
    ("randint", {"low": 0, "high": 9}, np.int32),
    ("gamma", {"alpha": 2.0, "beta": 1.5}, np.float32),
    ("exponential", {"scale": 2.0}, np.float32),
    ("poisson", {"lam": 4.0}, np.float32),
    ("negative_binomial", {"k": 2, "p": 0.5}, np.float32),
    ("gumbel", {"loc": 0.0, "scale": 1.0}, np.float32),
    ("laplace", {"loc": 0.0, "scale": 1.0}, np.float32),
    ("bernoulli", {"p": 0.25}, np.float32),
]


@pytest.mark.parametrize("fn,kw,dtype", FRONT, ids=[f[0] for f in FRONT])
def test_nd_random_sampler(fn, kw, dtype):
    mt.random.seed(11)
    a = getattr(mt.nd.random, fn)(shape=(3, 5), ctx=CPU, **kw)
    mt.random.seed(11)
    b = getattr(mt.nd.random, fn)(shape=(3, 5), ctx=CPU, **kw)
    assert a.shape == (3, 5) and a.ctx == CPU and a.dtype == dtype
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert getattr(mt.nd.random, fn)(shape=4, ctx=CPU, **kw).shape == (4,)
    assert getattr(mt.nd.random, fn)(ctx=CPU, **kw).shape == (1,)
    out = mt.nd.zeros((2, 2), ctx=CPU, dtype="float64" if dtype ==
                      np.float32 else "int32")
    res = getattr(mt.nd.random, fn)(out=out, **kw)
    assert res is out and out.dtype == (np.float64 if dtype == np.float32
                                        else np.int32)
    with pytest.raises(MXNetError, match="out shape"):
        getattr(mt.nd.random, fn)(shape=(3,), out=out, **kw)
    with pytest.raises(MXNetError, match="out dtype"):
        getattr(mt.nd.random, fn)(dtype="float16", out=out, **kw)


def test_draws_land_on_ctx_and_come_from_its_generator():
    mt.random.seed(4)
    a = mt.nd.random.normal(shape=(6,), ctx=CPU).asnumpy()
    g = mt.random.generator(CPU)
    mt.random.seed(4)  # reseeds g in place
    b = treg.invoke("_random_normal", g, shape=(6,)).asnumpy()
    np.testing.assert_array_equal(a, b)
    x = mt.nd.random.randn(2, 3, ctx=CPU)
    assert x.shape == (2, 3) and x.dtype == np.float32


def test_mx_random_samplers():
    mt.random.seed(2)
    u = mt.random.uniform(0, 1, shape=(100,), ctx=CPU).asnumpy()
    assert ((u >= 0) & (u < 1)).all()
    assert mt.random.normal(shape=(2, 2), ctx=CPU).shape == (2, 2)
    r = mt.random.randint(2, 5, shape=(50,), ctx=CPU)
    assert r.dtype == np.int32 and set(r.asnumpy().tolist()) <= {2, 3, 4}
    out = mt.nd.zeros((3,), ctx=CPU, dtype="int64")
    assert mt.random.randint(0, 3, out=out).dtype == np.int64


def test_multinomial_and_shuffle_front_end():
    data = mt.nd.array([[0.2, 0.8], [1.0, 0.0]], ctx=CPU)
    draw, lp = mt.nd.random.multinomial(data, shape=5, get_prob=True)
    assert draw.shape == lp.shape == (2, 5)
    assert (draw.asnumpy()[1] == 0).all()
    x = mt.nd.arange(6, ctx=CPU)
    assert sorted(mt.nd.random.shuffle(x).asnumpy().tolist()) == \
        list(range(6))


def test_a_draw_without_ctx_needs_cuda(monkeypatch):
    """With no ctx the draw lands on the default context, gpu(0), which
    does not exist without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.random.uniform(shape=(2,))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.random.normal(shape=(2,))
