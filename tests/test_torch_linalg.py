"""The port's linalg ops (``mxnet_tpu_torch/ops/linalg.py``: the
``linalg_*`` family, its aliases, ``khatri_rao`` and ``moments``, the 24
names that left the port's queue) against the JAX package's ops on the
same numpy inputs, forward and gradient (``jax.vjp`` of the JAX op's
function against ``torch.autograd.grad`` of the port's, one seeded
cotangent per output).

Tolerances, by the op's class:

* copies, gathers and the make/extract ops: bit for bit, forward and
  gradient;
* fp32 products (gemm, gemm2, syrk, trmm, khatri_rao) and the fp32
  reductions of ``moments``: within 2^-22 · k relative to the sum of the
  k terms' magnitudes (k the terms an output sums);
* decompositions and solves (potrf, potri, trsm, sumlogdiag, syevd,
  gelqf, inverse, det, slogdet, solve): in float64, the JAX ops under
  ``jax.enable_x64``, within 1e-10 of the output's largest magnitude.
  An eigenvector (a row of syevd's U) and an LQ pair (a column of L with
  the row of Q) are fixed up to a sign that LAPACK may choose apart, so
  syevd's U and gelqf's L and Q are held after flipping each vector to a
  positive largest entry, and their gradients through the squares of
  those outputs (which no sign flip changes).
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt  # noqa: F401 — registers the ops
from mxnet_tpu_torch.ops import registry as treg

PROD_REL = 2.0 ** -22
DECOMP_REL = 1e-10


def _rng(name):
    return np.random.RandomState(sum(map(ord, name)))


def _spd(rng, b, n, dt):
    m = rng.standard_normal((b, n, n))
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n)).astype(dt)


def _lower(rng, b, n, dt):
    m = np.tril(rng.standard_normal((b, n, n)) * 0.3)
    idx = np.arange(n)
    m[:, idx, idx] = rng.uniform(1.0, 2.0, (b, n))
    return m.astype(dt)


def _wellcond(rng, b, n, dt):
    return (rng.standard_normal((b, n, n)) + n * np.eye(n)).astype(dt)


F32, F64 = np.float32, np.float64

# name -> (inputs(rng), attrs, class, k (terms an output sums))
CASES = {
    "linalg_gemm": (lambda r: [r.standard_normal((2, 3, 5)).astype(F32),
                               r.standard_normal((2, 5, 4)).astype(F32),
                               r.standard_normal((2, 3, 4)).astype(F32)],
                    {"alpha": 0.7, "beta": -1.3}, "prod", 6),
    "linalg_gemm2": (lambda r: [r.standard_normal((2, 5, 3)).astype(F32),
                                r.standard_normal((2, 4, 5)).astype(F32)],
                     {"transpose_a": True, "transpose_b": True,
                      "alpha": 1.5}, "prod", 5),
    "linalg_syrk": (lambda r: [r.standard_normal((2, 3, 6)).astype(F32)],
                    {"alpha": 0.5}, "prod", 6),
    "linalg_trmm": (lambda r: [r.standard_normal((2, 4, 4)).astype(F32),
                               r.standard_normal((2, 4, 3)).astype(F32)],
                    {"lower": False, "transpose": True, "alpha": 2.0},
                    "prod", 4),
    "khatri_rao": (lambda r: [r.standard_normal((2, 3)).astype(F32),
                              r.standard_normal((4, 3)).astype(F32),
                              r.standard_normal((3, 3)).astype(F32)],
                   {}, "prod", 1),
    "moments": (lambda r: [r.standard_normal((4, 5, 6)).astype(F32)],
                {"axes": (0, 2)}, "prod", 24),
    "linalg_extractdiag": (lambda r: [r.standard_normal((2, 5, 5))
                                      .astype(F32)], {"offset": 1},
                           "exact", 1),
    "linalg_makediag": (lambda r: [r.standard_normal((2, 4)).astype(F32)],
                        {"offset": -1}, "exact", 1),
    "linalg_extracttrian": (lambda r: [r.standard_normal((2, 4, 4))
                                       .astype(F32)],
                            {"offset": 0, "lower": False}, "exact", 1),
    "linalg_maketrian": (lambda r: [r.standard_normal((2, 10)).astype(F32)],
                         {"lower": True}, "exact", 1),
    "linalg_potrf": (lambda r: [_spd(r, 2, 5, F64)], {}, "decomp", 1),
    "linalg_potri": (lambda r: [_lower(r, 2, 5, F64)], {}, "decomp", 1),
    "linalg_trsm": (lambda r: [_lower(r, 2, 4, F64),
                               r.standard_normal((2, 3, 4))],
                    {"rightside": True, "transpose": True, "alpha": 0.5},
                    "decomp", 1),
    "linalg_sumlogdiag": (lambda r: [_lower(r, 2, 5, F64)], {}, "decomp",
                          1),
    "linalg_syevd": (lambda r: [_spd(r, 2, 5, F64)], {}, "decomp", 1),
    "linalg_gelqf": (lambda r: [r.standard_normal((2, 3, 5))], {},
                     "decomp", 1),
}
for _n in ("linalg_inverse", "inverse", "linalg_det", "det",
           "linalg_slogdet", "slogdet"):
    CASES[_n] = (lambda r: [_wellcond(r, 2, 4, F64)], {}, "decomp", 1)
for _n in ("linalg_solve", "solve"):
    CASES[_n] = (lambda r: [_wellcond(r, 2, 4, F64),
                            r.standard_normal((2, 4, 3))], {}, "decomp", 1)

# outputs whose vectors carry a free sign: (output index, axis of a vector)
SIGNED = {"linalg_syevd": {0: -1}, "linalg_gelqf": {0: -2, 1: -1}}


def test_the_slice_names_all_24():
    assert len(CASES) == 24
    assert set(CASES) <= set(treg.list_ops())
    assert all(treg.get_op(n).name in CASES for n in CASES)


def _square_signed(name, outs):
    """The outputs whose sign is free, squared (the sign-free function
    the gradient is taken through)."""
    return [o * o if i in SIGNED.get(name, {}) else o
            for i, o in enumerate(outs)]


def _jax(name, arrays, attrs, cts):
    fn = jreg.get_op(name).fn

    def f(*xs):
        out = fn(*xs, **attrs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return tuple(_square_signed(name, outs))

    xs = [jax.numpy.asarray(a) for a in arrays]
    raw = fn(*xs, **attrs)
    raw = list(raw) if isinstance(raw, (tuple, list)) else [raw]
    _, vjp = jax.vjp(f, *xs)
    grads = vjp(tuple(jax.numpy.asarray(c) for c in cts))
    return [np.asarray(o) for o in raw], [np.asarray(g) for g in grads]


def _port(name, arrays, attrs, cts):
    fn = treg.get_op(name).fn
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    raw = fn(*xs, **attrs)
    raw = list(raw) if isinstance(raw, (tuple, list)) else [raw]
    outs = _square_signed(name, raw)
    grads = torch.autograd.grad(outs, xs, [torch.from_numpy(c)
                                           for c in cts])
    return [o.detach().numpy() for o in raw], [g.numpy() for g in grads]


def _canon(a, axis):
    """Each vector along ``axis`` flipped to a positive largest-magnitude
    entry."""
    idx = np.argmax(np.abs(a), axis=axis)
    big = np.take_along_axis(a, np.expand_dims(idx, axis), axis)
    return a * np.sign(big)


def _hold(cls, got, want, bound=None):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if cls == "exact":
        np.testing.assert_array_equal(got, want)
    elif cls == "decomp":
        scale = max(float(np.max(np.abs(want))), 1e-300)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=DECOMP_REL * scale)
    else:
        assert np.all(np.abs(got.astype(F64) - want) <= bound), \
            float(np.max(np.abs(got.astype(F64) - want) - bound))


def _prod_bounds(name, arrays, attrs, k):
    """2^-22 · k · (the op on the inputs' magnitudes) for the products;
    for moments the mean's and the variance's term magnitudes."""
    if name == "moments":
        x = arrays[0].astype(F64)
        axes = attrs["axes"]
        mean = x.mean(axis=axes, keepdims=True)
        return [PROD_REL * k * np.abs(x).mean(axis=axes),
                PROD_REL * k * ((x - mean) ** 2 + np.abs(x - mean)
                                * np.abs(mean)).mean(axis=axes) + 1e-30]
    fn = treg.get_op(name).fn
    ab = [torch.from_numpy(np.abs(a).astype(F64)) for a in arrays]
    kw = {k_: (abs(v) if isinstance(v, float) else v)
          for k_, v in attrs.items()}
    mag = fn(*ab, **kw)
    mag = list(mag) if isinstance(mag, (tuple, list)) else [mag]
    return [PROD_REL * k * m.numpy() + 1e-30 for m in mag]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_gradient_match_jax(name):
    make, attrs, cls, k = CASES[name]
    rng = _rng(name)
    arrays = make(rng)
    with jax.enable_x64(cls == "decomp"):
        fn = jreg.get_op(name).fn
        raw = fn(*[jax.numpy.asarray(a) for a in arrays], **attrs)
        raw = list(raw) if isinstance(raw, (tuple, list)) else [raw]
        cts = [rng.standard_normal(np.shape(o)).astype(np.asarray(o).dtype)
               for o in raw]
        jout, jgrad = _jax(name, arrays, attrs, cts)
    tout, tgrad = _port(name, arrays, attrs, cts)
    bounds = _prod_bounds(name, arrays, attrs, k) \
        if cls == "prod" else [None] * len(tout)
    for i, (g, w, b) in enumerate(zip(tout, jout, bounds)):
        if i in SIGNED.get(name, {}):
            g, w = _canon(g, SIGNED[name][i]), _canon(w, SIGNED[name][i])
        _hold(cls, g, w, b)
    for g, w, a in zip(tgrad, jgrad, arrays):
        if cls == "prod":
            # the cotangent's products: k terms of |ct| times magnitudes
            b = PROD_REL * (k + 4) * (np.abs(w) + np.max(np.abs(w))) + 1e-30
            _hold("prod", g, w, b)
        else:
            _hold(cls, g, w)


def test_moments_keepdims_and_bf16():
    """keepdims, no axes, and bf16 data reduced in float32 and rounded
    back: the same bits as the JAX op (a mean and a variance over 16
    values, each one rounding to bf16 of sums that float32 holds
    within 2^-20)."""
    x = _rng("bf16").standard_normal((4, 4)).astype(F32)
    for attrs in ({"axes": (1,), "keepdims": True}, {}):
        jm, jv = jreg.invoke("moments", mx.nd.array(x),
                             **attrs)
        tm, tv = treg.invoke("moments", mt.nd.array(x, ctx=mt.cpu()),
                             **attrs)
        assert tm.shape == jm.shape and tv.shape == jv.shape
        np.testing.assert_allclose(tm.asnumpy(), jm.asnumpy(),
                                   rtol=PROD_REL * 16, atol=1e-7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    m, v = treg.get_op("moments").fn(xb, axes=(0, 1))
    assert m.dtype == v.dtype == torch.bfloat16
    xf = xb.float().double()
    assert float(m) == float(torch.tensor(float(xf.mean())).to(
        torch.bfloat16))
    assert float(v) == float(torch.tensor(float(((xf - float(
        torch.tensor(float(xf.mean())).float())) ** 2).mean())).to(
            torch.bfloat16))


def test_syevd_rows_are_eigenvectors_and_gelqf_is_lq():
    """The conventions the sign-free checks cannot see: A = Uᵀ diag(λ) U
    with U's rows the eigenvectors, and A = L Q with L lower triangular
    and Q's rows orthonormal."""
    rng = _rng("conv")
    a = torch.from_numpy(_spd(rng, 1, 6, F64))
    u, w = treg.get_op("linalg_syevd").fn(a)
    rec = u.transpose(-1, -2) @ torch.diag_embed(w) @ u
    assert torch.allclose(rec, a, atol=1e-10 * float(a.abs().max()))
    m = torch.from_numpy(rng.standard_normal((2, 3, 7)))
    lo, q = treg.get_op("linalg_gelqf").fn(m)
    assert torch.equal(lo, torch.tril(lo))
    assert torch.allclose(q @ q.transpose(-1, -2),
                          torch.eye(3, dtype=torch.float64), atol=1e-12)
    assert torch.allclose(lo @ q, m, atol=1e-12)
