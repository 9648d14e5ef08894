"""One op through the JAX package and the port on the CPU, on the inputs
of its case in ``mxnet_tpu_torch.tools.op_sweep``: the forward (values,
dtype, shape) and the gradient of every float input under a seeded
cotangent.  Shared by the parity tests of the tensor, nn and random ops.

Tolerances, by the case's class:

* ``exact``: the same bits and dtype (a backward that sums repeated
  indices is held as ``sum``);
* ``ulp``: the forward within ``FWD_ULPS`` ulps of the JAX value, the
  gradient within ``BWD_ULPS`` (PyTorch and XLA differ in the last bits
  of a transcendental and of a derivative's product), the ulp taken at
  no less than 2^-10 of the output's largest magnitude;
* ``sum``: within 2^-24 · n · S plus one rounding, S the terms'
  magnitudes (``op_sweep.sum_bound``);
* the lgamma family (``LGAMMA``): XLA's lgamma and digamma on the CPU
  are accurate to about 1e-6 absolute (139 and 1253 ulps of a value near
  their roots against float64 truth, where torch's lgamma is within an
  ulp), so these ops are held within 2^-16 · (1 + |want|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.tools import op_sweep

CPU = mt.cpu()
FWD_ULPS = 4
BWD_ULPS = op_sweep.ULP_BOUND
LGAMMA = {"gammaln", "gamma", "digamma"}


def cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(o.shape).astype(np.float32)
            if np.asarray(o).dtype.kind == "f" else None for o in outs]


def jax_run(name, arrays, attrs, cts=None):
    """The JAX op through ``registry.invoke`` on NDArrays, and the
    gradient of each float input by jax.vjp of the op's function (jitted,
    as ``invoke`` runs the forward)."""
    op = jreg.get_op(name)
    ins = [None if a is None else mx.nd.array(a, dtype=a.dtype)
           for a in arrays]
    out = jreg.invoke(name, *ins, **attrs)
    outs = [o.asnumpy() for o in (out if isinstance(out, (list, tuple))
                                  else [out])]
    fl = [i for i, a in enumerate(arrays)
          if a is not None and a.dtype.kind == "f"]
    if cts is None or not op.differentiable or not fl:
        return outs, []

    def f(*xs):
        full = [None if a is None else jnp.asarray(a) for a in arrays]
        for i, x in zip(fl, xs):
            full[i] = x
        r = op.fn(*full, **attrs)
        return tuple(r) if isinstance(r, (list, tuple)) else (r,)

    def grads(xs, ct):
        prim, vjp = jax.vjp(f, *xs)
        return vjp(tuple(c if c is not None else jnp.zeros(p.shape, p.dtype)
                         for c, p in zip(ct, prim)))

    xs = [jnp.asarray(arrays[i]) for i in fl]
    ct = [None if c is None else jnp.asarray(c, o.dtype)
          for c, o in zip(cts, outs)]
    return outs, [np.asarray(g) for g in jax.jit(grads)(xs, ct)]


def port_run(name, arrays, attrs, cts=None):
    """The port's op through its ``registry.invoke`` on CPU NDArrays, and
    the gradient of each float input by torch.autograd."""
    op = treg.get_op(name)
    ins = [None if a is None else mt.nd.array(a, ctx=CPU, dtype=a.dtype)
           for a in arrays]
    out = treg.invoke(name, *ins, **attrs)
    outs = [o.asnumpy() for o in (out if isinstance(out, list) else [out])]
    if cts is None or not op.differentiable:
        return outs, []
    tcts = [None if c is None else torch.from_numpy(c) for c in cts]
    _, grads = op_sweep._run(op.fn, arrays, attrs, "cpu", True, tcts)
    return outs, [g.numpy() for g in grads]


def hold_array(kind, got, want, n=1, terms=None, ulps=FWD_ULPS, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if kind == "exact":
        np.testing.assert_array_equal(got, want, err_msg=what)
        if got.dtype.kind == "f":
            assert (np.signbit(got) == np.signbit(want)).all(), what
    elif kind == "ulp":
        u = op_sweep.ulps(got, want)
        assert u <= ulps, f"{what}: {u} ulps > {ulps}"
    elif kind == "lgamma":
        g, w = got.astype(np.float64), want.astype(np.float64)
        np.testing.assert_allclose(g, w, rtol=2.0 ** -16, atol=2.0 ** -16,
                                   err_msg=what)
    else:
        g, w = got.astype(np.float64), want.astype(np.float64)
        bound = op_sweep.sum_bound(want, n, terms)
        err = np.where((g == w) | (np.isnan(g) & np.isnan(w)), 0.0,
                       np.abs(g - w))
        assert (err <= bound).all(), \
            f"{what}: {np.nanmax(err / bound):.3g} of the bound"


def hold_case(name, seed=0):
    """The op's case through both packages, held by its class."""
    case = op_sweep.CASES[name]
    arrays = op_sweep.case_inputs(name, seed)
    op = treg.get_op(name)
    grad = op.differentiable
    t_outs, _ = port_run(name, arrays, case.attrs)
    cts = cotangents(t_outs) if grad else None
    j_outs, j_grads = jax_run(name, arrays, case.attrs, cts)
    t_outs, t_grads = port_run(name, arrays, case.attrs, cts)
    assert len(t_outs) == len(j_outs), name
    terms = op_sweep._terms(op.fn, arrays, case.attrs) if case.terms \
        else [None] * len(j_outs)
    kind = "lgamma" if name in LGAMMA else case.kind
    for i, (t, j, s) in enumerate(zip(t_outs, j_outs, terms)):
        hold_array(kind, t, j, case.n, None if s is None else s.numpy(),
                   what=f"{name} output {i}")
    assert len(t_grads) == len(j_grads), name
    bkind = "lgamma" if name in LGAMMA else (case.bwd or case.kind)
    for i, (t, j) in enumerate(zip(t_grads, j_grads)):
        if j.dtype == jax.dtypes.float0:
            continue
        hold_array(bkind, t, j.astype(t.dtype), case.n, ulps=BWD_ULPS,
                   what=f"{name} gradient {i}")


# ---------------------------------------------------------------------------
# the recurrent path (RNN, CTCLoss, gluon.rnn, the legacy cells,
# BucketingModule, contrib.amp)
# ---------------------------------------------------------------------------

# fp32, elementwise: a forward within RNN_FWD * (1 + |want|) over up to 16
# steps, a gradient (summed over steps and the batch) within
# RNN_BWD * (1 + |want|).  bf16: within RNN_BF16_ULPS ulps of bf16 at the
# tensor's largest magnitude (2^-8 of it an ulp): each package rounds every
# op's result to bf16 alike, but the recursion carries a difference of one
# rounding from step to step.
RNN_FWD = 1e-5
RNN_BWD = 1e-4
RNN_BF16_ULPS = 4


def hold_close(got, want, tol, what=""):
    """|got - want| <= tol * (1 + |want|) elementwise, shapes equal."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max(initial=0.0) <= tol, \
        f"{what}: {err.max():.3g} > {tol:g} of (1 + |want|)"


def hold_bf16(got, want, ulps=RNN_BF16_ULPS, what=""):
    """bf16 results within ``ulps`` bf16 ulps of the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ulp = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= ulps * ulp, f"{what}: {err / ulp:.2f} > {ulps} bf16 ulps"
