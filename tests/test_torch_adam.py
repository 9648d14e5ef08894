"""mxnet_tpu_torch's Adam against the JAX package's, in its three places.

* The update ops ``adam_update`` and ``mp_adam_update`` on the same
  weights, gradients and moments (numpy seed), eagerly and under
  ``jax.jit``: bf16 bit for bit (every scalar weak against bf16, so
  ``0.999 * v`` rounds back to v on both sides); fp32 within 2 ulps of
  each output's largest element (XLA's jitted program contracts and
  reorders the sums, which then round apart where they cancel).
* The eager ``Adam`` over 3 steps (the bias correction folded into lr on
  the host), plain and under ``multi_precision``: bf16 bit for bit, fp32
  within 4 ulps of each tensor's largest element.
* The functional form, one ``apply`` per step at t = 1, 2, 3 (the fp32
  device coefficient, lr 1.0 then the fp32 rescale), plain and on the
  fp32 master of a bf16 weight, against the JAX form run op by op: bf16
  bit for bit, fp32 within 4 ulps of the largest element; and against
  it under ``jax.jit``: bf16 within 1 bf16 ulp of each element plus, a
  step, lr times 1 bf16 ulp of max |w'| (XLA keeps w' in fp32 inside its
  fusion where the ops round it to bf16; 1.4% of the weights land
  apart), fp32 as before.  Then 3 ``SPMDTrainer`` steps
  of a small MLP against the JAX ``SPMDTrainer`` (fp32: losses 1e-6
  relative, parameters and moments 1e-5 relative, atol 1e-6 of each
  tensor's largest element).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import optimizer_ops as jops
from mxnet_tpu.optimizer import optimizer as jopt

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn

N = 4099   # off every power of two
OPT = dict(learning_rate=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8,
           wd=1e-2, clip_gradient=0.15)
OPS_KW = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=1e-2,
              clip_gradient=0.15)


def _np_dtype(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _values(seed, dtype):
    """weight, gradient, mean, var: gradients straddle the clip bound,
    var is positive."""
    rs = np.random.RandomState(seed)
    dt = _np_dtype(dtype)
    w = rs.randn(N).astype(np.float32)
    g = (0.1 * rs.randn(N)).astype(np.float32)
    m = (0.01 * rs.randn(N)).astype(np.float32)
    v = (1e-3 * np.abs(rs.randn(N))).astype(np.float32)
    return w.astype(dt), g.astype(dt), m.astype(dt), v.astype(dt)


def _ulps(a, b):
    """max |a - b| in fp32 ulps (2^-23) of max |b|: the sums of the update
    cancel (w - step, beta1*m + (1-beta1)*g), so an element's own ulp
    would measure the cancellation, not the rounding."""
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    return float(np.abs(a - b).max() / (2.0 ** -23 * np.abs(b).max()))


def _hold(got, want, dtype, ulps=2):
    """bf16 bit for bit; fp32 within `ulps` of `want`."""
    assert got.dtype == {"bfloat16": torch.bfloat16,
                         "float32": torch.float32}[str(want.dtype)]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        assert _ulps(got, want) <= ulps


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_update_matches_jax(dtype, jit):
    w, g, m, v = _values(0, dtype)
    kw = dict(OPS_KW, lr=1.0)

    def run(*a):
        return jops._adam_update(*a, **kw)
    want = (jax.jit(run) if jit else run)(*map(jnp.asarray, (w, g, m, v)))
    got = tops.adam_update(*map(_t, (w, g, m, v)), **kw)
    for x, y in zip(got, want):
        _hold(x, y, dtype)
    # the bf16 trap the port keeps: 0.999 rounds to 1.0 in bf16
    if dtype == "bfloat16":
        zero_g = tops.adam_update(_t(w), torch.zeros(N, dtype=torch.bfloat16),
                                  _t(m), _t(v), lr=1.0, beta1=0.9,
                                  beta2=0.999)[2]
        assert torch.equal(zero_g, _t(v))


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mp_adam_update_matches_jax(dtype, jit):
    w, g, _, _ = _values(1, dtype)
    _, _, m, v = _values(2, "float32")
    w32 = _f32(w) + np.float32(1e-4)  # a master copy off the half weight
    kw = dict(OPS_KW, lr=0.01)

    def run(*a):
        return jops._mp_adam_update(*a, **kw)
    want = (jax.jit(run) if jit else run)(*map(jnp.asarray,
                                                (w, g, m, v, w32)))
    got = tops.mp_adam_update(*map(_t, (w, g, m, v, w32)), **kw)
    assert got[0].dtype == _t(w).dtype
    assert all(x.dtype == torch.float32 for x in got[1:])
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got[0]), _f32(want[0]))
    for x, y in zip(got[1:], want[1:]):
        assert _ulps(x, y) <= 2


def _jax_nd(a):
    return mx.nd.array(np.asarray(a), dtype=str(np.asarray(a).dtype))


# multi_precision acts on half weights only
CASES = [("float32", False), ("bfloat16", False), ("bfloat16", True)]
CASE_IDS = ["fp32", "bf16", "bf16-mp"]


@pytest.mark.parametrize("dtype,multi_precision", CASES, ids=CASE_IDS)
def test_eager_adam_three_steps_match_jax(dtype, multi_precision):
    w, _, _, _ = _values(3, dtype)
    rs = np.random.RandomState(4)
    grads = [(0.1 * rs.randn(N)).astype(_np_dtype(dtype)) for _ in range(3)]
    jo = jopt.Adam(multi_precision=multi_precision, **OPT)
    to = topt.Adam(multi_precision=multi_precision, **OPT)
    jw, tw = _jax_nd(w), mt.nd.array(_t(w), ctx=mt.cpu())
    js = jo.create_state_multi_precision(0, jw)
    ts = to.create_state_multi_precision(0, tw)
    for g in grads:
        jo.update_multi_precision(0, jw, _jax_nd(g), js)
        to.update_multi_precision(0, tw, mt.nd.array(_t(g), ctx=mt.cpu()),
                                  ts)
    assert to._index_update_count[0] == 3
    jflat = [jw] + list(js[0] if multi_precision else js) + \
        ([js[1]] if multi_precision else [])
    tflat = [tw] + list(ts[0] if multi_precision else ts) + \
        ([ts[1]] if multi_precision else [])
    for x, y in zip(tflat, jflat):
        got, want = x._data, y.asnumpy()
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_f32(got), _f32(want))
        else:
            assert _ulps(got, want) <= 4


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("dtype,master", CASES, ids=CASE_IDS)
def test_functional_adam_matches_jax(dtype, master, jit):
    """One apply per step at t = 1, 2, 3, as SPMDTrainer's _apply_one
    runs it (the master path: the fp32 master as w, the half
    gradient)."""
    w, _, _, _ = _values(5, dtype)
    rs = np.random.RandomState(6)
    grads = [(0.1 * rs.randn(N)).astype(_np_dtype(dtype)) for _ in range(3)]
    jfo = jpar.functional_optimizer(jopt.Adam(multi_precision=master, **OPT))
    tfo = tpar.functional_optimizer(topt.Adam(multi_precision=master, **OPT))
    jw, tw = jnp.asarray(w), _t(w)
    assert tfo.needs_master(tw) == master
    js, ts = jfo.init(jw), tfo.init(tw)

    def jstep(w_, g, state, lr, t):
        if master:
            nw32, ns = jfo.apply(state[-1], g, state[:-1], lr, t)
            return nw32.astype(w_.dtype), ns + (nw32,)
        nw, ns = jfo.apply(w_, g, state, lr, t)
        return nw.astype(w_.dtype), tuple(
            s.astype(state[i].dtype) for i, s in enumerate(ns))

    if jit:
        jstep = jax.jit(jstep)
    for t, g in enumerate(grads, 1):
        jw, js = jstep(jw, jnp.asarray(g), js,
                       jnp.asarray(OPT["learning_rate"], jnp.float32),
                       jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            if master:
                nw, ns = tfo.apply(ts[-1], _t(g), ts[:-1],
                                   OPT["learning_rate"], t)
                ns = ns + (nw,)
            else:
                nw, ns = tfo.apply(tw, _t(g), ts, OPT["learning_rate"], t)
            tw = nw.to(tw.dtype)
            ts = tuple(v.to(s.dtype) for s, v in zip(ts, ns))
    for x, y in zip((tw,) + ts, (jw,) + tuple(js)):
        assert x.dtype == _t(np.asarray(y)).dtype
        a, b = _f32(x), _f32(y)
        if x.dtype != torch.bfloat16:
            assert _ulps(x, y) <= 4
        elif not jit:
            np.testing.assert_array_equal(a, b)
        else:
            # one bf16 rounding of the result, plus a step's skipped
            # rounding of w' (|w'| <= |w| + |m|/sqrt(v), the latter at most
            # (1 - beta1)/sqrt(1 - beta2) < 4) scaled by lr * coef <= lr
            mag = np.maximum(np.abs(a), np.abs(b))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126)))
                          - 7)
            skipped = len(grads) * OPT["learning_rate"] * 2.0 ** -7 * (
                np.abs(b).max() + 4.0)
            assert (np.abs(a - b) <= ulp + skipped).all()


def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16),
            nn.Dense(10, in_units=32))
    return net


def test_spmd_trainer_adam_three_steps_match_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(8, 16).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int32)
    opt = dict(learning_rate=0.01, wd=1e-3)
    jnet = _mlp(jnn)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jnet(mx.nd.array(x))
    params = jnet._collect_params_with_prefix()
    vals = {k: (0.3 * rs.randn(*p.shape)).astype(np.float32)
            for k, p in params.items()}
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
    with jpar.make_mesh(dp=1):
        jtr = jpar.SPMDTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(), "adam",
                               dict(opt))
        jl = [float(jtr.step(x, y).asnumpy()) for _ in range(3)]
    tnet = _mlp(tnn)
    tnet.initialize(ctx=mt.cpu())
    load_numpy_params(tnet, vals)
    ttr = tpar.SPMDTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(), "adam",
                           dict(opt),
                           mesh=tpar.make_mesh(dp=1, devices=[mt.cpu()]))
    tl = [float(ttr.step(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for k, p in params.items():
        want = np.asarray(jtr.params[p.name])
        got = tnet.state_dict(keep_vars=True)[k].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
        for i, what in enumerate(("mean", "var")):
            want = np.asarray(jtr.opt_state[p.name][i])
            np.testing.assert_allclose(
                ttr.opt_state[k][i].numpy(), want, rtol=1e-5,
                atol=1e-6 * np.abs(want).max(), err_msg=f"{what} {k}")


def test_adam_is_registered_and_others_still_queued():
    """Nothing is queued any more: every optimizer the JAX package
    registers is the port's, and each functional form carries the JAX
    form's number of states."""
    assert isinstance(topt.create("adam"), topt.Adam)
    assert isinstance(tpar.functional_optimizer("adam"),
                      tpar.FunctionalOptimizer)
    assert tpar.functional_optimizer("adam").n_state == 2
    for name in jopt._REG.list():
        assert type(topt.create(name)).__name__ == \
            type(jopt.create(name)).__name__
    for name, kw in (("rmsprop", {}), ("rmsprop", {"centered": True}),
                     ("adagrad", {}), ("adadelta", {}), ("adamax", {}),
                     ("ftrl", {}), ("signum", {}), ("signsgd", {})):
        assert tpar.functional_optimizer(topt.create(name, **kw)).n_state \
            == jpar.functional_optimizer(jopt.create(name, **kw)).n_state
