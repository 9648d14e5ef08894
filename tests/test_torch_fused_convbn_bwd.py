"""The backward of mxnet_tpu_torch's fused Conv+BN unit against the JAX
package.

* ``fused_conv_unit_bwd_ref`` (the plain version of the CUDA backward
  kernel) against ``_pallas_unit_bwd`` run directly in interpret mode
  (MXNET_PALLAS_INTERPRET=1), on the four ``BWD_CASES`` of
  ``tests/test_pallas_convbn.py`` plus a case without stats or input
  affine.  fp32: rtol/atol 1e-4.  bf16: gx and dw within 1 bf16 ulp of
  the reference plus the spread of two fp32 summation orders,
  4·√K·2⁻²⁴·Σ|terms| (K the length of the sum); gscale/gbias within
  1e-4 of Σ|terms|.
* The unit's autograd backward without the knob (the counterpart of the
  XLA branch) against ``jax.grad`` through ``pcb.fused_conv_unit`` with
  the knob off, on a stride-2 case (fp32, 1e-4).
* ``shift`` gets no gradient; a training-mode fused block gives the JAX
  gradients although its running mean changed in place in the forward.

Inputs come from ``numpy.random.RandomState`` seeds; both packages get
the same arrays.
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.ops import pallas_convbn as pcb

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import ActiveTrace, load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import fused_convbn as tfc

# (shape NHWC, Co, kernel, pad, act_in, want_stats): test_pallas_convbn's
# BWD_CASES, then one without stats or input affine
CASES = [
    ((4, 8, 8, 16), 16, (3, 3), (1, 1), True, True),
    ((2, 8, 8, 8), 24, (1, 1), (0, 0), True, True),
    ((2, 6, 6, 8), 8, (3, 3), (1, 1), False, True),
    ((2, 6, 6, 8), 8, (3, 3), (1, 1), True, False),
    ((2, 6, 6, 8), 16, (3, 3), (1, 1), False, False),
]


def _ids(c):
    return (f"{c[2][0]}x{c[2][0]}{'-act' if c[4] else ''}"
            f"{'-stats' if c[5] else ''}-co{c[1]}")


def _arrays(seed, shape, co, kernel, pad):
    rs = np.random.RandomState(seed)
    ci = shape[-1]
    ho = shape[1] + 2 * pad[0] - kernel[0] + 1
    wo = shape[2] + 2 * pad[1] - kernel[1] + 1
    return dict(
        x=rs.randn(*shape).astype(np.float32),
        w=(rs.randn(co, ci, *kernel) * 0.2).astype(np.float32),
        sc=(rs.rand(ci) + 0.5).astype(np.float32),
        bi=rs.randn(ci).astype(np.float32),
        sh=rs.randn(co).astype(np.float32),
        y=rs.randn(shape[0], ho, wo, co).astype(np.float32),
        gy=rs.randn(shape[0], ho, wo, co).astype(np.float32),
        gs1=(rs.randn(co) * 0.1).astype(np.float32),
        gs2=(rs.randn(co) * 0.1).astype(np.float32))


def _cast(a, name, bf16):
    """x, w, y, gy in the working dtype; the C-sized vectors stay fp32."""
    if bf16 and name in ("x", "w", "y", "gy"):
        return a.astype(ml_dtypes.bfloat16)
    return a


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v).astype(np.float32)


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_plain_bwd_matches_pallas_bwd_interpret(case, bf16, monkeypatch):
    shape, co, kernel, pad, act_in, want_stats = case
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    raw = _arrays(21, shape, co, kernel, pad)
    arrs = {k: _cast(v, k, bf16) for k, v in raw.items()}
    order = ("x", "w", "sc", "bi", "sh", "y", "gy", "gs1", "gs2")
    ref = pcb._pallas_unit_bwd(*(jnp.asarray(arrs[k]) for k in order),
                               kernel=kernel, stride=(1, 1), pad=pad,
                               act_in=act_in, want_stats=want_stats)
    got = tfc.fused_conv_unit_bwd(*(_to_torch(arrs[k]) for k in order),
                                  kernel=kernel, stride=(1, 1), pad=pad,
                                  act_in=act_in, want_stats=want_stats)
    assert got[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert got[1].dtype == got[0].dtype and tuple(got[1].shape) == \
        raw["w"].shape
    names = ("gx", "dw", "gscale", "gbias")
    if not bf16:
        for name, a, b in zip(names, got, ref):
            np.testing.assert_allclose(_np32(a), _np32(b), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        return
    # bf16: the magnitudes Σ|terms| of each sum, from the same inputs
    f = {k: np.abs(v.astype(np.float32)) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    dy = torch.from_numpy(np.abs(_np32(tfc._fold_dy(
        _to_torch(arrs["y"]), _to_torch(arrs["gy"]),
        torch.from_numpy(raw["sh"]), torch.from_numpy(raw["gs1"]),
        torch.from_numpy(raw["gs2"]), want_stats))))
    u = torch.from_numpy(np.abs(_np32(tfc._affine_in(
        _to_torch(arrs["x"]), torch.from_numpy(raw["sc"]),
        torch.from_numpy(raw["bi"]), act_in))))
    du_mag, dw_mag = tfc._conv_grads(u, t["w"], dy, (1, 1), pad,
                                     torch.float32)
    sc_abs = t["sc"] if act_in else torch.ones(shape[-1])
    k_dgrad = kernel[0] * kernel[1] * co
    k_wgrad = dy.shape[0] * dy.shape[1] * dy.shape[2]
    mags = {"gx": (du_mag * sc_abs).numpy(), "dw": dw_mag.numpy()}
    for name, a, b, k in (("gx", got[0], ref[0], k_dgrad),
                          ("dw", got[1], ref[1], k_wgrad)):
        a, b = _np32(a), _np32(b)
        slack = 4.0 * math.sqrt(k) * 2.0 ** -24 * mags[name]
        err = np.abs(a - b)
        assert np.all(err <= _bf16_ulp(b) + slack), \
            f"{name}: worst {float(np.max(err - slack - _bf16_ulp(b)))}"
    if act_in:
        du_abs = du_mag.numpy()  # bounds |gu| elementwise
        scale_x = (du_abs * f["x"]).sum(axis=(0, 1, 2))
        scale_1 = du_abs.sum(axis=(0, 1, 2))
        for name, a, b, s in (("gscale", got[2], ref[2], scale_x),
                              ("gbias", got[3], ref[3], scale_1)):
            assert np.all(np.abs(_np32(a) - _np32(b)) <= 1e-4 * s + 1e-6), \
                name
    else:
        assert not _np32(got[2]).any() and not _np32(got[3]).any()


def test_unit_backward_without_the_knob_matches_jax_grad_strided(
        monkeypatch):
    """Stride 2: the unit's autograd backward is the dgrad/wgrad
    counterpart of the XLA branch whatever the knob says."""
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", "1")
    raw = _arrays(22, (2, 9, 9, 8), 16, (3, 3), (1, 1))
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), act_in=True,
              want_stats=True)

    def jloss(x, w, sc, bi):
        y, s1, s2 = pcb.fused_conv_unit(x, w, sc, bi,
                                        jnp.asarray(raw["sh"]), **kw)
        return ((y.astype(jnp.float32) ** 2).sum()
                + (s1 * s1).sum() * 1e-3 + s2.sum() * 1e-3)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(raw[k]) for k in ("x", "w", "sc", "bi")))
    ts = [torch.from_numpy(raw[k]).requires_grad_()
          for k in ("x", "w", "sc", "bi")]
    sh = torch.from_numpy(raw["sh"]).requires_grad_()
    calls = []
    real = tfc.fused_conv_unit_bwd
    monkeypatch.setattr(tfc, "fused_conv_unit_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    y, s1, s2 = tfc.fused_conv_unit(*ts, sh, **kw)
    ((y ** 2).sum() + (s1 * s1).sum() * 1e-3 + s2.sum() * 1e-3).backward()
    assert not calls  # strided: never the kernel's wrapper
    assert sh.grad is None  # the running mean gets no gradient
    for name, t, r in zip(("gx", "dw", "gscale", "gbias"), ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("knob", ["0", "1"])
def test_stride1_backward_follows_the_knob(knob, monkeypatch):
    """Stride 1: the kernel's wrapper serves the backward only with
    MXNET_FUSED_CONVBN_BWD=1; both rules give the same gradients."""
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", knob)
    raw = _arrays(23, (2, 6, 6, 8), 8, (3, 3), (1, 1))
    calls = []
    real = tfc.fused_conv_unit_bwd
    monkeypatch.setattr(tfc, "fused_conv_unit_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ts = [torch.from_numpy(raw[k]).requires_grad_()
          for k in ("x", "w", "sc", "bi")]
    y, s1, s2 = tfc.fused_conv_unit(*ts, torch.from_numpy(raw["sh"]),
                                    kernel=(3, 3), pad=(1, 1), act_in=True)
    ((y ** 2).sum() + s2.sum() * 1e-3).backward()
    assert len(calls) == int(knob)
    want = tfc._unit_bwd_plain(
        *(t.detach() for t in ts), torch.from_numpy(raw["sh"]), y.detach(),
        2 * y.detach(), torch.zeros(8), torch.full((8,), 1e-3), (1, 1),
        (1, 1), True, True, conv_dtype=torch.float32)
    for t, r in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _bwd_args(raw):
    order = ("x", "w", "sc", "bi", "sh", "y", "gy", "gs1", "gs2")
    return [torch.from_numpy(raw[k]) for k in order]


def test_bwd_takes_the_vectors_in_fp32():
    """in_scale, in_bias, shift, gs1 and gs2 in another dtype are cast to
    fp32 (the kernel reads them as float)."""
    raw = _arrays(26, (2, 6, 6, 8), 8, (3, 3), (1, 1))
    kw = dict(kernel=(3, 3), pad=(1, 1), act_in=True, want_stats=True)
    args = _bwd_args(raw)
    for i in (2, 3, 4, 7, 8):  # round the vectors to bf16 once
        args[i] = args[i].to(torch.bfloat16).float()
    want = tfc.fused_conv_unit_bwd(*args, **kw)
    half = list(args)
    for i in (2, 3, 4, 7, 8):
        half[i] = args[i].to(torch.bfloat16)
    got = tfc.fused_conv_unit_bwd(*half, **kw)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        assert torch.equal(g, r)


@pytest.mark.parametrize("i,name", [(2, "in_scale"), (3, "in_bias"),
                                    (4, "shift"), (7, "gs1"), (8, "gs2")])
def test_bwd_rejects_a_vector_of_the_wrong_length(i, name):
    raw = _arrays(27, (2, 6, 6, 8), 16, (3, 3), (1, 1))
    args = _bwd_args(raw)
    args[i] = args[i][:-1]
    with pytest.raises(mt.base.MXNetError, match=name):
        tfc.fused_conv_unit_bwd(*args, kernel=(3, 3), pad=(1, 1),
                                act_in=True, want_stats=True)


def _bn_values(names_shapes, seed):
    """Weights plus running means far from the batch means, so that
    folding dy with the updated mean instead of the forward's shows."""
    rs = np.random.RandomState(seed)
    vals = {}
    for name, shape in names_shapes:
        if name.endswith("weight"):
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith(("gamma", "running_var")):
            v = rs.rand(*shape) + 0.5
        elif name.endswith("running_mean"):
            v = rs.randn(*shape) * 2.0
        else:
            v = rs.randn(*shape) * 0.1
        vals[name] = v.astype(np.float32)
    return vals


@pytest.mark.parametrize("knob", ["0", "1"])
def test_fused_train_block_grads_survive_the_running_mean_update(
        knob, monkeypatch):
    """A stride-1 BottleneckV1 in training: the forward updates the
    running means in place, and the backward must still fold dy with the
    means the forward used (the shift trap)."""
    x = np.random.RandomState(24).randn(2, 6, 6, 16).astype(np.float32)
    jb = jres.BottleneckV1(16, 1, downsample=False, in_channels=16,
                           layout="NHWC")
    jb.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jb(mx.nd.array(x))
    jparams = jb._collect_params_with_prefix()
    vals = _bn_values([(k, tuple(p.shape)) for k, p in jparams.items()], 25)
    for k, p in jparams.items():
        p.set_data(mx.nd.array(vals[k]))
    jb.hybridize()
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    with autograd.record():
        out = jb(mx.nd.array(x))
        loss = (out * out).sum()
    loss.backward()
    ref = {k: p.grad().asnumpy() for k, p in jparams.items()
           if p.grad_req != "null"}

    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", knob)
    tb = tres.BottleneckV1(16, 1, downsample=False, in_channels=16,
                           layout="NHWC")
    tb.initialize(ctx=mt.cpu())
    load_numpy_params(tb, vals)
    params = dict(tb.named_parameters())
    with ActiveTrace(train=True):
        tout = tb(torch.from_numpy(x))
    rm = tb.body[1].running_mean.data().asnumpy()
    assert not np.allclose(rm, vals["body.1.running_mean"])  # it moved
    grads = torch.autograd.grad((tout * tout).sum(), list(params.values()))
    assert set(params) == set(ref)
    # atol scales with the block's largest gradient: the conv biases'
    # gradients cancel to ~1e-4 from terms of that size (fp32 order noise)
    atol = 2e-5 * max(float(np.abs(v).max()) for v in ref.values())
    for (k, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-4, atol=atol,
                                   err_msg=k)
