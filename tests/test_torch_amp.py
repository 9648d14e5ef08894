"""contrib.amp and the amp ops of mxnet_tpu_torch against the JAX
package's, on the CPU.

* ``amp_cast`` (float16 is bfloat16, float32 stays) and
  ``amp_multicast`` (the widest dtype, the narrowest with
  ``cast_narrow``) through both registries: the same bits and dtypes
  (``torch_parity.hold_case`` on op_sweep's cases, and bf16/fp32 pairs).
* ``init("float16")`` selects bfloat16 and ``init("float32")`` raises in
  both; ``convert_hybrid_block`` casts the same parameters of a net with
  Dense, BatchNorm and LayerNorm (the normalisation ones stay float32)
  and ``convert_model`` the same arguments of a symbol's dicts.
* ``LossScaler`` at init_scale 8, factor 2, window 2: the same overflow
  answers and the same scale after each of a run of clean and
  overflowing gradients; at init_scale 1 it never moves.
* ``scale_loss``/``unscale`` around one backward of a small net: the
  same loss scale afterwards and gradients within 1e-6 of (1 + |want|)
  of the JAX package's (and of an unscaled backward's).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import nn as tnn

import torch_parity as tp

PKG = {"jax": (mx, jamp, jnn, mx.cpu()), "port": (mt, tamp, tnn, mt.cpu())}


@pytest.mark.parametrize("name", ["amp_cast", "amp_multicast"])
def test_amp_ops_match_jax(name):
    tp.hold_case(name)


def test_amp_cast_and_multicast_dtypes():
    import ml_dtypes

    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    b = a.astype(ml_dtypes.bfloat16)
    for dtype, want in (("float16", "bfloat16"), ("float32", "float32"),
                        ("bfloat16", "bfloat16")):
        j = mx.nd.amp_cast(mx.nd.array(a), dtype=dtype)
        t = mt.nd.amp_cast(mt.nd.array(a, ctx=mt.cpu()), dtype=dtype)
        assert str(j.dtype) == str(t.dtype) == want, dtype
        np.testing.assert_array_equal(np.asarray(t.asnumpy(), np.float32),
                                      np.asarray(j.asnumpy(), np.float32))
    for narrow, want in ((False, "float32"), (True, "bfloat16")):
        js = mx.nd.amp_multicast(mx.nd.array(b, dtype=b.dtype),
                                 mx.nd.array(a), num_outputs=2,
                                 cast_narrow=narrow)
        ts = mt.nd.amp_multicast(
            mt.nd.array(b, ctx=mt.cpu(), dtype=b.dtype),
            mt.nd.array(a, ctx=mt.cpu()), num_outputs=2, cast_narrow=narrow)
        for j, t in zip(js, ts):
            assert str(j.dtype) == str(t.dtype) == want, narrow
            np.testing.assert_array_equal(
                np.asarray(t.asnumpy(), np.float32),
                np.asarray(j.asnumpy(), np.float32))


def test_init_selects_bfloat16():
    for amp in (jamp, tamp):
        amp.init("float16")
        assert amp._TARGET["dtype"] == "bfloat16"
        with pytest.raises(Exception, match="unsupported target"):
            amp.init("float32")


def _net(pkg):
    _, _, nn, _ = PKG[pkg]
    net = nn.HybridSequential(prefix="amp_")
    with net.name_scope():
        net.add(nn.Dense(8, in_units=5, prefix="d0_"),
                nn.BatchNorm(in_channels=8, prefix="bn_"),
                nn.Dense(6, in_units=8, prefix="d1_"),
                nn.LayerNorm(in_channels=6, prefix="ln_"))
    return net


def test_convert_hybrid_block_and_convert_model_cast_alike():
    dtypes = {}
    for pkg in ("jax", "port"):
        m, amp, _, ctx = PKG[pkg]
        net = _net(pkg)
        net.initialize(ctx=ctx)
        amp.convert_hybrid_block(net, target_dtype="float16")
        params = net._collect_params_with_prefix() if pkg == "jax" \
            else dict(net.collect_params().items())
        dtypes[pkg] = {k: str(p.data().dtype) for k, p in params.items()}
    assert dtypes["jax"] == dtypes["port"]
    assert dtypes["port"]["0.weight"] == "bfloat16"
    assert dtypes["port"]["1.gamma"] == "float32"
    assert dtypes["port"]["3.beta"] == "float32"
    args = {"fc_weight": np.ones((2, 3), np.float32),
            "bn_gamma": np.ones(3, np.float32),
            "bn_moving_mean": np.zeros(3, np.float32)}
    got = {}
    for pkg in ("jax", "port"):
        m, amp, _, ctx = PKG[pkg]
        arg = {k: m.nd.array(v, ctx=ctx) for k, v in args.items()
               if "moving" not in k}
        aux = {"bn_moving_mean": m.nd.array(args["bn_moving_mean"],
                                            ctx=ctx)}
        sym = m.sym.var("data")
        s2, a2, x2 = amp.convert_model(sym, arg, aux)
        assert s2 is sym
        got[pkg] = ({k: str(v.dtype) for k, v in a2.items()},
                    {k: str(v.dtype) for k, v in x2.items()})
    assert got["jax"] == got["port"]
    assert got["port"][0] == {"fc_weight": "bfloat16",
                              "bn_gamma": "float32"}


class _P:
    """A parameter-like handle on one gradient (what has_overflow reads)."""

    def __init__(self, grad):
        self.grad_req = "write"
        self._g = grad

    def grad(self):
        return self._g


def test_loss_scaler_schedule_matches_jax():
    grads = [1.0, np.inf, 2.0, 3.0, 4.0, np.nan, 5.0, 6.0, 7.0]
    trace = {}
    for pkg in ("jax", "port"):
        m, amp, _, ctx = PKG[pkg]
        sc = amp.LossScaler(init_scale=8.0, scale_factor=2.0,
                            scale_window=2)
        off = amp.LossScaler()
        seen = []
        for g in grads:
            p = _P(m.nd.array(np.array([0.5, g], np.float32), ctx=ctx))
            over = sc.has_overflow([p])
            sc.update_scale(over)
            off.update_scale(over)
            seen.append((over, sc.loss_scale, off.loss_scale))
        trace[pkg] = seen
    assert trace["jax"] == trace["port"]
    assert [s[1] for s in trace["port"]] == \
        [8.0, 4.0, 4.0, 8.0, 8.0, 4.0, 4.0, 8.0, 8.0]
    assert {s[2] for s in trace["port"]} == {1.0}


def test_scale_loss_and_unscale_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 5).astype(np.float32)
    out = {}
    start = None
    for pkg in ("jax", "port"):
        m, amp, nn, ctx = PKG[pkg]
        net = nn.Dense(3, in_units=5, prefix="sd_")
        net.initialize(mx.initializer.Xavier() if pkg == "jax" else None,
                       ctx=ctx)
        if pkg == "jax":
            start = {k: p.data().asnumpy()
                     for k, p in net._collect_params_with_prefix().items()}
        else:
            load_numpy_params(net, start)
        trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1})
        amp.init_trainer(trainer, init_scale=16.0)
        with m.autograd.record():
            loss = (net(m.nd.array(x, ctx=ctx)) ** 2).sum()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        amp.unscale(trainer)
        grads = [p.grad().asnumpy() for p in trainer._params]
        with m.autograd.record():
            loss = (net(m.nd.array(x, ctx=ctx)) ** 2).sum()
        loss.backward()
        plain = [p.grad().asnumpy() for p in trainer._params]
        out[pkg] = (grads, plain, trainer._amp_loss_scaler.loss_scale)
    assert out["jax"][2] == out["port"][2] == 16.0
    for g, j, p in zip(out["port"][0], out["jax"][0], out["port"][1]):
        tp.hold_close(g, j, 1e-6)
        tp.hold_close(g, p, 1e-6)
