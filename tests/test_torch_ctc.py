"""CTCLoss of mxnet_tpu_torch against the JAX package's, on the CPU.

* The op (``CTCLoss`` / ``ctc_loss``, ``ops/nn.py`` against
  ``mxnet_tpu/ops/nn.py``): the blank first (labels padded with 0 or
  -1) and last (padded with -1), ``use_data_lengths`` (lengths clipped
  into [1, T]), ``use_label_lengths``, repeated labels, and a label no
  alignment of its frames can emit (the JAX op's log 0 is -1e30, so the
  loss is about 1e30 and finite): the loss within RNN_FWD and the
  gradient of the activations under a seeded cotangent within RNN_BWD
  of (1 + |want|) (``torch_parity``).
* ``gluon.loss.CTCLoss`` in the NTC and TNC layouts with NT and TN
  labels, with lengths given and left out, and a sample weight.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import nn as tnn

import torch_parity as tp

T, B, A = 9, 4, 6


def _labels(blank, pad):
    """(B, 4) labels: real symbols avoid the blank; rows of 4, 2 (with a
    repeat), 1 and 3 symbols, padded with ``pad``."""
    lo, hi = (1, A) if blank == "first" else (0, A - 1)
    rng = np.random.RandomState(3)
    lab = rng.randint(lo, hi, (B, 4)).astype(np.float32)
    lab[1, :2] = lab[1, 0]
    for row, n in enumerate((4, 2, 1, 3)):
        lab[row, n:] = pad
    return lab


def _both(data, label, dl=None, ll=None, **attrs):
    """(port loss, port grad, JAX loss, JAX grad) of the op under a
    seeded cotangent of the per-sequence loss."""
    ct = np.random.RandomState(5).rand(data.shape[1]).astype(np.float32)

    def jf(x):
        return jnn._ctc_loss(x, jnp.asarray(label),
                             None if dl is None else jnp.asarray(dl),
                             None if ll is None else jnp.asarray(ll),
                             **attrs)

    @jax.jit
    def jboth(x):
        out, vjp = jax.vjp(jf, x)
        return out, vjp(jnp.asarray(ct))[0]

    jl, jg = jboth(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    tl = tnn.ctc_loss(x, torch.from_numpy(label),
                      None if dl is None else torch.from_numpy(dl),
                      None if ll is None else torch.from_numpy(ll), **attrs)
    (tg,) = torch.autograd.grad(tl, [x], [torch.from_numpy(ct)])
    return tl.detach().numpy(), tg.numpy(), np.asarray(jl), np.asarray(jg)


def _hold(data, label, **kw):
    tl, tg, jl, jg = _both(data, label, **kw)
    assert tl.dtype == jl.dtype == np.float32
    tp.hold_close(tl, jl, tp.RNN_FWD, "loss")
    tp.hold_close(tg, jg, tp.RNN_BWD, "gradient")
    return tl


def _data(seed=1, t=T):
    return np.random.RandomState(seed).randn(t, B, A).astype(np.float32)


@pytest.mark.parametrize("blank,pad", [("first", 0), ("first", -1),
                                       ("last", -1)])
def test_ctc_op_matches_jax(blank, pad):
    _hold(_data(), _labels(blank, pad), blank_label=blank)


def test_ctc_op_with_data_and_label_lengths():
    dl = np.array([9, 5, 0, 14], np.float32)   # 0 and 14 are clipped
    ll = np.array([4, 2, 1, 2], np.float32)    # row 3 reads 2 of its 3
    _hold(_data(2), _labels("first", 0), dl=dl, ll=ll,
          use_data_lengths=True, use_label_lengths=True)
    _hold(_data(3), _labels("last", -1), dl=dl, use_data_lengths=True,
          blank_label="last")


def test_ctc_op_an_impossible_alignment_is_finite():
    # three frames cannot emit a, a (it needs a blank between: 3 frames)
    # plus a third symbol
    lab = np.array([[1, 1, 2, 0]] * B, np.float32)
    loss = _hold(_data(4, t=3), lab)
    assert np.isfinite(loss).all() and (loss > 1e29).all()


def test_ctc_op_is_registered_under_both_names():
    from mxnet_tpu_torch.ops import registry

    assert registry.get_op("CTCLoss") is registry.get_op("ctc_loss")
    data, lab = _data(6), _labels("first", 0)
    got = mt.nd.CTCLoss(mt.nd.array(data, ctx=mt.cpu()),
                        mt.nd.array(lab, ctx=mt.cpu())).asnumpy()
    want = mx.nd.CTCLoss(mx.nd.array(data), mx.nd.array(lab)).asnumpy()
    tp.hold_close(got, want, tp.RNN_FWD)


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN"),
                                                 ("NTC", "TN")])
@pytest.mark.parametrize("lengths", [False, True])
def test_gluon_ctc_loss_matches_jax(layout, label_layout, lengths):
    data = _data(7)                                  # (T, B, A)
    lab = _labels("last", -1)                        # (B, L)
    if layout == "NTC":
        data = np.ascontiguousarray(data.transpose(1, 0, 2))
    if label_layout == "TN":
        lab = np.ascontiguousarray(lab.T)
    extra = [np.array([9, 7, 8, 6], np.float32),
             np.array([4, 2, 1, 3], np.float32)] if lengths else []
    weight = np.array([[1.0], [0.5], [2.0], [1.5]], np.float32)
    out = {}
    for name, m, L, ctx in (("jax", mx, jloss, mx.cpu()),
                            ("port", mt, tloss, mt.cpu())):
        fn = L.CTCLoss(layout=layout, label_layout=label_layout,
                       prefix="ctc_")
        x = m.nd.array(data, ctx=ctx)
        x.attach_grad()
        args = [m.nd.array(a, ctx=ctx) for a in [lab] + extra]
        with m.autograd.record():
            loss = fn(x, *args) if lengths else fn(x, args[0])
            weighted = fn(x, *(args + [m.nd.array(weight, ctx=ctx)])) \
                if lengths else None
        loss.backward()
        out[name] = (loss.asnumpy(), x.grad.asnumpy(),
                     None if weighted is None else weighted.asnumpy())
    tp.hold_close(out["port"][0], out["jax"][0], tp.RNN_FWD, "loss")
    tp.hold_close(out["port"][1], out["jax"][1], tp.RNN_BWD, "gradient")
    if lengths:
        tp.hold_close(out["port"][2], out["jax"][2], tp.RNN_FWD, "weighted")
