"""mxnet_tpu_torch's attention backward against the JAX package's.

The port's ``_AttentionFn`` saves q, k, v and the mask and recomputes
``dot_product_attention_ref`` per (batch, head) in its backward, as the
JAX package's ``_attend_bwd`` does (a ``jax.vjp`` of the reference).
Here dq, dk and dv of the op (packed (B, S, U) and head-split (B, H, S,
D) layouts, ``attend``'s (BH, S, D), causal with S != Sk, a fully masked
row) are held against ``jax.vjp`` through the JAX op, which reaches
``_attend`` and its custom backward, on the same inputs and cotangent
(numpy seed).  Tolerances: fp32 within 1e-5 of each gradient's largest
element (measured: at most 3.5e-7); bf16 bit for bit (the JAX vjp runs
op by op here and rounds where the port's recompute rounds: P to bf16
before P.V, the bf16 products' cotangents back to bf16).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_attention as jpa

from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tatt

# name: layout, B, H, S, Sk, D, causal, valid lengths (None: no mask)
CASES = {
    "packed": ("packed", 2, 4, 12, 12, 8, False, [12, 7]),
    "head_split": ("split", 2, 3, 10, 10, 16, False, [4, 10]),
    "causal_sq_ne_sk": ("packed", 2, 2, 5, 9, 8, True, [9, 9]),
    "cross_sq_ne_sk": ("packed", 2, 4, 3, 16, 8, False, [16, 11]),
    "fully_masked_row": ("packed", 3, 2, 6, 6, 8, False, [6, 0, 3]),
    "no_mask": ("split", 1, 2, 7, 7, 8, True, None),
}


def _np(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _t(a, grad=False):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.requires_grad_(grad)


def _inputs(case, dtype, seed=0):
    layout, b, h, s, sk, d, causal, lens = CASES[case]
    rs = np.random.RandomState(seed)
    if layout == "packed":
        qs, ks, os_ = (b, s, h * d), (b, sk, h * d), (b, s, h * d)
    else:
        qs, ks, os_ = (b, h, s, d), (b, h, sk, d), (b, h, s, d)
    q, k, v = (rs.randn(*shape).astype(np.float32).astype(_np(dtype))
               for shape in (qs, ks, ks))
    ct = rs.randn(*os_).astype(np.float32).astype(_np(dtype))
    mask = None if lens is None else (
        np.arange(sk)[None, :] < np.asarray(lens)[:, None]).astype(
            np.float32)
    return q, k, v, mask, ct, h, causal


def _jax_grads(q, k, v, mask, ct, h, causal):
    def fn(q_, k_, v_):
        return jpa._dot_product_attention(
            q_, k_, v_, None if mask is None else jnp.asarray(mask),
            num_heads=h, causal=causal)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x).astype(np.float32)
            for x in (out,) + vjp(jnp.asarray(ct))]


def _port_grads(q, k, v, mask, ct, h, causal):
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    out = tops.dot_product_attention(
        tq, tk, tv, None if mask is None else torch.from_numpy(mask),
        num_heads=h, causal=causal)
    saved = [None if t is None else tuple(t.shape)
             for t in out.grad_fn.saved_tensors]
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(ct))
    return [x.detach().float().numpy() for x in (out,) + grads], saved


def _hold(got, want, dtype, what):
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_grads_match_jax(case, dtype):
    args = _inputs(case, dtype)
    want = _jax_grads(*args)
    got, saved = _port_grads(*args)
    for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
        _hold(g, w, dtype, f"{case} {what}")
    # the backward holds q, k, v and the mask, never the probabilities
    _, b, h, s, sk, d, _, lens = CASES[case]
    assert saved == [(b, h, s, d), (b, h, sk, d), (b, h, sk, d),
                     None if lens is None else (b, sk)]


def test_attend_surface_grads_match_jax():
    """``attend``'s (BH, S, D) surface, causal, against ``_attend``."""
    rs = np.random.RandomState(3)
    bh, s, sk, d = 6, 7, 11, 8
    q = rs.randn(bh, s, d).astype(np.float32)
    k, v = (rs.randn(bh, sk, d).astype(np.float32) for _ in range(2))
    mask = (rs.rand(bh, sk) < 0.8).astype(np.float32)
    mask[2] = 0.0
    ct = rs.randn(bh, s, d).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: jpa._attend(a, b_, c, jnp.asarray(mask),
                                                   0.3, True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    out = tops.attend(tq, tk, tv, torch.from_numpy(mask), 0.3, True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_mask_and_flags_get_no_gradient():
    q, k, v, mask, ct, h, causal = _inputs("packed", "float32")
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    tm = torch.from_numpy(mask).requires_grad_()
    out = tops.dot_product_attention(tq, tk, tv, tm, num_heads=h)
    gq, gm = torch.autograd.grad(out, (tq, tm), _t(ct), allow_unused=True)
    assert gm is None and gq is not None and torch.isfinite(gq).all()


def test_fully_masked_row_gradients():
    """A batch row with every key masked attends uniformly to all keys in
    both packages: dq is 0 there (the scores are constant) and dv
    spreads the cotangent evenly."""
    q, k, v, mask, ct, h, causal = _inputs("fully_masked_row", "float32")
    got, _ = _port_grads(q, k, v, mask, ct, h, causal)
    _, dq, dk, dv = got
    assert np.abs(dq[1]).max() == 0.0 and np.abs(dk[1]).max() == 0.0
    d = q.shape[-1] // h
    ctr = ct[1].reshape(ct.shape[1], h, d).sum(axis=0) / k.shape[1]
    np.testing.assert_allclose(
        dv[1].reshape(k.shape[1], h, d),
        np.broadcast_to(ctr, (k.shape[1], h, d)), rtol=1e-5, atol=1e-6)


def test_dropout_path_is_differentiated_by_autograd():
    """With train and dropout > 0 the op runs the plain math with
    dropout; autograd differentiates it, and the same generator seed
    gives the same output and gradients."""
    q, k, v, mask, ct, h, _ = _inputs("packed", "float32")
    res = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        tq, tk, tv = (_t(x, True) for x in (q, k, v))
        out = tops.dot_product_attention(
            tq, tk, tv, torch.from_numpy(mask), num_heads=h, dropout=0.5,
            train=True, generator=gen)
        res.append([out] + list(torch.autograd.grad(out, (tq, tk, tv),
                                                    _t(ct))))
    for a, b in zip(*res):
        assert torch.equal(a, b) and torch.isfinite(a).all()
    eval_out = tops.dot_product_attention(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), num_heads=h)
    assert not torch.allclose(res[0][0], eval_out)
    with pytest.raises(MXNetError, match="generator"):
        tops.dot_product_attention(_t(q), _t(k), _t(v), None, num_heads=h,
                                   dropout=0.5, train=True)


def test_cpu_forward_and_backward_launch_no_kernel():
    """On CPU tensors the forward is the plain version and the backward
    the recompute: the kernel's launch counter stays at 0."""
    tatt.reset_attention_launch_count()
    q, k, v, mask, ct, h, causal = _inputs("causal_sq_ne_sk", "float32")
    _port_grads(q, k, v, mask, ct, h, causal)
    assert tatt.attention_launch_count() == 0
