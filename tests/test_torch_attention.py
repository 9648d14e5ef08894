"""mxnet_tpu_torch's dot_product_attention against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
package's Pallas kernel ``_attention_pallas`` in interpret mode and its
reference ``dot_product_attention_ref``, and through the port's plain
version and its op on CPU tensors (which runs that plain version).  fp32
cases agree to rtol/atol 1e-5 (the same math in another summation
order).  The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``; here its argument check is tested.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa

from mxnet_tpu_torch import ops
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as ta

CASES = [(4, 40, 16, [40, 17, 40, 3]), (2, 200, 16, [200, 77])]


def _inputs(bh, s, d, lens, seed=0, sk=None):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    q = rng.randn(bh, s, d).astype(np.float32)
    k = rng.randn(bh, sk, d).astype(np.float32)
    v = rng.randn(bh, sk, d).astype(np.float32)
    mask = (np.arange(sk)[None, :] < np.array(lens)[:, None]).astype(
        np.float32)
    return q, k, v, mask


def _jax(fn, *args, **kw):
    """fn on the numpy arguments as jax arrays (scalars stay Python)."""
    return np.asarray(fn(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in args), **kw))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("bh,s,d,lens", CASES)
def test_plain_version_and_op_match_the_jax_kernel(interpret, bh, s, d,
                                                   lens):
    q, k, v, mask = _inputs(bh, s, d, lens)
    kern = _jax(pa._attention_pallas, q, k, v, mask, 0.25)
    ref = _jax(pa.dot_product_attention_ref, q, k, v, mask, 0.25)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    plain = ta.dot_product_attention_ref(tq, tk, tv, tm, 0.25).numpy()
    op = ops.attend(tq, tk, tv, tm, 0.25).numpy()
    for got in (plain, op):
        np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert ops.attention_launch_count() == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("sq,sk", [(40, 72), (72, 40)])
def test_causal_with_sq_ne_sk(interpret, sq, sk):
    """The last query sees the last key; with sq > sk the first queries
    see no key and get uniform weights (the finite -1e30)."""
    q, k, v, mask = _inputs(2, sq, 16, [sk, sk - 9], seed=3, sk=sk)
    ref = _jax(pa.dot_product_attention_ref, q, k, v, mask, 0.25,
               causal=True)
    kern = _jax(pa._attention_pallas, q, k, v, mask, 0.25, causal=True)
    got = ops.attend(*_torch(q, k, v, mask), 0.25, causal=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)
    if sq > sk:
        np.testing.assert_allclose(got[0, 0], v[0].mean(axis=0), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("with_mask", [True, False])
def test_packed_and_head_split_layouts_match_the_jax_op(with_mask):
    b, h, s, d = 2, 4, 24, 8
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, s, h * d).astype(np.float32) for _ in range(3))
    mask = (np.arange(s)[None, :] < np.array([24, 9])[:, None]).astype(
        np.float32) if with_mask else None
    want = np.asarray(pa._dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), None, num_heads=h))
    tmask = None if mask is None else torch.from_numpy(mask)
    packed = ops.dot_product_attention(*_torch(q, k, v), tmask, num_heads=h)
    assert packed.shape == (b, s, h * d)
    np.testing.assert_allclose(packed.numpy(), want, rtol=1e-5, atol=1e-5)

    def split(x):
        return torch.from_numpy(x).reshape(b, s, h, d).permute(0, 2, 1, 3)
    heads = ops.dot_product_attention(split(q), split(k), split(v), tmask)
    assert heads.shape == (b, h, s, d)
    np.testing.assert_allclose(
        heads.permute(0, 2, 1, 3).reshape(b, s, h * d).numpy(), want,
        rtol=1e-5, atol=1e-5)
    # the default scale is 1/sqrt(head_dim)
    explicit = ops.dot_product_attention(*_torch(q, k, v), tmask,
                                         num_heads=h, scale=1 / math.sqrt(d))
    torch.testing.assert_close(explicit, packed, rtol=0, atol=0)


def test_bf16_matches_the_jax_kernel(interpret):
    """bf16 in, bf16 out.  Bound: 2 bf16 ulps of the JAX kernel's output
    plus 2^-8 * sum_k p_k |v_k| (one bf16 rounding of each probability,
    which the two sides may round differently when their fp32 scores
    differ in the last bit)."""
    q, k, v, mask = _inputs(4, 40, 16, [40, 17, 40, 3], seed=7)
    qb, kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    kern = _jax(pa._attention_pallas, qb, kb, vb, mask.astype(qb.dtype),
                0.25).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.attend(tq, tk, tv, torch.from_numpy(mask), 0.25)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    p = ta._softmax(ta._scores(tq, tk, torch.from_numpy(mask), 0.25, False))
    spread = torch.matmul(p, tv.float().abs()).numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(kern), 2.0 ** -126)))
                  - 7)
    err = np.abs(got - kern)
    assert (err <= 2 * ulp + 2.0 ** -8 * spread).all(), err.max()


def test_fully_masked_row_averages_the_real_keys(interpret):
    """Reference behaviour recorded in ROADMAP.md section C: with every
    key of a row masked, the port and dot_product_attention_ref average
    the sk real keys; the TPU kernel pads keys to a multiple of 8 and
    averages over sk_pad, the zero rows of v among them."""
    q, k, v, mask = _inputs(2, 77, 16, [77, 0], seed=9)
    got = ops.attend(*_torch(q, k, v, mask), 0.25).numpy()
    ref = _jax(pa.dot_product_attention_ref, q, k, v, mask, 0.25)
    kern = _jax(pa._attention_pallas, q, k, v, mask, 0.25)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0),
                                                       (77, 16)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kern[1], np.broadcast_to(v[1].sum(0) / 80,
                                                        (77, 16)),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(kern[1] - got[1]).max() > 1e-3
    np.testing.assert_allclose(got[0], kern[0], rtol=1e-5, atol=1e-5)


def test_dropout_draws_from_the_given_generator():
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(4, 6, 16).astype(np.float32))
    mask = torch.ones(4, 6)

    def att(seed, rate=0.5, train=True):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return ops.dot_product_attention(x, x, x, mask, num_heads=2,
                                         dropout=rate, train=train,
                                         generator=gen)
    plain = att(None, train=False)
    torch.testing.assert_close(att(1), att(1), rtol=0, atol=0)
    assert not torch.equal(att(1), att(2))
    assert not torch.equal(att(1), plain)
    torch.testing.assert_close(att(None, rate=0.0), plain, rtol=0, atol=0)
    with pytest.raises(MXNetError, match="Generator"):
        att(None)
    # the dropout op: same generator state, same mask; p = 0 and eval
    # are the identity, mode="always" applies it outside training; the
    # kept entries are scaled by 1/(1-p)
    y1 = ops.dropout(x, p=0.25, train=True,
                     generator=torch.Generator().manual_seed(3))
    y2 = ops.dropout(x, p=0.25, train=True,
                     generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    kept = y1 != 0
    torch.testing.assert_close(y1[kept], x[kept] / 0.75)
    assert ops.dropout(x, p=0.0, train=True) is x
    assert ops.dropout(x, p=0.25, train=False) is x
    always = ops.dropout(x, p=0.25, mode="always",
                         generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(always, y1, rtol=0, atol=0)


def test_backward_is_not_ported():
    """No backward kernel is ported, as the JAX package has none: the
    backward recomputes the plain version, so the gradient is autograd's
    through ``dot_product_attention_ref``."""
    q = torch.randn(1, 4, 8, requires_grad=True)
    out = ops.attend(q, q.detach(), q.detach(), None, 0.5)
    out.sum().backward()
    q2 = q.detach().clone().requires_grad_()
    ops.dot_product_attention_ref(q2, q.detach(), q.detach(), None,
                                  0.5).sum().backward()
    torch.testing.assert_close(q.grad, q2.grad, rtol=0, atol=0)


def _qkv(d=64, dtype=torch.float32, b=2, h=3, s=5, sk=7):
    return (torch.zeros(b, h, s, d, dtype=dtype),
            torch.zeros(b, h, sk, d, dtype=dtype),
            torch.zeros(b, h, sk, d, dtype=dtype))


def test_kernel_argument_check():
    """What the CUDA kernel does not take raises MXNetError (checked
    without a card)."""
    for d in (8, 64, 128):
        ta.check_kernel_args(*_qkv(d), torch.ones(2, 7))
    ta.check_kernel_args(*_qkv(64, torch.bfloat16), None)
    bad = [(_qkv(12), "head dim 12"), (_qkv(136), "head dim 136"),
           (_qkv(64, torch.float16), "float16"),
           (_qkv(64, torch.float64), "float64")]
    q, k, v = _qkv()
    bad.append(((q, k.bfloat16(), v), "share one dtype"))
    bad.append(((q, k[:, :, :3], v), "do not fit"))
    bad.append(((q[:, :, :0], k, v), "empty"))
    for args, msg in bad:
        with pytest.raises(MXNetError, match=msg):
            ta.check_kernel_args(*args, None)
    with pytest.raises(MXNetError, match="mask"):
        ta.check_kernel_args(q, k, v, torch.ones(2, 5))
