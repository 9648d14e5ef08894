"""Fused scaled-dot-product attention: CUDA kernel + plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_attention.py``.  The op
:func:`dot_product_attention` takes the JAX package's surface (packed
(B,S,U) or head-split (B,H,S,D) layouts, a (B,Sk) key-validity mask,
causal, dropout on the probabilities in training) and returns the
input's layout.

Without dropout it runs :func:`attend`'s math: on CUDA tensors the
hand-written sm_90a kernel in ``csrc/attention.cu`` (built by
``_kernels``), reading the packed or head-split layout through strides,
or the call raises; on CPU tensors :func:`dot_product_attention_ref`,
the plain version the tests hold the JAX package against.  In bf16 the
kernel is a persistent wgmma kernel over work units of (batch, head, 128
query rows): q, k and v arrive by TMA, and with Sk <= 128 it computes
q·kᵀ once and keeps P in registers (one pass); longer keys take two
passes, max and sum first, then P (:func:`launch_plan`).  There is no
probe and no fallback to the plain version on the card.  With ``train``
and ``dropout > 0`` it runs the plain math with dropout on the
probabilities, drawn from the caller's ``torch.Generator``, as the JAX
package runs its XLA path there.

The kernel sits inside a ``torch.autograd.Function`` that saves q, k,
v and the mask, never P.  Its backward recomputes the plain version per
(batch, head) under autograd and returns dq, dk and dv: this is the JAX
package's own backward (``_attend_bwd``, a ``jax.vjp`` of
``dot_product_attention_ref`` in XLA), not a fallback of the kernel, and
the JAX package has no backward kernel.  The dropout path is plain
PyTorch and autograd differentiates it, as JAX differentiates its XLA
twin.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _graphs, _kernels
from ..base import MXNetError
from .registry import register_op

__all__ = ["dot_product_attention", "dot_product_attention_ref", "attend",
           "check_kernel_args", "launch_plan", "AttentionPlan",
           "attention_launch_count", "reset_attention_launch_count"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_MASKED = -1e30      # finite: a row with every key masked stays uniform
# the kernel's tiles: bf16 (wgmma) takes 128 query rows a unit and keys in
# tiles of 128, fp32 (FMA) 64 and 64
_TILE = {torch.bfloat16: 128, torch.float32: 64}
_MAX_UNITS = 2 ** 31 - 1  # work units the kernel's 1-D grid can name


class AttentionPlan(NamedTuple):
    """One launch of the attention kernel."""
    tile: int       # query rows a unit, and keys a tile
    passes: int     # 1: one q·kᵀ, P in registers; 2: max and sum, then P
    head_cols: int  # bf16: the products' width over D (64 or 128); fp32: D
    units: int      # one per (batch, head, query tile): fp32 runs a block
                    # each, bf16 one persistent block an SM walking them


def launch_plan(b, h, s, sk, d, dtype):
    """The kernel's plan for (B,H,S,D) queries and Sk keys.  bf16 makes
    one pass while one key tile holds every key (the score row then sits
    in registers) and two past that; fp32 always makes two."""
    tile = _TILE[dtype]
    if dtype == torch.bfloat16:
        passes, cols = (1 if sk <= tile else 2), (64 if d <= 64 else 128)
    else:
        passes, cols = 2, d
    return AttentionPlan(tile, passes, cols, b * h * -(-s // tile))

# launches of the CUDA kernel (``_kernels.count_launch``); a graph's
# replay adds those its capture recorded
_NAME = "dot_product_attention"


def attention_launch_count() -> int:
    return _kernels.launch_count(_NAME)


def reset_attention_launch_count() -> None:
    _kernels.reset_launch_count(_NAME)


def _scores(q, k, mask, scale, causal):
    """fp32 scores (BH,S,Sk), scaled after the product and masked with
    the finite -1e30 (keys with mask <= 0; causal aligns the last query
    with the last key)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask[:, None, :] > 0, s, _MASKED)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(sq, device=s.device)[:, None] + (sk - sq)
        s = torch.where(qpos >= torch.arange(sk, device=s.device)[None, :],
                        s, _MASKED)
    return s


def _softmax(s):
    """exp(s - max) / sum, as ``jax.nn.softmax`` writes it."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def dot_product_attention_ref(q, k, v, mask, scale, causal=False):
    """Plain version: q (BH,S,D), k/v (BH,Sk,D), mask (BH,Sk) or None.
    Scores in fp32, P rounded to v's dtype, P.V accumulated in fp32 and
    cast to q's dtype."""
    p = _softmax(_scores(q, k, mask, scale, causal)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _attention_with_prob_dropout(q, k, v, mask, scale, rate, generator,
                                 causal=False):
    """The plain math with inverted dropout on the probabilities (rate
    `rate`), the mask drawn from ``generator`` on q's device: this
    rank's (B*H)-rows of the mask of the global batch under data
    parallelism (``parallel.sharding.rand_batch``)."""
    from ..parallel.sharding import rand_batch

    p = _softmax(_scores(q, k, mask, scale, causal)).to(v.dtype)
    keep = 1.0 - rate
    drop = _graphs.segment_value(
        lambda: rand_batch(p.shape, generator, p.device) < keep)
    p = p * drop.to(p.dtype) / keep
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def check_kernel_args(q, k, v, mask):
    """Raise MXNetError for what the CUDA kernel does not take.  q is
    (B,H,S,D), k and v (B,H,Sk,D), mask (B,Sk) or None."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("dot_product_attention: the kernel takes (B,H,S,D) "
                         "query, key and value")
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"dot_product_attention: dtype {q.dtype} is not "
                         f"supported by the CUDA kernel (bfloat16 or "
                         f"float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"dot_product_attention: query, key and value must "
                         f"share one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, h, s, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or v.shape != k.shape:
        raise MXNetError(f"dot_product_attention: key {tuple(k.shape)} and "
                         f"value {tuple(v.shape)} do not fit query "
                         f"{tuple(q.shape)}")
    if d > MAX_HEAD_DIM or d % 8:
        raise MXNetError(f"dot_product_attention: head dim {d} is not "
                         f"supported by the CUDA kernel (a multiple of 8, at "
                         f"most {MAX_HEAD_DIM})")
    if s < 1 or sk < 1 or b * h < 1:
        raise MXNetError(f"dot_product_attention: empty attention (S={s}, "
                         f"Sk={sk}, B*H={b * h})")
    if launch_plan(b, h, s, sk, d, q.dtype).units > _MAX_UNITS:
        raise MXNetError(f"dot_product_attention: grid too large (S={s}, "
                         f"B*H={b * h})")
    if mask is not None and tuple(mask.shape) != (b, sk):
        raise MXNetError(f"dot_product_attention: mask {tuple(mask.shape)} "
                         f"!= (B, Sk) = {(b, sk)}")


def _aligned(t):
    """Unit stride along D and 16-byte aligned base and (batch, head,
    row) strides, none 0 where the dimension has more than one element:
    what the kernel's TMA maps and vector loads need."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st >= 0 for st in t.stride())
            and all(n == 1 or (st > 0 and (st * item) % 16 == 0)
                    for st, n in zip(t.stride()[:3], t.shape[:3])))


def _launch(q, k, v, mask, scale, causal, out):
    """One launch of the CUDA kernel; `out` (B,H,S,D) is written through
    its strides."""
    q, k, v = (t if _aligned(t)
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    if mask is not None:
        mask = mask.contiguous()
    lib = _kernels.load()
    b, h, s, d = q.shape
    sk = k.shape[2]
    plan = launch_plan(b, h, s, sk, d, q.dtype)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), b, h,
            s, sk, d, *strides, float(scale), int(causal), plan.passes,
            stream)
        if rc == 0:
            _kernels.count_launch(_NAME)
    if rc != 0:
        raise MXNetError(f"dot_product_attention: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
    return out


def _out_buffer(q, packed):
    """The output in the input's layout, seen as (B,H,S,D)."""
    b, h, s, d = q.shape
    if packed:
        return torch.empty((b, s, h, d), dtype=q.dtype,
                           device=q.device).permute(0, 2, 1, 3)
    return torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)


def _per_head(fn, q, k, v, mask, *args):
    """``fn`` on (B*H, S, D) views of (B,H,S,D) inputs, the (B,Sk) mask
    repeated per head (``jnp.repeat(..., h, axis=0)``); returns
    (B,H,S,D)."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    maskf = None if mask is None else mask.repeat_interleave(h, dim=0)
    return fn(q.reshape(b * h, s, d), k.reshape(b * h, sk, d),
              v.reshape(b * h, sk, d), maskf, *args).reshape(b, h, s, d)


def _to_layout(out, packed):
    """(B,H,S,D) -> (B,S,H*D) when the input was packed."""
    if not packed:
        return out
    b, h, s, d = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _from_layout(g, packed, shape):
    """A cotangent in the output's layout as (B,H,S,D)."""
    if not packed:
        return g
    b, h, s, d = shape
    return g.reshape(b, s, h, d).permute(0, 2, 1, 3)


class _AttentionFn(torch.autograd.Function):
    """Forward: the CUDA kernel on the card, the plain version on CPU
    tensors; (B,H,S,D) views in, the output in the packed or head-split
    layout out.  Backward: the plain version recomputed from q, k, v and
    the mask (``_attend_bwd``); dq, dk and dv come back in the shapes of
    the (B,H,S,D) views, the mask and the flags get none."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, packed):
        ctx.save_for_backward(q, k, v, mask)
        ctx.args = (scale, causal, packed)
        if q.device.type in ("cpu", "meta"):  # meta: shape inference
            out = _per_head(dot_product_attention_ref, q, k, v, mask, scale,
                            causal)
        else:
            out = _launch(q, k, v, mask, scale, causal,
                          _out_buffer(q, packed))
        return _to_layout(out, packed)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, mask = ctx.saved_tensors
        scale, causal, packed = ctx.args
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _per_head(dot_product_attention_ref, *qkv, mask, scale,
                            causal)
            dq, dk, dv = torch.autograd.grad(
                out, qkv, _from_layout(grad, packed, q.shape))
        return dq, dk, dv, None, None, None, None


def _run(q4, k4, v4, mask, scale, causal, packed):
    devs = {t.device for t in (q4, k4, v4)}
    if mask is not None:
        devs.add(mask.device)
    if len(devs) != 1:
        raise MXNetError(f"dot_product_attention: tensors on different "
                         f"devices {sorted(str(d_) for d_ in devs)}")
    dev = q4.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise MXNetError(f"dot_product_attention: unsupported device {dev}")
    if dev.type == "cuda":
        check_kernel_args(q4, k4, v4, mask)
    return _AttentionFn.apply(q4, k4, v4, mask, float(scale), bool(causal),
                              packed)


def attend(q, k, v, mask, scale, causal=False):
    """The kernel's own surface (counterpart of ``_attend``): q (BH,S,D),
    k/v (BH,Sk,D), mask (BH,Sk) or None; returns (BH,S,D)."""
    if mask is not None:
        mask = mask.to(q.dtype)
    return _run(q[:, None], k[:, None], v[:, None], mask, scale, causal,
                False)[:, 0]


def dot_product_attention(query, key, value, valid_mask=None, num_heads=1,
                          scale=None, dropout=0.0, causal=False, train=False,
                          generator=None):
    """Multi-head scaled-dot-product attention.

    query/key/value: (B, S, U) with U = num_heads * head_dim, or already
    head-split (B, H, S, D).  valid_mask: (B, S_k) 1/0 key-validity mask,
    or None.  With ``train`` and ``dropout > 0`` the probabilities are
    dropped with rate ``dropout``, the mask drawn from ``generator``.
    ``scale`` defaults to 1/sqrt(head_dim).  Returns the input's layout.
    """
    packed = query.dim() == 3
    if packed:
        u, h = query.shape[-1], int(num_heads)
        if u % h:
            raise MXNetError(f"dot_product_attention: units {u} not "
                             f"divisible by num_heads {h}")
        d = u // h

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], h, d).permute(0, 2, 1, 3)
        q4, k4, v4 = split(query), split(key), split(value)
    else:
        q4, k4, v4 = query, key, value
        d = q4.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = None if valid_mask is None else valid_mask.to(q4.dtype)
    if not (train and dropout > 0.0):
        return _run(q4, k4, v4, mask, scale, causal, packed)
    if generator is None:
        raise MXNetError("dot_product_attention: dropout in training draws "
                         "from a torch.Generator; pass generator=")
    return _to_layout(_per_head(_attention_with_prob_dropout, q4, k4, v4,
                                mask, float(scale), float(dropout),
                                generator, causal), packed)


@register_op("dot_product_attention",
             aliases=("FusedAttention", "_contrib_dot_product_attention"))
def _dot_product_attention_op(query, key, value, valid_mask=None,
                              rng_key=None, num_heads=1, scale=None,
                              dropout=0.0, causal=False, _train=False):
    """The framework op (``nd.dot_product_attention``, ``sym``, ``F``)
    under the JAX package's names and defaults: ``rng_key`` is the
    ``torch.Generator`` the probabilities' dropout draws from, and, as
    in the JAX op, dropout applies only with ``_train``, ``dropout > 0``
    and a generator; otherwise the call is :func:`dot_product_attention`
    without dropout (the kernel on the card)."""
    train = bool(_train) and dropout > 0.0 and rng_key is not None
    return dot_product_attention(query, key, value, valid_mask, num_heads,
                                 scale, dropout, causal, train=train,
                                 generator=rng_key)
