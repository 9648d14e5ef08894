"""Ring attention over the ``sp`` mesh axis (counterpart of
``mxnet_tpu/parallel/ring.py``).

Sequence parallelism for long contexts: rank i of the ``sp`` group holds
the [B, H, L/n, D] block i of q, k and v, and the k/v blocks rotate
around the ring (``dist.ring_shift``, one ``batch_isend_irecv`` to the
next rank of the group a hop) while each rank accumulates its queries'
attention with an online softmax in fp32, so the [L, L] score matrix is
never formed.  The forward is the JAX package's arithmetic: K/V rotated
n - 1 times, the causal mask in global positions at ``finfo.min``, fully
masked rows zeroed (``p = where(s > neg / 2, p, 0)``), ``l`` clamped at
1e-20, the output cast to q's dtype.

``torch.distributed`` point-to-point has no autograd, so the ring is a
``torch.autograd.Function``.  Its backward is a second ring: each rank
recomputes its queries' scores against every k/v block from the saved
row maxima and sums (their log-sum-exp), keeps dQ, and carries the dK
and dV accumulators around the ring with their block, back to the block's
owner.

The products are ``torch.matmul`` (the JAX module's are ``einsum``; no
Pallas kernel is involved).  The port's tensors are already this rank's
rows of the batch (the trainer and ``shard_batch`` split them over
``dp``/``fsdp``), and outside attention the ranks of ``sp`` hold the same
activations, as the JAX package's long-context LM places its tokens with
the batch spec only: :func:`ring_attention_sharded` takes this rank's
sequence block of q, k and v (whose backward all-gathers the block's
gradient, so the full q/k/v gradient is again the same on every rank of
``sp``) and all-gathers the output blocks over ``sp`` (whose backward
keeps this rank's block of the cotangent, which every rank holds alike:
no sum, or the gradient would come out n-fold).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..base import MXNetError
from . import dist
from ._compat import shard_map_unchecked
from .mesh import DeviceMesh, current_mesh
from .sharding import P

__all__ = ["ring_attention", "ring_attention_sharded",
           "sharded_seq_attention", "local_attention"]


def local_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset=0, k_offset=0):
    """Plain attention [B,H,Lq,D] x [B,H,Lk,D] with an optional causal
    mask in GLOBAL positions (the offsets give each block its place)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / torch.tensor(math.sqrt(d), dtype=torch.float32).to(
            q.dtype)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s,
                        torch.tensor(torch.finfo(s.dtype).min, dtype=s.dtype,
                                     device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)


def _scores(qf, kb, causal, q0, k0, neg):
    """fp32 scores of the scaled queries ``qf`` against the key block
    ``kb``, masked in global positions (query block at q0, keys at k0)."""
    s = torch.matmul(qf, kb.float().transpose(-1, -2))
    if causal:
        qpos = q0 + torch.arange(qf.shape[2], device=qf.device)[:, None]
        kpos = k0 + torch.arange(kb.shape[2], device=qf.device)[None, :]
        s = torch.where(qpos >= kpos, s, neg)
    return s


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        n, idx = mesh.size(axis), mesh.coord(axis)
        group = mesh.group(axis)
        nxt = mesh.rank_of({axis: (idx + 1) % n})
        prv = mesh.rank_of({axis: (idx - 1) % n})
        lq, lk = q.shape[2], k.shape[2]
        neg = torch.tensor(torch.finfo(torch.float32).min,
                           device=q.device)
        qf = q.float() * scale
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[:3], torch.finfo(torch.float32).min,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for i in range(n):
            src = (idx - i) % n  # the global block of the current K/V
            s = _scores(qf, kb, causal, idx * lq, src * lk, neg)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            if causal:  # fully masked rows give exp(neg - neg) = 1
                p = torch.where(s > neg / 2, p, 0.0)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.matmul(p, vb.float())
            m = m_new
            if i < n - 1:
                kb, vb = dist.ring_shift([kb, vb], nxt, prv, group)
        l = l.clamp_min(1e-20)
        out = o / l[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.cfg = (mesh, axis, causal, scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.cfg
        n, idx = mesh.size(axis), mesh.coord(axis)
        group = mesh.group(axis)
        nxt = mesh.rank_of({axis: (idx + 1) % n})
        prv = mesh.rank_of({axis: (idx - 1) % n})
        lq, lk = q.shape[2], k.shape[2]
        neg = torch.tensor(torch.finfo(torch.float32).min,
                           device=q.device)
        qf = q.float() * scale
        do = dout.float()
        delta = (do * out).sum(-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for i in range(n):
            src = (idx - i) % n
            s = _scores(qf, kb, causal, idx * lq, src * lk, neg)
            p = torch.exp(s - lse[..., None])
            if causal:
                p = torch.where(s > neg / 2, p, 0.0)
            dv = dv + torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, vb.float().transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(ds, kb.float())
            dk = dk + torch.matmul(ds.transpose(-1, -2), qf)
            # the accumulators travel with their block and arrive home
            # after n hops; the last hop carries them alone
            if i < n - 1:
                kb, vb, dk, dv = dist.ring_shift([kb, vb, dk, dv], nxt, prv,
                                                 group)
            else:
                dk, dv = dist.ring_shift([dk, dv], nxt, prv, group)
        return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, axis_name: str = "sp", *, causal: bool = False,
                   scale: Optional[float] = None,
                   mesh: Optional[DeviceMesh] = None):
    """Per-shard body: q, k, v are this rank's [B, H, L_local, D] blocks
    of the sequence over ``axis_name`` of ``mesh`` (default: the active
    one).  Online softmax in fp32; K/V rotate n - 1 times."""
    mesh = mesh or current_mesh()
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    return _Ring.apply(q, k, v, mesh, axis_name, bool(causal), float(scale))


def sharded_seq_attention(body, q, k, v, *,
                          mesh: Optional[DeviceMesh] = None,
                          axis_name: str = "sp", causal: bool = False,
                          scale: Optional[float] = None,
                          batch_axes=("dp", "fsdp"),
                          entry_name="attention"):
    """The entry-point plumbing of every sequence-parallel layout (ring,
    Ulysses): dense attention when ``axis_name`` is absent or of size 1,
    else ``body`` on this rank's sequence block of q, k and v, the
    output blocks gathered over ``axis_name``.  ``batch_axes`` is the JAX
    signature's: the port's tensors already hold this rank's rows."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise MXNetError(f"{entry_name} requires an active mesh")
    if axis_name not in mesh or mesh.size(axis_name) == 1:
        return local_attention(q, k, v, causal=causal, scale=scale)
    spec = P(None, None, axis_name, None)
    fn = shard_map_unchecked(
        functools.partial(body, axis_name=axis_name, causal=causal,
                          scale=scale, mesh=mesh),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)


def ring_attention_sharded(q, k, v, **kw):
    """User entry: q, k, v are [B, H, L, D], the same on every rank of
    ``sp``; runs the ring over their sequence blocks."""
    return sharded_seq_attention(ring_attention, q, k, v,
                                 entry_name="ring_attention_sharded", **kw)
