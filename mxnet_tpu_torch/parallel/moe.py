"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis
(counterpart of ``mxnet_tpu/parallel/moe.py``).

The dense-dispatch formulation (Mesh-TensorFlow / GShard), as in the JAX
package: top-1 routing in fp32 with a fixed per-expert capacity gives
one-hot dispatch and gate-weighted combine tensors [T, E, C]; the
experts' inputs [E, C, D] form by ``einsum`` in fp32; each rank of
``ep`` runs one expert's function over its block of E / ep experts
(``torch.func.vmap`` inside ``_compat.shard_map_unchecked``, whose
``take_block``/``gather`` cut the stacked parameters and the expert
inputs to the rank's block and gather the outputs back); tokens over
capacity are dropped with zero output.

    y, aux = moe_apply(expert_fn, stacked_params, x, gate_logits)
    # aux: {"gate_probs": [T,E] router probabilities,
    #       "dropped_frac": scalar} for load-balance losses

The port's tensors are this rank's rows of the batch (the trainer and
``shard_batch`` split them over ``dp`` x ``fsdp``).  Under a mesh whose
batch axes split the rows, ``x`` and ``gate_logits`` are this rank's
rows, and what the JAX package takes over all T tokens stays global:
the capacity is ``ceil(T_global / E * cf)``, a token's place in its
expert's queue counts the tokens of the lower batch ranks before its
own (each rank's per-expert counts are all-gathered over the batch
group), ``dropped_frac`` is over every token, and the expert inputs are
summed over the batch group (``dist.all_reduce_sum``, whose backward
sums the ranks' cotangents), so each rank's rows of ``y`` are the same
rows of the JAX package's global result.  The gradients of ``x`` and
``gate_logits`` are then this rank's rows of the global ones; that of
the stacked parameters is this rank's rows' share, and the sum over the
batch ranks (``SPMDTrainer``'s gradient all-reduce) is the global one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..base import MXNetError
from . import dist
from ._compat import gather_dim, shard_map_unchecked
from .mesh import BATCH_AXES, DeviceMesh, batch_shards, current_mesh
from .sharding import P

__all__ = ["top1_dispatch", "moe_apply"]


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim, in fp32."""
    z = logits.float()
    u = torch.exp(z - z.amax(-1, keepdim=True).detach())
    return u / u.sum(-1, keepdim=True)


def top1_dispatch(gate_logits, capacity, offset=None):
    """[T, E] logits -> (dispatch [T,E,C] one-hot, combine [T,E,C]
    gate-weighted, dropped_frac scalar, gate probs [T,E] fp32).  Top-1
    routing (ties to the first expert); each expert accepts its first
    ``capacity`` tokens in order, later ones drop.  ``offset`` [E], when
    given, is the number of tokens routed to each expert before these
    rows (the lower batch ranks'): positions count from it."""
    t, e = gate_logits.shape
    probs = _softmax(gate_logits)
    expert = probs.argmax(-1)                                   # [T]
    gate = probs.amax(-1)                                       # [T]
    onehot_e = (expert[:, None] == torch.arange(
        e, device=expert.device)).float()                      # [T, E]
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot_e, 0) * onehot_e - onehot_e
    if offset is not None:
        pos = pos + offset[None, :].float() * onehot_e
    pos_t = pos.sum(-1)                                         # [T]
    keep = pos_t < capacity
    onehot_c = (pos_t.long()[:, None] == torch.arange(
        capacity, device=pos_t.device)).float()                 # [T, C]
    dispatch = (onehot_e[:, :, None] * onehot_c[:, None, :]
                * keep[:, None, None].float())
    combine = dispatch * gate[:, None, None]
    dropped = 1.0 - dispatch.sum() / t
    return dispatch, combine, dropped, probs


def _row_axes(mesh: Optional[DeviceMesh]):
    """The batch axes that split the rows under ``mesh``, else None."""
    if mesh is None or batch_shards(mesh) == 1:
        return None
    return tuple(a for a in BATCH_AXES if mesh.size(a) > 1)


def moe_apply(expert_fn, stacked_params, x, gate_logits, *,
              capacity_factor: float = 1.25,
              mesh: Optional[DeviceMesh] = None, axis_name: str = "ep"):
    """Apply a top-1 MoE layer.

    expert_fn(params_i, tokens [C, D]) -> [C, D'] — ONE expert's
    computation; stacked_params: pytree with leading expert dim E (each
    rank of ``axis_name`` runs its block); x [T, D]; gate_logits [T, E]
    (this rank's rows under a mesh that splits the batch).  Returns (y
    [T, D'], aux dict with 'gate_probs' [T,E] fp32 and 'dropped_frac'
    scalar — feed them to a load-balance loss).
    """
    t, _d = x.shape
    e = gate_logits.shape[-1]
    first = pytree.tree_leaves(stacked_params)[0]
    if first.shape[0] != e:
        raise MXNetError(
            f"stacked expert dim {first.shape[0]} != gate width {e}")
    mesh = mesh or current_mesh()
    rows = _row_axes(mesh)
    t_all = t * (1 if rows is None else mesh.size(rows))
    capacity = max(1, math.ceil(t_all / e * capacity_factor))
    offset = None
    if rows is not None:
        # each batch rank's tokens per expert, in batch order; this
        # rank's queue positions start after the lower ranks' tokens
        with torch.no_grad():
            picks = _softmax(gate_logits).argmax(-1)
            counts = torch.bincount(picks, minlength=e).float()
            every = gather_dim(counts[None], 0, rows, mesh)
            offset = every[:mesh.index(rows)].sum(0)
    dispatch, combine, dropped, probs = top1_dispatch(gate_logits,
                                                      capacity, offset)
    if rows is not None:
        with torch.no_grad():
            kept = dist.all_reduce_(dispatch.sum().reshape(1).clone(),
                                    mesh.group(rows))[0]
            dropped = 1.0 - kept / t_all
    ex_in = torch.einsum("tec,td->ecd", dispatch, x.float()).to(x.dtype)
    if rows is not None:
        ex_in = dist.all_reduce_sum(ex_in, mesh.group(rows))

    def run_local(params, xin):
        return torch.func.vmap(expert_fn)(params, xin)

    if mesh is not None and axis_name in mesh and mesh.size(axis_name) > 1:
        if e % mesh.size(axis_name):
            raise MXNetError(
                f"experts ({e}) must divide over '{axis_name}' "
                f"({mesh.size(axis_name)})")
        leaves, spec = pytree.tree_flatten(stacked_params)
        p_specs = [P(axis_name, *([None] * (a.ndim - 1))) for a in leaves]

        def body(*args):
            return run_local(pytree.tree_unflatten(list(args[:-1]), spec),
                             args[-1])

        fn = shard_map_unchecked(
            body, mesh=mesh,
            in_specs=p_specs + [P(axis_name, None, None)],
            out_specs=P(axis_name, None, None))
        ex_out = fn(*leaves, ex_in)
    else:
        ex_out = run_local(stacked_params, ex_in)

    y = torch.einsum("tec,ecd->td", combine, ex_out.float()).to(x.dtype)
    return y, {"gate_probs": probs, "dropped_frac": dropped}
