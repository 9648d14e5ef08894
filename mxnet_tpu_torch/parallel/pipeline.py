"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
``mxnet_tpu/parallel/pipeline.py``).

:func:`pipeline_apply` runs a stack of identical stages (transformer
blocks, say) whose stacked parameters are split over ``pp``: rank i of
the ``pp`` group holds stage i's block (``_compat.take_block``, whose
backward all-gathers the blocks' gradients, so every rank ends with the
whole stacked gradient).  Microbatches stream through the ring in the
JAX package's GPipe ticks, M + S - 1 of them: each tick stage 0 takes
microbatch t, every rank runs its stage on its current activation (the
bubble ticks too, on zeros or on what the ring brought, as the JAX loop
runs them), the last stage's output is collected, and the activations
move one hop with ``dist.ppermute``, the differentiable ``ring_shift``
(its backward moves the cotangents one hop back).  The last stage's
outputs then reach every rank by ``dist.take_from``, the JAX masked
psum, whose backward hands the replicated cotangent to the last stage
alone.  The input reaches the stages through the feed of stage 0, so
its cotangent is summed over ``pp`` (the transpose of an input that
``shard_map`` replicates over an axis), and every rank holds it.  Every
rank runs every collective of the forward and of the backward in the
same order: the feed and the collected outputs go through the same ops
on every rank, selected with ``torch.where`` as the JAX body selects.
The gradients of the stacked parameters and of ``x`` are those of the
sequential stack, as ``jax.grad`` of the JAX function gives them.

The port's tensors are this rank's rows of the batch: under a mesh
whose batch axes split it, ``x`` is this rank's rows and each of its M
microbatches its share of one microbatch (the JAX ``x_spec`` splits each
microbatch over the batch axes; a rank's microbatch j is its j-th block
of rows, which for a stage that treats rows alone, as a transformer
block does, gives each row the same result).  The stacked parameters'
gradient is then this rank's rows' share, summed over the batch ranks
by ``SPMDTrainer``.

:class:`HeteroPipeline` runs stages of any shapes, one function and one
parameter tree a stage, each on its own device: a plain loop over
microbatches and stages (PyTorch's launches return at once, so stage i
computes while stage i + 1 takes the previous microbatch), and
``value_and_grad`` is GPipe with recompute: the forward keeps each
stage's inputs, and each stage's backward runs its forward again under
autograd for the vector-Jacobian product.  Stage functions are pure, as
the JAX package's are: a stage built from Gluon blocks
(``torch.func.functional_call``) reads the BatchNorm running statistics
and writes none, or the recompute would count a microbatch twice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..base import MXNetError
from ..context import resolve
from . import dist
from ._compat import take_block
from .mesh import DeviceMesh, current_mesh
from .sharding import P

__all__ = ["pipeline_apply", "stack_stage_params", "HeteroPipeline"]


def _to(tree, dev):
    return pytree.tree_map(lambda a: torch.as_tensor(a).to(dev), tree)


class HeteroPipeline:
    """GPipe over HETEROGENEOUS stages — each stage has its own
    parameter tree, its own activation shapes, and its own device
    (``devices=None``: the CUDA devices round-robin; a CPU run passes
    CPU devices).

        pipe = HeteroPipeline([f0, f1, f2], [p0, p1, p2])
        y = pipe(x, n_microbatch=4)                       # inference
        loss, grads = pipe.value_and_grad(loss_fn, x, labels,
                                          n_microbatch=4)  # training
    """

    def __init__(self, stage_fns, stage_params, devices=None):
        if len(stage_fns) != len(stage_params):
            raise MXNetError("one params pytree per stage required")
        self.n_stages = len(stage_fns)
        if devices is None:
            count = torch.cuda.device_count()
            if count == 0:  # no silent CPU stages
                raise MXNetError(
                    "HeteroPipeline: devices=None places the stages on the "
                    "CUDA devices and there is none; pass devices (CPU "
                    "devices for a CPU run)")
            devices = [torch.device("cuda", i % count)
                       for i in range(self.n_stages)]
        if len(devices) != self.n_stages:
            raise MXNetError(
                f"{len(devices)} devices for {self.n_stages} stages")
        self.devices = [resolve(d) for d in devices]
        self.params = [_to(p, d) for p, d in zip(stage_params, self.devices)]
        self._fns = list(stage_fns)

    def _microbatches(self, x, n_microbatch):
        if x.shape[0] % n_microbatch:
            raise MXNetError(
                f"batch {x.shape[0]} not divisible by {n_microbatch}")
        m = x.shape[0] // n_microbatch
        return [x[j * m:(j + 1) * m] for j in range(n_microbatch)]

    def _forward_saved(self, x, n_microbatch):
        """Run all microbatches through all stages; returns per-stage
        INPUT activations (the recompute's residuals) and the outputs."""
        acts = [self._microbatches(x, n_microbatch)]
        with torch.no_grad():
            for i in range(self.n_stages):
                dev = self.devices[i]
                ins = [a.to(dev) for a in acts[i]]
                acts[i] = ins  # keep the device-placed copy as residual
                acts.append([self._fns[i](self.params[i], a) for a in ins])
        return acts

    def __call__(self, x, n_microbatch=1):
        acts = self._forward_saved(torch.as_tensor(x), n_microbatch)
        return torch.cat([y.to(self.devices[-1]) for y in acts[-1]], 0)

    def _bwd(self, i, a, g):
        """(parameter gradients, input gradient) of stage i at input
        ``a`` for the output cotangent ``g``: the forward run again under
        autograd (recompute-for-backward)."""
        leaves, spec = pytree.tree_flatten(self.params[i])
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(p.is_floating_point())
                  for p in leaves]
            a = a.detach().requires_grad_(a.is_floating_point())
            wrt = [t for t in ps + [a] if t.requires_grad]
            y = self._fns[i](pytree.tree_unflatten(ps, spec), a)
            got = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        grads = [(next(got) if t.requires_grad else None) for t in ps + [a]]
        grads = [torch.zeros_like(t) if gr is None else gr
                 for gr, t in zip(grads, ps + [a])]
        return pytree.tree_unflatten(grads[:-1], spec), grads[-1]

    def value_and_grad(self, loss_fn, x, *labels, n_microbatch=1):
        """Mean loss over the batch + per-stage parameter grads (each on
        its stage's device).  loss_fn(y_micro, *labels_micro) -> scalar
        mean over the microbatch."""
        acts = self._forward_saved(torch.as_tensor(x), n_microbatch)
        last = self.devices[-1]
        lab_mb = [self._microbatches(torch.as_tensor(lb).to(last),
                                     n_microbatch) for lb in labels]
        losses, gys = [], []
        for j, y in enumerate(acts[-1]):
            with torch.enable_grad():
                yl = y.detach().requires_grad_()
                lv = loss_fn(yl, *[lm[j] for lm in lab_mb])
                gy, = torch.autograd.grad(lv, yl)
            losses.append(lv.detach())
            gys.append(gy)
        gparams = [None] * self.n_stages
        for i in reversed(range(self.n_stages)):
            dev = self.devices[i]
            nxt = []
            for j in range(n_microbatch):
                gp, ga = self._bwd(i, acts[i][j], gys[j].to(dev))
                gparams[i] = gp if gparams[i] is None else \
                    pytree.tree_map(torch.add, gparams[i], gp)
                nxt.append(ga)
            gys = nxt
        # microbatch-mean: losses average; grads scale by 1/M (loss_fn
        # is a per-microbatch mean, so the sum over microbatches must be
        # averaged too)
        scale = 1.0 / n_microbatch
        gparams = [pytree.tree_map(lambda a: a * scale, gp)
                   for gp in gparams]
        loss = sum(float(lv) for lv in losses) * scale
        return float(loss), gparams


def stack_stage_params(params_list):
    """[{name: arr}, ...] per stage -> {name: arr[S, ...]} stacked tree
    (the layout whose leading dim is split over 'pp')."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *params_list)


class _SumOver(torch.autograd.Function):
    """Identity whose backward sums the cotangent over ``group``: an
    input that the group's ranks hold alike and use in turns."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return dist.all_reduce_(g.contiguous().clone(), ctx.group), None


def _pipeline_local(sparams, x_micro, stage_fn, mesh: DeviceMesh,
                    axis_name):
    """This rank's part of the pipeline.

    sparams: this rank's stage parameters; x_micro: [M, b, ...] this
    rank's microbatches (the same on every rank of ``axis_name``).
    Returns the last stage's outputs [M, b, ...] on every rank.
    """
    n = mesh.size(axis_name)
    idx = mesh.coord(axis_name)
    group = mesh.group(axis_name)
    ring = mesh.group_ranks(axis_name)  # global ranks in stage order
    send_to, recv_from = ring[(idx + 1) % n], ring[(idx - 1) % n]
    m = x_micro.shape[0]
    ticks = m + n - 1

    state = torch.zeros_like(x_micro[0])     # current activation
    outs = [None] * m
    feeds = torch.tensor([True, False], device=x_micro.device)
    for t in range(ticks):
        # stage 0 ingests microbatch t (if any) instead of the ring input
        feed = x_micro[min(t, m - 1)]
        first = feeds[0 if idx == 0 and t < m else 1]
        y = stage_fn(sparams, torch.where(first, feed, state))
        # the last stage emits microbatch t - (n - 1); every rank keeps
        # its output there, and take_from keeps the last stage's
        if t >= n - 1:
            outs[t - (n - 1)] = y
        if t + 1 < ticks:  # the last tick's shift would go unread
            state = dist.ppermute(y, send_to, recv_from, group)
    return dist.take_from(torch.stack(outs), ring[n - 1], group)


def pipeline_apply(stage_fn: Callable, stacked_params, x,
                   n_microbatch: int, *, mesh: Optional[DeviceMesh] = None,
                   axis_name: str = "pp", batch_axes=("dp", "fsdp")):
    """Run `x` [B, ...] through S pipelined stages.

    stage_fn(params_i, x) -> y with y.shape == x.shape (homogeneous
    stages — the transformer-block case).
    stacked_params: pytree with leading dim S == mesh.size('pp').
    ``x`` is this rank's rows where the mesh's ``batch_axes`` split the
    batch (see the module docstring).
    """
    mesh = mesh or current_mesh()
    if mesh is None:
        raise MXNetError("pipeline_apply requires an active mesh")
    n = mesh.size(axis_name)
    first = pytree.tree_leaves(stacked_params)[0]
    if first.shape[0] != n:
        raise MXNetError(
            f"stacked stage dim {first.shape[0]} != mesh '{axis_name}' size {n}")
    if x.shape[0] % n_microbatch:
        raise MXNetError(
            f"batch {x.shape[0]} not divisible by n_microbatch {n_microbatch}")
    if n == 1:
        sparams = pytree.tree_map(lambda a: a[0], stacked_params)
        return stage_fn(sparams, x)

    sparams = pytree.tree_map(
        lambda a: take_block(a, P(axis_name, *([None] * (a.ndim - 1))),
                             mesh)[0], stacked_params)
    x = _SumOver.apply(x, mesh.group(axis_name))
    mb = x.reshape((n_microbatch, x.shape[0] // n_microbatch) + x.shape[1:])
    out = _pipeline_local(sparams, mb, stage_fn, mesh, axis_name)
    return out.reshape(x.shape)
