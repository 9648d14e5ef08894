"""Sharding of the port (counterpart of
``mxnet_tpu/parallel/sharding.py``).

The JAX package returns a ``NamedSharding`` that GSPMD applies to a
global array.  Here each rank is a process, so :func:`shard_batch` does
the placement itself: rank r keeps the contiguous block r of dim 0, the
block GSPMD gives device r of the ``dp`` axis.  Random draws over the
batch (dropout masks) follow the same rule: :func:`rand_batch` draws
over the global batch and keeps this rank's block.

The JAX package's placement rules are kept as data: :class:`PartitionSpec`
(``P``, a tuple of one entry per dim: an axis name, a tuple of them, or
None), :class:`ShardingRules` (regex on a parameter name -> spec, the
same ``DEFAULT_RULES``), :func:`filter_spec` (an axis the mesh lacks is
dropped) and :func:`zero_state_spec` (the ZeRO-1 layout of an optimizer
state).  ``SPMDTrainer`` reads them: parameters stay replicated on the
port's dp-only meshes (a rule that would split one raises), and a state
whose spec splits a dim over ``dp`` keeps only this rank's block of it.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from . import dist
from .mesh import DeviceMesh, batch_shards, current_mesh, get_mesh

__all__ = ["shard_batch", "rand_batch", "PartitionSpec", "P",
           "ShardingRules", "DEFAULT_RULES", "filter_spec",
           "zero_state_spec", "spec_split", "is_batch_spec"]


class PartitionSpec(tuple):
    """``P("dp", None)``: one entry a dim (an axis name, a tuple of axis
    names or None); dims past the last entry are replicated.  A stand-in
    for ``jax.sharding.PartitionSpec`` with the same constructor."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def filter_spec(spec, mesh: DeviceMesh) -> PartitionSpec:
    """Drop the axes the mesh doesn't have (the JAX package's
    ``_filter_spec``): an unknown axis name in a rule is replicated."""
    out = []
    for entry in spec:
        kept = tuple(a for a in _axes_of(entry) if a in mesh)
        if isinstance(entry, (tuple, list)):
            out.append(kept if kept else None)
        else:
            out.append(kept[0] if kept else None)
    return P(*out)


def spec_split(spec, mesh: DeviceMesh) -> int:
    """How many ways ``spec`` splits data on ``mesh``."""
    k = 1
    for entry in spec:
        for a in _axes_of(entry):
            k *= mesh.size(a)
    return k


def is_batch_spec(spec, mesh: DeviceMesh) -> bool:
    """Whether an input spec splits dim 0 over the batch axes (and no
    other dim), as the default ``None`` does; a spec that splits no dim
    is replicated; any other split raises (the port's meshes split the
    batch only)."""
    spec = filter_spec(spec, mesh)
    rest = P(*spec[1:])
    if spec_split(rest, mesh) != 1:
        raise MXNetError(f"partition spec {spec!r}: the port splits only "
                         "dim 0 of an input over the batch axes (sequence "
                         "and tensor parallelism are ROADMAP queue A item "
                         "7, cut (b))")
    return bool(spec) and spec_split(P(spec[0]), mesh) > 1


def zero_state_spec(param_spec, shape: Sequence[int], mesh: DeviceMesh,
                    axes: Sequence[str] = ("dp", "fsdp"),
                    min_size: int = 2 ** 11) -> PartitionSpec:
    """The spec of an optimizer-state tensor under ZeRO-1 weight-update
    sharding (arXiv:2004.13336), the JAX package's rule: the state
    follows its parameter's spec, plus every data axis of size > 1 the
    parameter does not use, on the largest dim that it divides evenly.
    A tensor below ``min_size`` elements keeps the parameter's spec."""
    used = {a for e in param_spec for a in _axes_of(e)}
    free = [a for a in axes
            if a in mesh and mesh.size(a) > 1 and a not in used]
    if not free or not shape:
        return P(*param_spec)
    n = 1
    for d in shape:
        n *= int(d)
    if n < min_size:
        return P(*param_spec)
    k = 1
    for a in free:
        k *= mesh.size(a)
    dims = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if dims[i] is None and shape[i] % k == 0:
            dims[i] = tuple(free) if len(free) > 1 else free[0]
            return P(*dims)
    return P(*param_spec)


class ShardingRules:
    """Ordered (regex, spec) table resolved per parameter name, the JAX
    package's: the first rule that matches, splits the parameter on this
    mesh and divides its shape wins; no match is replicated (``P()``).
    On the port's meshes every axis but ``dp`` has size 1, so the
    Megatron rules of ``DEFAULT_RULES`` fall through to replicated."""

    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]] = (),
                 fsdp_min_size: int = 2 ** 14):
        self.rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]
        self.fsdp_min_size = fsdp_min_size

    def spec_for(self, name: str, shape: Sequence[int],
                 mesh: DeviceMesh) -> PartitionSpec:
        for pat, spec in self.rules:
            if not pat.match(name):
                continue
            s = filter_spec(spec, mesh)
            if any(e is not None for e in spec) and spec_split(s, mesh) == 1:
                continue  # vacuous on this mesh; an explicit P() pins
            if all(d % spec_split(P(e), mesh) == 0
                   for d, e in zip(shape, s)):
                return s
        return P()


DEFAULT_RULES = ShardingRules([
    (r".*(qkv|query|key|value|q_proj|k_proj|v_proj).*weight$", P("tp", None)),
    (r".*(qkv|query|key|value|q_proj|k_proj|v_proj).*bias$", P("tp")),
    (r".*(out_proj|o_proj|proj_o|attn.*out).*weight$", P(None, "tp")),
    (r".*(ffn.*(up|gate)|fc1|w1|wi|intermediate).*weight$", P("tp", None)),
    (r".*(ffn.*(up|gate)|fc1|w1|wi|intermediate).*bias$", P("tp")),
    (r".*(ffn.*down|fc2|w2|wo|output.*dense).*weight$", P(None, "tp")),
    (r".*embed.*weight$", P("tp", None)),
    (r".*expert.*", P("ep", None, None)),
])


def shard_batch(x: torch.Tensor,
                mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (a view).  A batch that
    the mesh's batch shards do not divide raises: the port has no
    fallback for it (the JAX package's fused unit takes its XLA plan)."""
    mesh = mesh or get_mesh()
    shards = batch_shards(mesh)
    if shards == 1:
        return x
    n = x.shape[0]
    if n % shards:
        raise MXNetError(f"shard_batch: a batch of {n} rows does not divide "
                         f"into {shards} shards of mesh {mesh!r}")
    rows = n // shards
    r = dist.rank()
    return x[r * rows:(r + 1) * rows]


def rand_batch(shape, generator: torch.Generator,
               device) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows, dim 0 being its block
    of the batch (or batch-major rows, as (B*H, ...)).  Under a mesh that
    splits the batch over N ranks every rank draws the tensor of the
    global batch, N times as many rows, from the generator state they
    share, and keeps its block r: the ranks together use the draw that
    one device makes for the whole batch, as the JAX package draws one
    mask a step from one key, and their generators stay in step."""
    shards = batch_shards(current_mesh())
    if shards == 1:
        return torch.rand(shape, generator=generator, device=device)
    rows = shape[0]
    full = torch.rand((rows * shards,) + tuple(shape[1:]),
                      generator=generator, device=device)
    r = dist.rank()
    return full[r * rows:(r + 1) * rows]
