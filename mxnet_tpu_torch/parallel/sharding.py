"""Sharding of the port (counterpart of
``mxnet_tpu/parallel/sharding.py``).

The JAX package returns a ``NamedSharding`` that GSPMD applies to a
global array.  Here each rank is a process, so the placement is done by
hand.  :func:`shard_batch` gives a rank its rows of the global batch:
the block of dim 0 that GSPMD gives its ``dp`` x ``fsdp`` position
(``DeviceMesh.batch_index``); the ranks along the other axes hold the
same rows.  Random draws over the batch (dropout masks) follow the same
rule: :func:`rand_batch` draws over the global batch and keeps this
rank's block.

The JAX package's placement rules are kept as data: :class:`PartitionSpec`
(``P``, a tuple of one entry per dim: an axis name, a tuple of them, or
None), :class:`ShardingRules` (regex on a parameter name -> spec, the
same ``DEFAULT_RULES`` and the same fsdp fallback), :func:`filter_spec`
(an axis the mesh lacks is dropped) and :func:`zero_state_spec` (the
ZeRO-1 layout of an optimizer state, a split parameter's included).
:func:`named_sharding` and :func:`replicated` give a
:class:`NamedSharding`, here the descriptor of this rank's block of a
global tensor (``block``/``gather``, ``parallel._compat``), and
:func:`constraint` returns its value unchanged: a rank's tensors already
are its blocks.  ``SPMDTrainer`` reads all of them.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from .mesh import (BATCH_AXES, DeviceMesh, batch_shards, current_mesh,
                   get_mesh)

__all__ = ["shard_batch", "rand_batch", "PartitionSpec", "P",
           "ShardingRules", "DEFAULT_RULES", "filter_spec",
           "zero_state_spec", "spec_split", "input_split", "NamedSharding",
           "named_sharding", "replicated", "constraint"]


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


def input_split(spec, mesh: DeviceMesh, shape=None) -> bool:
    """Whether an input of spec ``spec`` splits the batch's rows: its
    dim 0 over a batch axis of size > 1 (``P("dp")``, ``P(("dp",),
    "sp")``, ``P("fsdp")`` on a dp x fsdp mesh), which gives each rank its
    block of rows over all of the batch axes, as the default ``None``
    does (``shard_batch``).  Any other spec splits no rows: GSPMD would
    place such an array in blocks, but the step it computes is the
    global one, so the input is placed whole on each rank; splits of
    other dims (over ``tp``, ``pp``, ``ep``, ``sp``, or a batch axis on
    dim 1) change placement only.  Under ``sp`` the ranks hold the same
    activations outside attention, as in the JAX package's long-context
    LM, and ring/Ulysses attention takes its block of q, k and v.  As
    JAX's ``device_put`` does, an axis the mesh lacks raises, and with
    the input's ``shape`` so do a spec longer than its rank and a dim
    that its axes do not divide."""
    names = tuple(mesh.axis_sizes)
    for entry in spec:
        for a in _axes_of(entry):
            if a not in mesh:
                raise MXNetError(f"Resource axis: {a} of {P(*spec)!r} is "
                                 f"not found in mesh: {names}.")
    if shape is not None:
        shape = tuple(shape)
        if len(spec) > len(shape):
            raise MXNetError(
                f"partition spec {P(*spec)!r} is only valid for values of "
                f"rank at least {len(spec)}, but was applied to a value of "
                f"rank {len(shape)}.")
        for d, entry in enumerate(spec):
            k = mesh.size(_axes_of(entry))
            if shape[d] % k:
                raise MXNetError(
                    f"partition spec {P(*spec)!r}: dim {d} of an input of "
                    f"shape {shape} does not divide into {k} blocks")
    return bool(spec) and any(a in BATCH_AXES and mesh.size(a) > 1
                              for a in _axes_of(spec[0]))


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
    mesh and divides its shape wins (a rule whose axes are all absent or
    of size 1 is vacuous and falls through; an explicit ``P()`` pins);
    with ``fsdp`` > 1 an unmatched parameter of at least
    ``fsdp_min_size`` elements splits its largest dim that fsdp divides
    (the ZeRO-3 layout); else it is replicated (``P()``).  The names are
    the JAX package's: ``SPMDTrainer`` matches each parameter's MXNet
    name (``gluon.block.mx_param_names``)."""

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
        n_fsdp = mesh.size("fsdp")
        if "fsdp" in mesh and n_fsdp > 1 and shape:
            n = 1
            for d in shape:
                n *= int(d)
            if n >= self.fsdp_min_size:
                for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                    if shape[i] % n_fsdp == 0:
                        dims = [None] * len(shape)
                        dims[i] = "fsdp"
                        return P(*dims)
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


class NamedSharding:
    """A spec on a mesh: the descriptor of this rank's block of a global
    tensor (the JAX class's ``mesh``, ``spec`` and
    ``is_fully_replicated``); ``block(x)`` cuts this rank's block of the
    global ``x`` and ``gather(b)`` puts the ranks' blocks back together
    (``parallel._compat``)."""

    def __init__(self, mesh: DeviceMesh, spec):
        self.mesh = mesh
        self.spec = filter_spec(spec, mesh)

    @property
    def is_fully_replicated(self) -> bool:
        return spec_split(self.spec, self.mesh) == 1

    def block(self, x: torch.Tensor) -> torch.Tensor:
        from ._compat import block_of

        return block_of(x, self.spec, self.mesh)

    def gather(self, b: torch.Tensor) -> torch.Tensor:
        from ._compat import gather_blocks

        return gather_blocks(b, self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named_sharding(spec, mesh: Optional[DeviceMesh] = None) -> NamedSharding:
    mesh = mesh or current_mesh()
    if mesh is None:
        raise MXNetError("named_sharding requires an active DeviceMesh")
    return NamedSharding(mesh, spec)


def replicated(mesh: Optional[DeviceMesh] = None) -> NamedSharding:
    return NamedSharding(mesh or get_mesh(), P())


def constraint(value, spec, mesh: Optional[DeviceMesh] = None):
    """The JAX package's ``with_sharding_constraint`` inside a traced
    forward: a placement hint that does not change the value.  A rank's
    tensors are already its blocks, so the value comes back as it is."""
    return value


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
    r = mesh.batch_index()
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
    mesh = current_mesh()
    shards = batch_shards(mesh)
    if shards == 1:
        return torch.rand(shape, generator=generator, device=device)
    rows = shape[0]
    full = torch.rand((rows * shards,) + tuple(shape[1:]),
                      generator=generator, device=device)
    r = mesh.batch_index()
    return full[r * rows:(r + 1) * rows]
