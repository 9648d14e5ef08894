"""Named-axis device meshes over torch devices (counterpart of
``mxnet_tpu/parallel/mesh.py``).

A ``DeviceMesh`` arranges devices into a grid with named axes (dp, fsdp,
tp, pp, sp, ep) and is a scope (``with mesh:``) that
:func:`current_mesh` reads.  A mesh of one device runs in this process.
A mesh of more than one device runs one process per mesh position over
a process group (``parallel.dist.init``) whose size is the mesh's.  Rank
r sits where the JAX mesh puts device r: row-major over the axes in the
order they are given (``make_mesh(dp=2, sp=2)``: rank 1 is dp 0, sp 1).
Every axis, and every set of axes, of size > 1 gets its
``torch.distributed`` sub-groups, made in the same order on every rank:
``group(axes)`` is this rank's (None when it spans every rank),
``coord(axis)`` its place along an axis and ``index(axes)`` along several
(row-major in the order given).  The batch is split over ``dp`` x
``fsdp`` (``batch_index``, ``batch_group``), as the JAX package's
``shard_batch`` lays it out; the other axes hold the same rows.
``devices`` lists every rank's device and ``local_device`` is this
rank's.  Devices default to CUDA and never to the CPU; a CPU run passes
``devices=[cpu()]`` (one entry per rank).
"""
from __future__ import annotations

import itertools
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..base import MXNetError
from ..context import current_context, resolve
from . import dist

__all__ = ["DeviceMesh", "make_mesh", "current_mesh", "get_mesh",
           "mesh_shard_plan", "batch_shards", "batch_group", "AXIS_NAMES",
           "BATCH_AXES"]

AXIS_NAMES = ("dp", "fsdp", "tp", "pp", "sp", "ep")
BATCH_AXES = ("dp", "fsdp")  # the axes that split the batch

# (axis sizes, world) -> {axes (in mesh order): this rank's group}: the
# groups of a layout are made once per process, on every rank alike
_GROUPS: Dict[Tuple, Dict[Tuple[str, ...], object]] = {}


def _default_devices(world: int) -> List[torch.device]:
    """One CUDA device per rank, rank r on cuda:(r mod the local count);
    for one process every local card (make_mesh takes what it needs)."""
    current_context()  # raises without CUDA: no silent CPU mesh
    count = torch.cuda.device_count()
    if world == 1:
        return [torch.device("cuda", i) for i in range(count)]
    return [torch.device("cuda", r % count) for r in range(world)]


class DeviceMesh:
    """Axis sizes plus the devices they lay out, row-major."""

    def __init__(self, axes: Dict[str, int],
                 devices: Optional[Sequence] = None):
        if not axes:
            raise MXNetError("DeviceMesh needs at least one axis")
        bad = [a for a in axes if a not in AXIS_NAMES]
        if bad:
            raise MXNetError(f"unknown mesh axes {bad}; known: {AXIS_NAMES}")
        self.axis_sizes = {a: int(s) for a, s in axes.items()}
        need = math.prod(self.axis_sizes.values())
        if need != 1:
            self._check_process_group(axes, need)
        listed = devices is not None
        devices = [resolve(d) for d in devices] if listed \
            else _default_devices(need)
        if need > len(devices):
            raise MXNetError(f"mesh {axes} needs {need} devices, only "
                             f"{len(devices)} available")
        self._devices = devices[:need]
        self._rank = dist.rank() if need > 1 else 0
        self._coords = self.coords_of(self._rank)
        self._groups = self._make_groups() if need > 1 else {}
        # this rank's device: cuda:LOCAL_RANK when a launcher sets it and
        # the caller lists no devices, else this rank's entry
        if need > 1 and not listed and "LOCAL_RANK" in os.environ:
            self.local_device = torch.device(
                "cuda", int(os.environ["LOCAL_RANK"]))
        else:
            self.local_device = self._devices[self._rank]

    @staticmethod
    def _check_process_group(axes, need):
        world = dist.num_workers()
        if world != need:
            raise MXNetError(
                f"mesh {axes} spans {need} devices, one rank each, but the "
                f"process group has {world} rank(s): call "
                f"parallel.dist.init() in each of {need} processes first")

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The mesh position of global rank ``rank``."""
        out, rest = {}, rank
        for a, n in reversed(list(self.axis_sizes.items())):
            out[a] = rest % n
            rest //= n
        return {a: out[a] for a in self.axis_sizes}

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The global rank at ``coords`` (axes left out: this rank's)."""
        r = 0
        for a, n in self.axis_sizes.items():
            r = r * n + int(coords.get(a, self._coords[a]))
        return r

    def _axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or several) in mesh order, size-1 and absent
        axes dropped."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_sizes
                     if a in axes and self.axis_sizes[a] > 1)

    def _make_groups(self):
        key = (tuple(self.axis_sizes.items()), dist.num_workers())
        if key in _GROUPS:
            return _GROUPS[key]
        import torch.distributed as tdist

        big = self._axes(self.axis_sizes)
        world = self.size()
        mine = {}
        for k in range(1, len(big) + 1):
            for axes in itertools.combinations(big, k):
                if math.prod(self.axis_sizes[a] for a in axes) == world:
                    mine[axes] = None  # every rank: the default group
                    continue
                seen = set()
                for r in range(world):  # one group per other-axes position
                    if r in seen:
                        continue
                    c = self.coords_of(r)
                    ranks = sorted(self.rank_of(dict(c, **dict(zip(axes, p))))
                                   for p in itertools.product(
                                       *(range(self.axis_sizes[a])
                                         for a in axes)))
                    seen.update(ranks)
                    g = tdist.new_group(ranks)
                    if self._rank in ranks:
                        mine[axes] = g
        _GROUPS[key] = mine
        return mine

    def coord(self, axis: str) -> int:
        """This rank's place along ``axis`` (0 on an absent axis)."""
        return self._coords.get(axis, 0)

    def index(self, axes) -> int:
        """This rank's place along ``axes`` together, row-major in the
        order given (the block a spec entry of those axes gives it)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.size(a) + self.coord(a)
        return i

    def group(self, axes):
        """This rank's sub-group over ``axes`` (a name or several); None
        when it spans every rank.  Axes of size 1 are left out; a set of
        total size 1 has no group and raises."""
        key = self._axes(axes)
        if not key:
            raise MXNetError(f"{self!r}: axes {axes} have size 1; there is "
                             "no group to communicate over")
        return self._groups[key]

    def group_ranks(self, axes) -> List[int]:
        """The global ranks of this rank's group over ``axes``, in group
        order."""
        key = self._axes(axes)
        return sorted(self.rank_of(dict(zip(key, p))) for p in
                      itertools.product(*(range(self.axis_sizes[a])
                                          for a in key)))

    def batch_index(self) -> int:
        """This rank's block of the batch (``dp`` x ``fsdp``)."""
        return self.index(BATCH_AXES)

    def batch_group(self):
        """The group over the batch axes (see :meth:`group`)."""
        return self.group(BATCH_AXES)

    def size(self, axis=None) -> int:
        """The mesh's size, an axis's, or the product over several."""
        if axis is None:
            return math.prod(self.axis_sizes.values())
        if not isinstance(axis, str):
            return math.prod(self.axis_sizes.get(a, 1) for a in axis)
        return self.axis_sizes.get(axis, 1)

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    def __contains__(self, axis: str) -> bool:
        return axis in self.axis_sizes

    def __enter__(self):
        _STATE.stack.append(self)
        return self

    def __exit__(self, *exc):
        _STATE.stack.pop()
        return False

    def __repr__(self):
        ax = ", ".join(f"{k}={v}" for k, v in self.axis_sizes.items())
        return f"DeviceMesh({ax})"


class _MeshState(threading.local):
    def __init__(self):
        self.stack: List[DeviceMesh] = []


_STATE = _MeshState()


def make_mesh(axes: Union[Dict[str, int], Sequence[Tuple[str, int]],
                          None] = None,
              devices: Optional[Sequence] = None,
              **axis_kw: int) -> DeviceMesh:
    """make_mesh(dp=1) on cuda:0; make_mesh(dp=N), make_mesh(fsdp=2),
    make_mesh(dp=2, sp=2) over a process group of as many ranks as the
    mesh has positions; with no sizes, dp is the group's size (1 without
    one)."""
    axes = dict(axes or {})
    axes.update(axis_kw)
    if not axes:
        axes = {"dp": dist.num_workers()}
    return DeviceMesh(axes, devices)


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost active ``with mesh:`` scope, or None."""
    return _STATE.stack[-1] if _STATE.stack else None


def get_mesh() -> DeviceMesh:
    m = current_mesh()
    if m is None:
        raise MXNetError("no DeviceMesh active; use `with make_mesh(...):`")
    return m


def mesh_shard_plan() -> Optional[Tuple[DeviceMesh, Tuple[str, ...]]]:
    """(mesh, batch axes) for an active mesh that splits the batch,
    else None (counterpart of ``pallas_convbn._mesh_shard_plan``): under
    it every rank holds its own block of the batch, and sums over the
    batch (BatchNorm statistics) are summed over the ranks."""
    m = current_mesh()
    if m is None or batch_shards(m) == 1:
        return None
    return m, tuple(a for a in BATCH_AXES if m.size(a) > 1)


def batch_shards(mesh: Optional[DeviceMesh] = None) -> int:
    """How many ranks ``mesh`` (default: the active one) splits the batch
    over; 1 without a mesh."""
    mesh = mesh or current_mesh()
    return 1 if mesh is None else math.prod(mesh.size(a) for a in BATCH_AXES)


def batch_group(mesh: Optional[DeviceMesh] = None):
    """The process group that sums over the batch under ``mesh`` (default:
    the active one): its batch axes' group, None when they span every
    rank."""
    mesh = mesh or current_mesh()
    return None if mesh is None or batch_shards(mesh) == 1 \
        else mesh.batch_group()
