"""Named-axis device meshes over torch devices (counterpart of
``mxnet_tpu/parallel/mesh.py``).

A ``DeviceMesh`` arranges devices into a grid with named axes (dp, fsdp,
tp, pp, sp, ep) and is a scope (``with mesh:``) that
:func:`current_mesh` reads.  A mesh of one device runs in this process.
A mesh of more than one device is data parallel over a process group
(``parallel.dist.init``), one rank per device: ``dp`` must equal the
group's size, and the other axes stay 1 until a later slice of the port.
``devices`` lists every rank's device and ``local_device`` is this
rank's.  Devices default to CUDA and never to the CPU; a CPU run passes
``devices=[cpu()]`` (one entry per rank).
"""
from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..base import MXNetError
from ..context import current_context, resolve
from . import dist

__all__ = ["DeviceMesh", "make_mesh", "current_mesh", "get_mesh",
           "mesh_shard_plan", "batch_shards", "AXIS_NAMES", "BATCH_AXES"]

AXIS_NAMES = ("dp", "fsdp", "tp", "pp", "sp", "ep")
BATCH_AXES = ("dp", "fsdp")  # the axes that split the batch


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
        # this rank's device: cuda:LOCAL_RANK when a launcher sets it and
        # the caller lists no devices, else this rank's entry
        if need > 1 and not listed and "LOCAL_RANK" in os.environ:
            self.local_device = torch.device(
                "cuda", int(os.environ["LOCAL_RANK"]))
        else:
            self.local_device = self._devices[dist.rank() if need > 1
                                              else 0]

    @staticmethod
    def _check_process_group(axes, need):
        other = {a: s for a, s in axes.items() if a != "dp" and s != 1}
        if other:
            raise MXNetError(
                f"mesh {axes}: only the 'dp' axis may exceed 1 in this "
                f"slice of the port; {sorted(other)} (sharded parameters, "
                "tensor, pipeline, sequence and expert parallelism) come "
                "with a later slice")
        world = dist.num_workers()
        if world != need:
            raise MXNetError(
                f"mesh {axes} spans {need} devices, one rank each, but the "
                f"process group has {world} rank(s): call "
                f"parallel.dist.init() in each of {need} processes first")

    def size(self, axis: Optional[str] = None) -> int:
        if axis is None:
            return math.prod(self.axis_sizes.values())
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
    """make_mesh(dp=1) on cuda:0; make_mesh(dp=N) over a process group of
    N ranks; with no sizes, dp is the group's size (1 without one)."""
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
    """(mesh, batch axes) for the active mesh of more than one device,
    else None (counterpart of ``pallas_convbn._mesh_shard_plan``): under
    it every rank holds its own block of the batch, and sums over the
    batch (BatchNorm statistics) are summed over the ranks."""
    m = current_mesh()
    if m is None or m.size() == 1:
        return None
    return m, tuple(a for a in BATCH_AXES if m.size(a) > 1)


def batch_shards(mesh: Optional[DeviceMesh] = None) -> int:
    """How many ranks ``mesh`` (default: the active one) splits the batch
    over; 1 without a mesh."""
    mesh = mesh or current_mesh()
    return 1 if mesh is None else math.prod(mesh.size(a) for a in BATCH_AXES)
