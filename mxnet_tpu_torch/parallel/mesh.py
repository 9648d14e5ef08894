"""Named-axis device meshes over torch devices (counterpart of
``mxnet_tpu/parallel/mesh.py``).

A ``DeviceMesh`` arranges devices into a grid with named axes (dp, fsdp,
tp, pp, sp, ep) and is a scope (``with mesh:``) that
:func:`current_mesh` reads.  This slice runs on one device: a mesh of
more than one device raises until the multi-GPU slice ports the
collectives.  Devices default to ``cuda:0``, … and never to the CPU; a
CPU run passes ``devices=[cpu()]``.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..base import MXNetError
from ..context import current_context, resolve

__all__ = ["DeviceMesh", "make_mesh", "current_mesh", "get_mesh",
           "AXIS_NAMES"]

AXIS_NAMES = ("dp", "fsdp", "tp", "pp", "sp", "ep")


def _default_devices() -> List[torch.device]:
    current_context()  # raises without CUDA: no silent CPU mesh
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


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
        devices = [resolve(d) for d in devices] if devices is not None \
            else _default_devices()
        need = math.prod(self.axis_sizes.values())
        if need > len(devices):
            raise MXNetError(f"mesh {axes} needs {need} devices, only "
                             f"{len(devices)} available")
        if need != 1:
            raise MXNetError(
                f"mesh {axes} spans {need} devices: meshes of more than one "
                "device (NCCL collectives, sharded state) come with the "
                "multi-GPU slice of the port")
        self._devices = devices[:need]

    def size(self, axis: Optional[str] = None) -> int:
        if axis is None:
            return math.prod(self.axis_sizes.values())
        return self.axis_sizes.get(axis, 1)

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

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
    """make_mesh(dp=1) on cuda:0; with no sizes, every device goes onto a
    1-D 'dp' axis (which raises above one device in this slice)."""
    axes = dict(axes or {})
    axes.update(axis_kw)
    if not axes:
        n = len(devices) if devices is not None else len(_default_devices())
        axes = {"dp": n}
    return DeviceMesh(axes, devices)


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost active ``with mesh:`` scope, or None."""
    return _STATE.stack[-1] if _STATE.stack else None


def get_mesh() -> DeviceMesh:
    m = current_mesh()
    if m is None:
        raise MXNetError("no DeviceMesh active; use `with make_mesh(...):`")
    return m
