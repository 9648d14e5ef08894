"""Runtime feature introspection (counterpart of ``mxnet_tpu/runtime.py``;
ref: python/mxnet/runtime.py over src/libinfo.cc, ``mx.runtime.
feature_list()``, ``Features``).

The key set is the JAX package's; each key is answered for the port:
CUDA, CUDNN and NCCL from PyTorch, JAX, TPU and XLA_COLLECTIVES False,
NATIVE_ENGINE from whether ``lib``'s C++ engine builds and loads (the
first call may run g++), and DIST_KVSTORE True: ``kv.create("dist_*")``
makes a store over the ranks of a ``torch.distributed`` process group.
"""
from __future__ import annotations

import importlib.util
from collections import namedtuple
from typing import Dict, List

import torch

__all__ = ["Feature", "Features", "feature_list"]

Feature = namedtuple("Feature", ["name", "enabled"])


def _probe() -> Dict[str, bool]:
    from . import lib

    return {
        "JAX": False,
        "TPU": False,
        "CPU": True,
        "CUDA": torch.cuda.is_available(),
        "CUDNN": torch.backends.cudnn.is_available(),
        "NCCL": torch.distributed.is_available()
        and torch.distributed.is_nccl_available(),
        "XLA_COLLECTIVES": False,
        "BF16": True,
        "INT8": True,
        "NATIVE_ENGINE": lib.available(),
        "OPENCV": importlib.util.find_spec("cv2") is not None,
        "DIST_KVSTORE": True,
        "F16C": True,
    }


class Features(dict):
    """ref: runtime.Features, a mapping name -> Feature."""

    def __init__(self):
        super().__init__([(k, Feature(k, v)) for k, v in _probe().items()])

    def __repr__(self):
        return f"[{', '.join(sorted(self.keys()))}]"

    def is_enabled(self, name: str) -> bool:
        feat = self.get(name.upper())
        return bool(feat and feat.enabled)


def feature_list() -> List[Feature]:
    """ref: runtime.feature_list."""
    return list(Features().values())
