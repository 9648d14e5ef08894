"""ModelRepository: versioned deploy artifacts + per-bucket executor cache.

Counterpart of ``mxnet_tpu/serving/repository.py``.  Artifacts are
imported lazily (``contrib.deploy.import_model`` on first use, once, on
the entry's own import lock), and several versions of one model may be
loaded.  PyTorch runs eagerly, so a bucket's executor is the served
model's forward and there is nothing to compile; the per-bucket cache
and its hit/miss counters stay, so the serving layer keeps its shape.

Directory conventions:
    repo.add("resnet", "/path/to/artifact")          # version 1
    repo.add("resnet", "/path/to/v2", version=2)
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from .. import context as _context
from . import ModelNotFound, ServingError
from .metrics import ModelMetrics

__all__ = ["ModelRepository"]


class _ModelEntry:
    """One (model, version): lazily imported artifact + bucket cache."""

    def __init__(self, name: str, version: int, path: str, device):
        self.name, self.version, self.path = name, version, path
        self.device = device
        self.metrics = ModelMetrics(name, version)
        self._lock = threading.Lock()
        # a slow import must not block cache lookups on the entry lock
        self._import_lock = threading.Lock()
        self._served = None
        self._executables: Dict[int, object] = {}

    @property
    def served(self):
        """The imported artifact (contrib.deploy.ServedModel), on first
        touch; racing requests pay one import."""
        if self._served is None:
            with self._import_lock:
                if self._served is None:
                    from ..contrib import deploy

                    self._served = deploy.import_model(self.path,
                                                       ctx=self.device)
        return self._served

    @property
    def meta(self) -> dict:
        return self.served.meta

    @property
    def dynamic_batch(self) -> bool:
        return bool(self.meta.get("dynamic_batch"))

    def input_specs(self) -> List[dict]:
        return self.meta["inputs"]

    def fixed_batch(self) -> Optional[int]:
        """The exported batch of a fixed-shape artifact (None if dynamic)."""
        if self.dynamic_batch:
            return None
        sizes = {w["shape"][0] for w in self.input_specs()}
        if len(sizes) != 1:
            raise ServingError(f"model {self.name!r}: inputs disagree on "
                               f"the batch dim {sorted(sizes)}")
        return sizes.pop()

    def allowed_buckets(self, ladder: List[int]) -> List[int]:
        """The configured ladder, or the one exported batch."""
        fixed = self.fixed_batch()
        return list(ladder) if fixed is None else [fixed]

    def executable(self, bucket: int):
        """The executor for `bucket` padded rows (cached per bucket)."""
        with self._lock:
            fn = self._executables.get(bucket)
            if fn is not None:
                self.metrics.bump("cache_hits")
                return fn
        served = self.served
        fixed = self.fixed_batch()
        if fixed is not None and bucket != fixed:
            raise ServingError(f"model {self.name!r} v{self.version}: "
                               f"fixed-shape artifact serves batch {fixed}, "
                               f"not {bucket}")
        with self._lock:
            fn = self._executables.setdefault(bucket, served.run)
            self.metrics.bump("cache_misses")
        return fn

    def execute(self, bucket: int, xs) -> list:
        """Run one padded batch; returns the flat output leaves."""
        return list(self.executable(bucket)(xs))


class ModelRepository:
    """Name -> version -> entry; lookups default to the latest version.

    ``ctx`` is the device every model is served on (default gpu(0);
    raises without CUDA unless cpu() is passed)."""

    def __init__(self, ctx=None):
        self.device = _context.resolve(ctx)
        self._lock = threading.Lock()
        self._models: Dict[str, Dict[int, _ModelEntry]] = {}

    def add(self, name: str, path: str,
            version: Optional[int] = None) -> int:
        if not os.path.exists(os.path.join(path, "meta.json")):
            raise ServingError(f"{path!r} is not a deploy artifact "
                               f"directory (no meta.json)")
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version is None:
                version = max(versions, default=0) + 1
            if version in versions:
                raise ServingError(
                    f"model {name!r} version {version} already loaded")
            versions[version] = _ModelEntry(name, version, path,
                                            self.device)
        return version

    def get(self, name: str, version: Optional[int] = None) -> _ModelEntry:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound(f"unknown model {name!r}; loaded: "
                                    f"{sorted(self._models)}")
            if version is None:
                version = max(versions)
            entry = versions.get(version)
            if entry is None:
                raise ModelNotFound(
                    f"model {name!r} has versions {sorted(versions)}, "
                    f"not {version}")
        return entry

    def entries(self) -> List[_ModelEntry]:
        with self._lock:
            return [e for vs in self._models.values()
                    for _, e in sorted(vs.items())]
