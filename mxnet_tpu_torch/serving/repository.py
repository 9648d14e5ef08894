"""ModelRepository: versioned deploy artifacts + per-bucket executor cache.

Counterpart of ``mxnet_tpu/serving/repository.py``.  Artifacts are
imported lazily (``contrib.deploy.import_model`` on first use, once, on
the entry's own import lock), and several versions of one model may be
loaded.  PyTorch runs eagerly, so a bucket's executor is the served
model's forward (on the card, the hybridized forward's CUDA graph of
that bucket, captured by its first batch); the per-bucket cache and its
hit/miss counters stay, so the serving layer keeps its shape.

Each entry carries its circuit breaker, the use-count and retire
protocol of zero-downtime rollover (a retired entry drops its graphs
and weights when its last in-flight request ends), and the chaos sites
``serving.artifact`` and ``serving.execute``.

Directory conventions:
    repo.add("resnet", "/path/to/artifact")          # version 1
    repo.add("resnet", "/path/to/v2", version=2)
    repo.scan("/models")   # /models/<name>/<int-version>/meta.json
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import torch

from .. import context as _context
from ..resilience import chaos as _chaos
from ..resilience.breaker import CircuitBreaker
from . import ModelNotFound, ServingError
from .metrics import ModelMetrics

__all__ = ["ModelRepository", "_ModelEntry"]


class _ModelEntry:
    """One (model, version): lazily imported artifact + bucket cache."""

    def __init__(self, name: str, version: int, path: str, device):
        self.name, self.version, self.path = name, version, path
        self.device = device
        self.metrics = ModelMetrics(name, version)
        self._lock = threading.Lock()
        # a slow import must not block begin_use/end_use or cache
        # lookups, which share the hot entry lock
        self._import_lock = threading.Lock()
        # seeding the generator and running the batch are one step
        self._run_lock = threading.Lock()
        self._served = None
        self._generator = None
        self._executables: Dict[int, object] = {}
        # degrade-don't-die: consecutive executor failures open this
        # and the server 503s THIS model while the process serves on
        self.breaker = CircuitBreaker(name, version)
        # rollover bookkeeping: requests hold a use-count from admission
        # to completion; a retired entry releases its artifact when the
        # LAST in-flight request finishes — never under one
        self._inflight = 0
        self._retired = False

    # ---- rollover lifecycle -------------------------------------------

    def begin_use(self) -> "_ModelEntry":
        """One in-flight request starts on this entry (the server holds
        a use across the request; execute() holds one per launch)."""
        with self._lock:
            self._inflight += 1
        return self

    def end_use(self) -> None:
        with self._lock:
            self._inflight -= 1
            if self._retired and self._inflight == 0:
                self._release_locked()

    def retire(self) -> None:
        """This entry lost the default slot: release its executors as
        soon as the in-flight requests drain (now, if none).  The entry
        stays in the repository — an explicit-version request later
        simply re-imports lazily."""
        with self._lock:
            self._retired = True
            if self._inflight == 0:
                self._release_locked()

    def unretire(self) -> None:
        with self._lock:
            self._retired = False

    @property
    def retired(self) -> bool:
        with self._lock:
            return self._retired

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def _release_locked(self) -> None:
        """Drop the imported artifact, its captured graphs and its
        weights (caller holds self._lock)."""
        served, self._served = self._served, None
        self._executables.clear()
        self._generator = None
        if served is not None:
            served.release()

    # ---- lazy artifact ------------------------------------------------

    @property
    def served(self):
        """The imported artifact (contrib.deploy.ServedModel), on first
        touch; racing requests pay one import."""
        served = self._served
        if served is None:
            if _chaos._ACTIVE:
                # artifact storage flaking: the error must surface to
                # THIS request and leave the entry importable for the
                # next one
                _chaos.check("serving.artifact")
            with self._import_lock:
                served = self._served
                if served is None:
                    from ..contrib import deploy

                    served = deploy.import_model(self.path, ctx=self.device)
                    self._served = served
        return served

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

    # ---- executor cache ----------------------------------------------

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

    def execute(self, bucket: int, xs, seed: int = 0) -> list:
        """Run one padded batch; returns the flat output leaves.  The
        forward draws from the entry's generator, seeded with ``seed``
        for the batch.  Holds a use-count for the launch so a concurrent
        rollover never releases this entry mid-flight."""
        self.begin_use()
        try:
            if _chaos._ACTIVE:
                _chaos.check("serving.execute")
            fn = self.executable(bucket)
            with self._run_lock:
                gen = self._generator
                if gen is None:
                    gen = self._generator = torch.Generator(
                        device=self.device)
                gen.manual_seed(int(seed))
                return list(fn(xs, gen))
        finally:
            self.end_use()

    def warmup(self, ladder: Optional[List[int]] = None) -> None:
        """Build the smallest allowed bucket's executor ahead of traffic
        (on the card, its graph is captured by this zero batch).  Holds a
        use-count like a request, so a warmup racing a rollover that
        retires this entry still ends with the entry released."""
        self.begin_use()
        try:
            bucket = self.allowed_buckets(ladder or [1])[0]
            xs = [torch.zeros([bucket] + list(w["shape"][1:]),
                              dtype=getattr(torch, w["dtype"]))
                  for w in self.input_specs()]
            self.execute(bucket, xs)
        finally:
            self.end_use()


class ModelRepository:
    """Name -> version -> entry.  Lookups default to the latest version
    unless :meth:`rollover` pinned one.

    ``ctx`` is the device every model is served on (default gpu(0);
    raises without CUDA unless cpu() is passed)."""

    def __init__(self, ctx=None):
        self.device = _context.resolve(ctx)
        self._lock = threading.Lock()
        self._models: Dict[str, Dict[int, _ModelEntry]] = {}
        # name -> pinned default version (rollover); absent = latest
        self._default: Dict[str, int] = {}
        # serializes whole rollovers (pin + entry transitions): two
        # racing rollovers must not interleave their retire/unretire
        # calls, which would leave the winning default retired
        self._rollover_lock = threading.Lock()

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

    def scan(self, root: str) -> List[str]:
        """Load `root/<name>/<int-version>/` artifact dirs; returns the
        names added.  Non-integer or artifact-less subdirs are skipped
        (a models dir often holds stray files)."""
        added = []
        for name in sorted(os.listdir(root)):
            mdir = os.path.join(root, name)
            if not os.path.isdir(mdir):
                continue
            for v in sorted(os.listdir(mdir)):
                vdir = os.path.join(mdir, v)
                if not v.isdigit() or \
                        not os.path.exists(os.path.join(vdir, "meta.json")):
                    continue
                self.add(name, vdir, version=int(v))
                added.append(f"{name}/{v}")
        return added

    def get(self, name: str, version: Optional[int] = None) -> _ModelEntry:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound(f"unknown model {name!r}; loaded: "
                                    f"{sorted(self._models)}")
            if version is None:
                version = self._default_version_locked(name, versions)
            entry = versions.get(version)
            if entry is None:
                raise ModelNotFound(
                    f"model {name!r} has versions {sorted(versions)}, "
                    f"not {version}")
        return entry

    def _default_version_locked(self, name: str, versions) -> int:
        v = self._default.get(name)
        # a pinned default that was since removed falls back to latest
        return v if v is not None and v in versions else max(versions)

    def default_version(self, name: str) -> int:
        """The version a version-less request serves right now."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound(f"unknown model {name!r}")
            return self._default_version_locked(name, versions)

    def rollover(self, name: str, version: Optional[int] = None) -> int:
        """Zero-downtime version swap.  Atomically pins ``version``
        (latest when None) as the default, so every new version-less
        request lands on it — and because it is PINNED, a later
        :meth:`add` of a newer version no longer shifts traffic until
        the next rollover.  Every OTHER version keeps serving its
        in-flight requests and releases its artifact, graphs and weights
        once the last one finishes; explicit-version requests for a
        retired version still work, re-importing lazily.  Rolling back
        is the same call with the old version number.  Returns the new
        default version."""
        with self._rollover_lock:
            with self._lock:
                versions = self._models.get(name)
                if not versions:
                    raise ModelNotFound(f"unknown model {name!r}; loaded: "
                                        f"{sorted(self._models)}")
                if version is None:
                    version = max(versions)
                new = versions.get(version)
                if new is None:
                    raise ModelNotFound(
                        f"model {name!r} has versions {sorted(versions)}, "
                        f"not {version}")
                others = [e for v, e in versions.items() if v != version]
                self._default[name] = version
            # entry transitions OUTSIDE the repository lock (each entry
            # has its own lock; retire may release executors)
            new.unretire()
            for e in others:
                e.retire()
            return version

    def entries(self) -> List[_ModelEntry]:
        with self._lock:
            return [e for vs in self._models.values()
                    for _, e in sorted(vs.items())]

    def models(self) -> Dict[str, List[int]]:
        with self._lock:
            return {n: sorted(vs) for n, vs in self._models.items()}
