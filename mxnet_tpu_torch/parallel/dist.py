"""The process group of the port (counterpart of
``mxnet_tpu/parallel/dist.py``).

One process per rank, joined by a ``torch.distributed`` process group.
:func:`init` reads the reference launcher's ``DMLC_*`` contract, as the
JAX package does, and maps it onto ``init_process_group`` with an
explicit backend: ``"nccl"`` by default, ``"gloo"`` when the caller asks
(CPU tensors, or several ranks sharing one card).  The library never
picks a backend on its own.

Two collectives serve data-parallel training, both sums over every rank:

- :func:`all_reduce_sum`, differentiable: its backward sums the
  cotangent over the ranks too (BatchNorm statistics);
- :func:`all_reduce_`, in place and outside autograd (gradient buckets,
  the reported loss).

Two more serve ZeRO-1 state sharding, outside autograd:
:func:`reduce_scatter` (rank r's block of the sum over the ranks of a
flat buffer) and :func:`all_gather_` (every rank's block, in rank
order).  On NCCL they are ``reduce_scatter_tensor`` and
``all_gather_into_tensor``.  On gloo, which has no reduce-scatter for
CUDA tensors, :func:`reduce_scatter` all-reduces the whole buffer and
keeps block r, and :func:`all_gather_` gathers into a list; each sum is
then the very one :func:`all_reduce_` gives.

Every collective is bounded by the group's timeout (``timeout=`` of
:func:`init`, else the backend's default), so a dead peer fails the step
instead of hanging it.  Not
ported here: the watchdog, the retry policy, the schedule ledger and the
chaos sites (ROADMAP.md queue A item 7).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from ..base import MXNetError

__all__ = ["BACKENDS", "init", "resolve", "initialized", "rank",
           "num_workers", "backend", "barrier", "shutdown", "all_reduce_sum",
           "all_reduce_", "broadcast_", "flat_buckets", "reduce_scatter",
           "all_gather_"]

BACKENDS = ("nccl", "gloo")
# a name each collective shows under in torch.profiler traces
_SPAN = "mxnet_tpu_torch.dist."

_INITIALIZED = False


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def resolve(coordinator_address: Optional[str] = None,
            num_processes: Optional[int] = None,
            process_id: Optional[int] = None
            ) -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(init_method URL or None, world size, rank) from the arguments,
    falling back to the DMLC_* contract (ref: tools/launch.py) and the
    scheduler's rank variables.  An address without a scheme is a
    ``host:port`` and becomes ``tcp://host:port``; one with a scheme
    (``file://...``) is taken as it is."""
    if coordinator_address is None:
        uri = _env("DMLC_PS_ROOT_URI")
        port = _env("DMLC_PS_ROOT_PORT", default="9091")
        coordinator_address = f"{uri}:{port}" if uri is not None \
            else _env("COORDINATOR_ADDRESS")
    if num_processes is None:
        v = _env("DMLC_NUM_WORKER", "NUM_PROCESSES")
        num_processes = int(v) if v is not None else None
    if process_id is None:
        v = _env("DMLC_WORKER_ID", "PROCESS_ID", "OMPI_COMM_WORLD_RANK",
                 "PMI_RANK", "SLURM_PROCID")
        process_id = int(v) if v is not None else None
    url = None
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
    return url, num_processes, process_id


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: str = "nccl",
         timeout: Optional[float] = None) -> None:
    """Join the process group (idempotent).

    Explicit arguments win over the DMLC_* environment (see
    :func:`resolve`).  With no coordinator anywhere this is a no-op, so
    the same script runs unchanged as one process.  ``DMLC_ROLE`` of
    ``scheduler`` or ``server`` joins nothing: collectives subsume the
    parameter server, and reference launchers that start those roles
    run unchanged.  ``timeout`` (seconds) bounds every collective."""
    global _INITIALIZED
    if backend not in BACKENDS:
        raise MXNetError(f"dist.init: backend {backend!r} is not one of "
                         f"{BACKENDS}")
    if _INITIALIZED:
        return
    url, world, rank_ = resolve(coordinator_address, num_processes,
                                process_id)
    if url is None:
        if _env("SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE",
                "PMI_SIZE") is not None:
            raise MXNetError(
                "dist.init: an MPI/Slurm launch without a coordinator "
                "address; set DMLC_PS_ROOT_URI/DMLC_PS_ROOT_PORT or pass "
                "coordinator_address")
        _INITIALIZED = True  # single process
        return
    if _env("DMLC_ROLE", default="worker") in ("scheduler", "server"):
        _INITIALIZED = True
        return
    if world is None or rank_ is None:
        raise MXNetError(f"dist.init: coordinator {url} given but the world "
                         f"size ({world}) or this rank ({rank_}) is not; set "
                         "DMLC_NUM_WORKER and DMLC_WORKER_ID")
    if not 0 <= rank_ < world:
        raise MXNetError(f"dist.init: rank {rank_} outside a world of "
                         f"{world}")
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    tdist.init_process_group(backend, init_method=url, world_size=world,
                             rank=rank_, **kw)
    _INITIALIZED = True


def initialized() -> bool:
    return _INITIALIZED


def _group_active() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if _group_active() else 0


def num_workers() -> int:
    return tdist.get_world_size() if _group_active() else 1


def backend() -> Optional[str]:
    """The process group's backend, None without one."""
    return tdist.get_backend() if _group_active() else None


def barrier() -> None:
    """Block until every rank arrives (ref: Postoffice::Barrier); a no-op
    for one process."""
    if num_workers() == 1:
        return
    if backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _INITIALIZED
    if _group_active():
        tdist.destroy_process_group()
    _INITIALIZED = False


def _require_group(what):
    if not _group_active():
        raise MXNetError(f"dist.{what}: no process group; call "
                         "parallel.dist.init() in every rank first")


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank, in place; returns ``t``."""
    _require_group("all_reduce_")
    with torch.profiler.record_function(_SPAN + "all_reduce"):
        tdist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s, in place; returns ``t``."""
    _require_group("broadcast_")
    with torch.profiler.record_function(_SPAN + "broadcast"):
        tdist.broadcast(t, src)
    return t


def reduce_scatter(flat: torch.Tensor) -> torch.Tensor:
    """Block r (this rank's, ``flat.numel() / N`` elements) of the sum of
    the 1-D ``flat`` over every rank.  ``flat`` may be overwritten."""
    _require_group("reduce_scatter")
    n = num_workers()
    if flat.numel() % n:
        raise MXNetError(f"dist.reduce_scatter: {flat.numel()} elements do "
                         f"not divide into {n} blocks")
    k = flat.numel() // n
    r = rank()
    with torch.profiler.record_function(_SPAN + "reduce_scatter"):
        if backend() == "nccl":
            out = torch.empty(k, dtype=flat.dtype, device=flat.device)
            tdist.reduce_scatter_tensor(out, flat)
            return out
        tdist.all_reduce(flat)
    return flat[r * k:(r + 1) * k]


def all_gather_(out: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Fill the 1-D ``out`` (N times ``local``'s elements) with every
    rank's 1-D ``local``, rank 0's first; returns ``out``."""
    _require_group("all_gather_")
    n = num_workers()
    if out.numel() != n * local.numel():
        raise MXNetError(f"dist.all_gather_: {out.numel()} elements for "
                         f"{n} blocks of {local.numel()}")
    with torch.profiler.record_function(_SPAN + "all_gather"):
        if backend() == "nccl":
            tdist.all_gather_into_tensor(out, local.contiguous())
        else:
            tdist.all_gather(list(out.chunk(n)), local.contiguous())
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; the cotangent of x is Σ_ranks of y's: each rank
    holds its own partial of the cotangent of the (replicated) sum."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.detach().clone(memory_format=torch.
                                            contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over every rank (a new tensor)."""
    return _AllReduceSum.apply(x)


def flat_buckets(tensors: Sequence[torch.Tensor], fn) -> None:
    """Apply the in-place collective ``fn`` to ``tensors`` through one
    flat buffer per dtype, and copy the result back into each tensor."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        fn(flat)
        off = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(flat[off:off + n].view(t.shape))
                off += n
