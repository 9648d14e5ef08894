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

Every collective takes ``group=``, a sub-group of the ranks (a mesh
axis's, ``DeviceMesh.group``; None is every rank).  Sequence parallelism
adds :func:`ring_shift` (each rank's tensors to the next rank of a group
and the previous rank's back, ``batch_isend_irecv``) and
:func:`all_to_all_` (``all_to_all_single``); gloo takes neither for a
CUDA tensor, so on gloo both stage through the host and stay direct on
NCCL.  The pipeline (``parallel/pipeline.py``) adds two with autograd:
:func:`ppermute`, one tensor's :func:`ring_shift` whose backward shifts
the cotangent the other way (``lax.ppermute``'s transpose), and
:func:`take_from`, the value of one rank on every rank of a group (the
JAX pipeline's masked psum), whose backward hands this rank's cotangent
to the source rank alone: every rank holds the same replicated
cotangent, so a sum over the ranks would multiply it by their number.

The KVStore's dist stores call three more (``kvstore.py``):
:func:`allreduce_nd` (an NDArray summed over the ranks; a row-sparse one
keeps the union of the ranks' rows), :func:`allgather_np` (a host array
from every rank, stacked) and :func:`abort` (leave at once after a
collective failed on a dead peer).

Every collective is bounded by the group's timeout (``timeout=`` of
:func:`init`, else ``MXNET_KVSTORE_TIMEOUT`` seconds, else the backend's
default), so a dead peer fails the step instead of hanging it.  The
watchdog, the retries, the schedule ledger and the chaos sites wait for
the collectives' resilience (ROADMAP.md queue A item 10), on the retry
policy and chaos harness of ``resilience``.
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
           "reduce_scatter_start", "all_gather_", "all_gather_list",
           "all_gather_list_start", "allreduce_nd", "allgather_np", "abort",
           "group_size", "group_rank", "ring_shift", "all_to_all_",
           "ppermute", "take_from"]

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
    run unchanged.  ``timeout`` (seconds; default
    ``MXNET_KVSTORE_TIMEOUT``, unset or 0 for the backend's own) bounds
    every collective."""
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
    if timeout is None:
        from ..util import env

        t = env.get_float("MXNET_KVSTORE_TIMEOUT")
        timeout = t if t else None
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
    """Leave the process group (a no-op without one); the meshes' cached
    sub-groups go with it."""
    global _INITIALIZED
    from .mesh import _GROUPS

    if _group_active():
        tdist.destroy_process_group()
    _GROUPS.clear()
    _INITIALIZED = False


def _require_group(what):
    if not _group_active():
        raise MXNetError(f"dist.{what}: no process group; call "
                         "parallel.dist.init() in every rank first")


def group_size(group=None) -> int:
    """How many ranks ``group`` holds (None: every rank)."""
    return num_workers() if group is None else tdist.get_world_size(group)


def group_rank(group=None) -> int:
    """This rank's place in ``group`` (None: its global rank).  A group's
    ranks are in the order of their global ranks."""
    return rank() if group is None else tdist.get_rank(group)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place; returns ``t``."""
    _require_group("all_reduce_")
    with torch.profiler.record_function(_SPAN + "all_reduce"):
        tdist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s, in place; returns
    ``t``."""
    _require_group("broadcast_")
    with torch.profiler.record_function(_SPAN + "broadcast"):
        tdist.broadcast(t, src, group=group)
    return t


def reduce_scatter(flat: torch.Tensor, group=None) -> torch.Tensor:
    """Block r (this rank's in ``group``, ``flat.numel() / N`` elements)
    of the sum of the 1-D ``flat`` over the group's ranks.  ``flat`` may
    be overwritten."""
    return reduce_scatter_start(flat, group)()


def reduce_scatter_start(flat: torch.Tensor, group=None):
    """:func:`reduce_scatter` issued without waiting (``async_op``):
    returns the function that waits and gives the block."""
    _require_group("reduce_scatter")
    n = group_size(group)
    if flat.numel() % n:
        raise MXNetError(f"dist.reduce_scatter: {flat.numel()} elements do "
                         f"not divide into {n} blocks")
    k = flat.numel() // n
    r = group_rank(group)
    with torch.profiler.record_function(_SPAN + "reduce_scatter"):
        if backend() == "nccl":
            out = torch.empty(k, dtype=flat.dtype, device=flat.device)
            work = tdist.reduce_scatter_tensor(out, flat, group=group,
                                               async_op=True)
        else:
            out = flat[r * k:(r + 1) * k]
            work = tdist.all_reduce(flat, group=group, async_op=True)

    def wait():
        work.wait()
        return out
    return wait


def all_gather_(out: torch.Tensor, local: torch.Tensor,
                group=None) -> torch.Tensor:
    """Fill the 1-D ``out`` (N times ``local``'s elements) with the 1-D
    ``local`` of every rank of ``group``, in group order; returns
    ``out``."""
    _require_group("all_gather_")
    n = group_size(group)
    if out.numel() != n * local.numel():
        raise MXNetError(f"dist.all_gather_: {out.numel()} elements for "
                         f"{n} blocks of {local.numel()}")
    with torch.profiler.record_function(_SPAN + "all_gather"):
        if backend() == "nccl":
            tdist.all_gather_into_tensor(out, local.contiguous(),
                                         group=group)
        else:
            tdist.all_gather(list(out.chunk(n)), local.contiguous(),
                             group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; the cotangent of x is Σ_ranks of y's: each rank
    holds its own partial of the cotangent of the (replicated) sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(memory_format=torch.
                                            contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (a new
    tensor)."""
    return _AllReduceSum.apply(x, group)


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


def all_gather_list(t: torch.Tensor, group=None):
    """The ``t`` of every rank of ``group`` (same shape and dtype on
    each), in group order, as a list of tensors on ``t``'s device."""
    return all_gather_list_start(t, group)()


def all_gather_list_start(t: torch.Tensor, group=None):
    """:func:`all_gather_list` issued without waiting: returns the
    function that waits and gives the list."""
    _require_group("all_gather_list")
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    with torch.profiler.record_function(_SPAN + "all_gather"):
        work = tdist.all_gather(out, t.contiguous(), group=group,
                                async_op=True)

    def wait():
        work.wait()
        return out
    return wait


def _on_group_device(t: torch.Tensor) -> torch.Tensor:
    """``t`` on a device the group's backend takes (NCCL: this rank's
    card)."""
    if backend() == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where point-to-point and all-to-all take it: the host on
    gloo (which refuses CUDA tensors for both), else ``t``."""
    if backend() != "nccl" and t.is_cuda:
        return t.cpu()
    return t.contiguous()


def ring_shift(tensors: Sequence[torch.Tensor], send_to: int,
               recv_from: int, group=None):
    """Send each of ``tensors`` to global rank ``send_to`` and receive
    the same shapes from global rank ``recv_from`` (one
    ``batch_isend_irecv`` of every rank of ``group``); returns the
    received tensors on the inputs' devices."""
    _require_group("ring_shift")
    ops, outs = [], []
    with torch.profiler.record_function(_SPAN + "ring_shift"):
        for t in tensors:
            src = _staged(t)
            buf = torch.empty_like(src)
            ops.append(tdist.P2POp(tdist.isend, src, send_to, group))
            ops.append(tdist.P2POp(tdist.irecv, buf, recv_from, group))
            outs.append(buf)
        for w in tdist.batch_isend_irecv(ops):
            w.wait()
    return [o.to(t.device) for o, t in zip(outs, tensors)]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_to, recv_from, group):
        ctx.cfg = (send_to, recv_from, group)
        return ring_shift([x.detach()], send_to, recv_from, group)[0]

    @staticmethod
    def backward(ctx, g):
        send_to, recv_from, group = ctx.cfg
        return (ring_shift([g], recv_from, send_to, group)[0], None, None,
                None)


def ppermute(x: torch.Tensor, send_to: int, recv_from: int,
             group=None) -> torch.Tensor:
    """Differentiable :func:`ring_shift` of one tensor: ``x`` to global
    rank ``send_to``, the result from global rank ``recv_from``; the
    backward sends the cotangent back to ``recv_from`` and receives
    ``send_to``'s.  Every rank of ``group`` must call it, forward and
    backward, in the same order."""
    return _PPermute.apply(x, send_to, recv_from, group)


class _TakeFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.mine = rank() == src
        out = _on_group_device(x.detach().clone(
            memory_format=torch.contiguous_format))
        return broadcast_(out, src, group).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def take_from(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group`` (the same
    shape on each), differentiable for a result whose cotangent every
    rank holds alike: the source rank keeps its cotangent and the others
    pass zeros back."""
    return _TakeFrom.apply(x, src, group)


def all_to_all_(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_to_all_single`` over ``group``: block j of dim 0 of ``x`` (N
    equal blocks) goes to the group's rank j, and block j of the result
    comes from it."""
    _require_group("all_to_all_")
    src = _staged(x)
    out = torch.empty_like(src)
    with torch.profiler.record_function(_SPAN + "all_to_all"):
        tdist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def allgather_np(value) -> "np.ndarray":
    """A host array from every rank, stacked on a new first axis in rank
    order (one process: ``value[None]``)."""
    import numpy as np

    v = np.ascontiguousarray(np.asarray(value))
    if num_workers() == 1:
        return v[None]
    t = _on_group_device(torch.from_numpy(v.reshape(-1).copy()))
    parts = all_gather_list(t)
    return np.stack([p.cpu().numpy().reshape(v.shape) for p in parts])


def allreduce_nd(val):
    """An NDArray summed over every rank (a new array; one process: the
    array itself).  A row-sparse array stays row-sparse, its rows the
    union of the ranks' (each rank may hold another number)."""
    from ..ndarray.ndarray import NDArray
    from ..ndarray.sparse import RowSparseNDArray

    if num_workers() == 1:
        return val
    src = val._data
    out = all_reduce_(_on_group_device(src.detach().clone()))
    out = out.to(src.device)
    if isinstance(val, RowSparseNDArray):
        mask = torch.zeros(val.shape[0], dtype=torch.int32,
                           device=src.device)
        mask[val._aux["indices"]] = 1
        union = all_reduce_(_on_group_device(mask)).to(src.device)
        return RowSparseNDArray(out, torch.nonzero(union).reshape(-1))
    return NDArray(out, ctx=val.ctx)


def abort(reason: str = "", code: int = 1) -> None:
    """Leave this rank at once (after a collective failed on a dead
    peer, an orderly exit would wait on that peer)."""
    import sys

    if reason:
        print(f"[mxnet_tpu_torch.dist] rank {rank()} aborting: {reason}",
              file=sys.stderr, flush=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
