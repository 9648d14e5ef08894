"""KVStore: the data-parallel gradient sum (counterpart of
``mxnet_tpu/kvstore.py:46-664``; ref: src/kvstore/**).

One API over three kinds of store:

* ``'local'`` and ``'device'``: a sum over the values (replicas) the
  caller hands in, on the first one's device, pairwise in the JAX
  package's order (``_balanced_sum``); a row-sparse sum keeps the merged
  rows (ref: comm.h).
* ``'nccl'`` (``'xla'`` is taken as its alias): the same eager sum — the
  port's collective library is NCCL, as XLA's collectives are the JAX
  package's, and the one program over the replicas is
  ``gluon.Trainer(spmd=True)``'s ``SpmdUpdater``.
* ``'dist_sync'``, ``'dist_device_sync'``, ``'dist'`` and ``'dist_async'``
  over processes: the local sum, then one collective of the process
  group (``parallel.dist``), which ``create`` joins from the ``DMLC_*``
  contract when it has not been joined (NCCL by default; a gloo group,
  for the CPU or ranks sharing a card, is joined by calling
  ``parallel.dist.init(backend='gloo')`` first).  ``dist_async`` warns
  once and runs synchronously: the sum is a collective.

``push`` stores the sum (or, with an optimizer set, runs the update on
the stored value: ``set_optimizer``, MXNet's update on the kvstore);
``pull`` writes the stored value into each output (in place, so a
gradient or weight keeps its buffer); ``pushpull`` does both.
``pushpull_fused`` sums many keys through order-preserving buckets of
``MXNET_FUSED_BUCKET_BYTES``, homogeneous in dtype and replica count: one
sum, and on a dist store one collective, per bucket.  It takes one key at
a time under an updater, compression or sparse values.

2-bit compression (``set_gradient_compression``) works on ``device`` and
dist stores and is refused on ``local`` and on sparse values.  On a
``device`` store it is the quantize/dequantize round trip of the sum, and
is skipped for one replica (nothing crosses a wire); on a dist store each
rank's packed codes are gathered and every rank sums what each decodes
(``_dcn_allreduce``) — not an all-reduce of codes.  The JAX package's
route of one mesh program per bucket (``_bucket_allreduce_spmd``) has no
counterpart here: the port's one program over the replicas is
``SpmdUpdater``.  The chaos sites and retries (on ``resilience.chaos``
and ``resilience.retry``) and the schedule ledger wait for ROADMAP
queue A item 10.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Union

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray
from .util import env

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device", "nccl")
_DIST = ("dist_sync", "dist_device_sync", "dist_async", "dist")
_ALIASES = {"xla": "nccl"}


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _nd(v) -> NDArray:
    return v if isinstance(v, NDArray) else NDArray(v)


def _key_int(k) -> int:
    try:
        return int(k)
    except (TypeError, ValueError):
        return abs(hash(k)) % (2 ** 31)


def _balanced_sum(xs: List[torch.Tensor]) -> torch.Tensor:
    """Pairwise sum of same-shaped tensors (the JAX package's order)."""
    xs = list(xs)
    while len(xs) > 1:
        nxt = [xs[i] + xs[i + 1] for i in range(0, len(xs) - 1, 2)]
        if len(xs) % 2:
            nxt.append(xs[-1])
        xs = nxt
    return xs[0]


class KVStore:
    def __init__(self, kind: str):
        self._kind = kind
        self._store: Dict[Union[int, str], NDArray] = {}
        self._updater: Optional[Callable] = None
        self._compression = None

    # ---- identity --------------------------------------------------------
    @property
    def type(self) -> str:
        return self._kind

    @property
    def _dist(self) -> bool:
        return self._kind.startswith("dist")

    @property
    def rank(self) -> int:
        from .parallel import dist

        return dist.rank() if self._dist else 0

    @property
    def num_workers(self) -> int:
        from .parallel import dist

        return dist.num_workers() if self._dist else 1

    # ---- core API --------------------------------------------------------
    def _normalize(self, key, value):
        keys = _as_list(key)
        if value is None:
            return keys, [None] * len(keys)
        if len(keys) == 1:
            return keys, [value]
        vals = _as_list(value)
        if len(vals) != len(keys):
            raise MXNetError("key/value length mismatch")
        return keys, vals

    def _check(self, k):
        if k not in self._store:
            raise MXNetError(f"kvstore key {k} not initialized")

    def init(self, key, value):
        for k, v in zip(*self._normalize(key, value)):
            self._store[k] = _nd(_as_list(v)[0]).copy()

    def _sum(self, k, vlist) -> NDArray:
        """The sum of one key's values: local, then over the ranks of a
        dist store, or through the compression round trip of a device
        store with several replicas."""
        agg = self._reduce(vlist)
        if self._dist:
            return self._dcn_allreduce(agg, key=k)
        if self._check_compressible(agg) and len(vlist) > 1:
            # the sparse refusal above fires for one replica too; the
            # lossy round trip runs only when something crosses a wire
            return self._compress_roundtrip(k, agg)
        return agg

    def _publish(self, k, agg: NDArray):
        """Run the updater on the stored value, or store ``agg``."""
        if self._updater is not None:
            self._check(k)
            self._updater(_key_int(k), agg, self._store[k])
        else:
            self._store[k] = agg

    def push(self, key, value, priority: int = 0):
        """Store the sum of each key's values (or apply it through the
        updater)."""
        for k, v in zip(*self._normalize(key, value)):
            self._publish(k, self._sum(k, _as_list(v)))

    @staticmethod
    def _write(dst, src: NDArray, what="pull"):
        from .ndarray.sparse import BaseSparseNDArray

        if isinstance(dst, BaseSparseNDArray):
            raise MXNetError(f"{what} with a sparse out is not supported; "
                             "use row_sparse_pull (ref: "
                             "KVStoreLocal::PullImpl)")
        with torch.no_grad():
            (dst._data if isinstance(dst, NDArray) else dst).copy_(
                src._data)

    def pull(self, key, out=None, priority: int = 0, ignore_sparse=True):
        for k, o in zip(*self._normalize(key, out)):
            self._check(k)
            for dst in _as_list(o):
                self._write(dst, self._store[k])

    def pushpull(self, key, value, out=None, priority: int = 0):
        """The sum of each key's values written into every output (into
        the values themselves without ``out``); with an updater, the
        updated stored value."""
        keys, values = self._normalize(key, value)
        _, outs = self._normalize(key, out if out is not None else value)
        for k, v, o in zip(keys, values, outs):
            agg = self._sum(k, _as_list(v))
            if self._updater is not None:
                self._publish(k, agg)
                agg = self._store[k]
            for dst in _as_list(o):
                self._write(dst, agg, "pushpull")

    def pushpull_fused(self, keys, values, out=None, priority: int = 0,
                       bucket_bytes: Optional[int] = None):
        """``pushpull(k, v, out=o)`` for many keys, through buckets: the
        dense values, in order, packed into buckets of one dtype and one
        replica count of at most ``bucket_bytes`` (default
        ``MXNET_FUSED_BUCKET_BYTES``; at least one key each); each bucket
        is one flat sum (and, on a dist store, one collective), split
        back.  Each sum is published to the store, as a push would.
        Under an updater, compression or sparse values, one key at a
        time."""
        from .ndarray.sparse import BaseSparseNDArray

        keys = list(keys)
        vals = [_as_list(v) for v in values]
        outs = vals if out is None else [_as_list(o) for o in out]
        if len(vals) != len(keys) or len(outs) != len(keys):
            raise MXNetError("pushpull_fused: key/value/out length mismatch")
        if (self._updater is not None or self._compression is not None
                or any(isinstance(x, BaseSparseNDArray)
                       for v in vals for x in v)):
            for k, v, o in zip(keys, vals, outs):
                self.pushpull(k, v, out=o, priority=priority)
            return
        if bucket_bytes is None:
            bucket_bytes = (env.get_int("MXNET_SPMD_BUCKET_BYTES")
                            if env.get_bool("MXNET_SPMD") else 0) \
                or env.get_int("MXNET_FUSED_BUCKET_BYTES")
        buckets: List[List[int]] = []
        cur: List[int] = []
        cur_sig, cur_bytes = None, 0
        for pos, v in enumerate(vals):
            d = _nd(v[0])._data
            sig = (d.dtype, len(v))
            nbytes = d.numel() * d.element_size()
            if cur and (sig != cur_sig or cur_bytes + nbytes > bucket_bytes):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(pos)
            cur_sig, cur_bytes = sig, cur_bytes + nbytes
        if cur:
            buckets.append(cur)
        for bucket in buckets:
            self._bucket_allreduce(bucket, keys, vals, outs)

    def _bucket_allreduce(self, poss: List[int], keys, vals, outs):
        """One bucket: each replica's values flattened and concatenated
        on the first replica's device, the replica flats summed pairwise
        (then one collective on a dist store), split back."""
        from .parallel import dist

        first = _nd(vals[poss[0]][0])
        dev = first._data.device
        nrep = len(vals[poss[0]])
        flats = []
        with torch.no_grad():
            for r in range(nrep):
                parts = [_nd(vals[p][r])._data.detach().reshape(-1).to(dev)
                         for p in poss]
                flats.append(parts[0].clone() if len(parts) == 1
                             else torch.cat(parts))
            flat = _balanced_sum(flats)
            if self._dist and dist.num_workers() > 1:
                flat = dist.all_reduce_(dist._on_group_device(flat)).to(dev)
        off = 0
        for p in poss:
            v0 = _nd(vals[p][0])
            n = v0._data.numel()
            agg = NDArray(flat[off:off + n].view(v0._data.shape),
                          ctx=first.ctx)
            off += n
            self._store[keys[p]] = agg
            for dst in _as_list(outs[p]):
                self._write(dst, agg, "pushpull")

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` asks for: a row-sparse ``out``
        gets them as its stored rows (sorted, without repeats) and
        zeros elsewhere; a dense ``out`` gets the same dense values."""
        from .ndarray.sparse import CSRNDArray, RowSparseNDArray

        if row_ids is None:
            return self.pull(key, out, priority)
        keys, outs = self._normalize(key, out)
        _, rid_groups = self._normalize(key, row_ids)
        for k, o, rid_group in zip(keys, outs, rid_groups):
            self._check(k)
            src = self._store[k]._data
            for dst, rid in zip(_as_list(o), _as_list(rid_group)):
                if isinstance(dst, CSRNDArray):
                    raise MXNetError("row_sparse_pull fills a row_sparse "
                                     "or dense out, not a csr one")
                rid = rid._data if isinstance(rid, NDArray) \
                    else torch.as_tensor(rid)
                uniq = torch.unique(rid.to(src.device, torch.int64))
                full = torch.zeros_like(src)
                full.index_copy_(0, uniq, src.index_select(0, uniq))
                dev = dst._data.device
                if isinstance(dst, RowSparseNDArray):
                    dst._data = full.to(dev)
                    dst._aux = {"indices": uniq.to(dev)}
                else:
                    with torch.no_grad():
                        dst._data.copy_(full)

    # ---- the optimizer -----------------------------------------------------
    def set_optimizer(self, optimizer):
        """Apply ``optimizer`` to every push (the store keeps its
        states)."""
        from . import optimizer as opt_mod

        self._updater = opt_mod.get_updater(optimizer)

    def set_updater(self, updater: Callable):
        self._updater = updater

    def save_optimizer_states(self, fname: str, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname: str):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        # the states go where the stored weights are
        ctx = next(iter(self._store.values())).ctx if self._store else None
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), ctx=ctx)

    def set_gradient_compression(self, compression_params: dict):
        """2-bit compression of what the store sums (see the module
        docstring); refused on 'local' (ref:
        KVStoreLocal::SetGradientCompression) and for unknown types."""
        from . import kvstore_compression

        if self._kind == "local":
            raise MXNetError(
                "gradient compression is not supported on 'local' "
                "kvstore (ref: KVStoreLocal::SetGradientCompression)")
        self._compression = kvstore_compression.create(compression_params)

    def barrier(self):
        if self._dist:
            from .parallel import dist

            dist.barrier()

    # ---- internals -------------------------------------------------------
    def _reduce(self, vals) -> NDArray:
        """The sum of one key's values on the first one's device: a
        row-sparse sum with the merged indices when every value is
        row-sparse."""
        from .ndarray.sparse import RowSparseNDArray

        vals = [_nd(v) for v in vals]
        if len(vals) == 1:
            return vals[0].copy()
        dev = vals[0]._data.device
        with torch.no_grad():
            acc = _balanced_sum([v._data.detach().to(dev) for v in vals])
        if all(isinstance(v, RowSparseNDArray) for v in vals):
            merged = torch.unique(torch.cat(
                [v._aux["indices"].to(dev) for v in vals]))
            return RowSparseNDArray(acc, merged)
        if acc is vals[0]._data:
            acc = acc.clone()
        return NDArray(acc, ctx=vals[0].ctx)

    def _check_compressible(self, val) -> bool:
        from .ndarray.sparse import BaseSparseNDArray

        if self._compression is None:
            return False
        if isinstance(val, BaseSparseNDArray):
            raise MXNetError(
                "gradient compression does not support sparse gradients "
                "(ref: GradientCompression row_sparse check)")
        return True

    def _compress_roundtrip(self, key, val: NDArray) -> NDArray:
        """Quantize and dequantize the sum: what 2-bit compression does
        to a value that crosses a wire between the replicas."""
        packed, shape = self._compression.compress(key, val._data)
        out = self._compression.decompress(packed, shape)
        return NDArray(out.to(val._data.dtype), ctx=val.ctx)

    def _dcn_allreduce(self, val: NDArray, key=None) -> NDArray:
        """The sum over the ranks: with compression, every rank's packed
        codes gathered and what each decodes summed in rank order."""
        from .parallel import dist

        if key is not None and self._check_compressible(val):
            packed, shape = self._compression.compress(key, val._data)
            if dist.num_workers() == 1:
                gathered = [packed]
            else:
                gathered = dist.all_gather_list(
                    dist._on_group_device(packed))
            total = 0
            for g in gathered:
                total = total + self._compression.decompress(
                    g.to(val._data.device), shape)
            return NDArray(total.to(val._data.dtype), ctx=val.ctx)
        return dist.allreduce_nd(val)

    def __repr__(self):
        return f"KVStore(type={self._kind}, keys={len(self._store)})"


_ASYNC_WARNED = [False]


def create(name: str = "local") -> KVStore:
    """A store of kind ``name`` (ref: kvstore.create); a dist kind joins
    the process group of the ``DMLC_*`` environment when this process
    has not joined one."""
    name = _ALIASES.get(name, name)
    if name not in _LOCAL + _DIST:
        raise MXNetError(f"unknown kvstore type {name!r}; valid: "
                         f"{sorted(_LOCAL + _DIST + tuple(_ALIASES))}")
    if name.startswith("dist"):
        from .parallel import dist

        if not dist.initialized() and dist.resolve()[0] is not None:
            dist.init()
    if name == "dist_async" and not _ASYNC_WARNED[0]:
        warnings.warn(
            "kvstore 'dist_async' runs as 'dist_sync' in mxnet_tpu_torch: "
            "each push is a synchronous collective of the process group "
            "(NCCL or gloo), so there is no gradient staleness. "
            "Convergence tuned for asynchronous parameter-server training "
            "may differ.", UserWarning, stacklevel=2)
        _ASYNC_WARNED[0] = True
    return KVStore(name)
