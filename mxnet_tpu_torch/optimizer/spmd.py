"""``SpmdUpdater``: one update over every replica or rank, with the
optimizer states split between them (counterpart of
``mxnet_tpu/optimizer/spmd.py:189-1194``; ``gluon.Trainer(spmd=True)`` or
``MXNET_SPMD=1``).

The JAX package compiles the gradient reduce and the update into one
program over a ``dp`` mesh.  The port runs the same plan eagerly over
the *shards*: the local replicas of one process (one shard each, on its
device), or the ranks of a dist job (one shard each, on the rank's first
replica's device, after the sum over its local replicas).  The plan
(``_build_plan``):

* **ZeRO buckets**: tensors of at least ``MXNET_ZERO_MIN_SIZE`` elements
  of an elementwise optimizer, each flattened and padded to a multiple
  of the shard count, concatenated into buckets of one dtype and one
  multi-precision flag of at most ``MXNET_SPMD_BUCKET_BYTES`` (else
  ``MXNET_FUSED_BUCKET_BYTES``).  A bucket takes a reduce-scatter (the
  replica sum pairwise in the JAX package's order; over ranks,
  ``parallel.dist.reduce_scatter``), the update of its block on the
  shard that holds it, and an all-gather of the new weights into every
  replica.  The states of a bucket live as flat blocks, one per shard
  (ZeRO-1, arXiv:2004.13336).  The update of a block runs each
  parameter's own update on its slice of the block with its own 0-d
  scalars, so an elementwise optimizer gives the bits of the
  per-parameter update.
* **small groups**: the rest, one concatenated all-reduce per dtype and
  flag, updated per parameter on full-shape states (one copy a process).
* **singles**: a tensor of a norm-based optimizer (LAMB) is split
  alone: phase 1 on each shard, its two norms from the shards' sums of
  squares, then phase 2 (``fused_phase1``/``fused_phase2``).

``MXNET_ZERO_STATES=0``, or one shard, keeps every state whole (every
tensor in a small group).  ``MXNET_COMM_QUANT`` (``optimizer/comm.py``)
quantizes a bucket's two legs: each shard's row of the gradient (plus
its error-feedback residual) is encoded, the codes and scales gathered,
and each shard sums the decoded rows of its block; the weight leg
gathers the encoded *delta* of each block (plus its residual) and every
replica adds the decoded delta to the old weights, so replicas stay
identical.  The residuals are optimizer state (``comm.RESIDUAL_KEY``).
``MXNET_COMM_OVERLAP`` issues each bucket's collective on its own
(``async_op``), in reverse bucket order, then waits for all before the
updates: the same bits as the one-pass step.

The update count: the per-replica paths bump it once a replica, so
replica r runs at ``t = step*N - N + r + 1``; one update has one result,
so this one runs replica 0's t and still bumps N times (the JAX
package's rule).  ``get_states`` gives the canonical per-parameter,
full-shape payload of ``Updater.get_states`` (on a dist job, every rank
must call it: it gathers the blocks), so a file saved on 2 replicas
loads on 1 or 4, into this updater or the per-replica ones.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kvstore import _balanced_sum
from ..ndarray.ndarray import to_numpy
from ..util import env as _env
from . import comm as _comm
from .fused import FusedUnsupported, apply_param
from .optimizer import Optimizer, Updater

__all__ = ["SpmdUpdater"]


class _Meta(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    size: int     # elements
    padded: int   # size rounded up to a multiple of the shard count


class _Bucket(NamedTuple):
    pos: Tuple[int, ...]       # positions in the step's parameter list
    offsets: Tuple[int, ...]   # each one's start in the bucket
    sizes: Tuple[int, ...]     # each one's padded length
    total: int
    mp: bool


class _Small(NamedTuple):
    pos: Tuple[int, ...]
    sizes: Tuple[int, ...]     # unpadded lengths


class _Plan(NamedTuple):
    buckets: Tuple[_Bucket, ...]
    smalls: Tuple[_Small, ...]
    singles: Tuple[int, ...]


def _padded(n: int, k: int) -> int:
    return ((max(n, 1) + k - 1) // k) * k


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _tree_multi(fn, trees):
    if trees[0] is None:
        return None
    if isinstance(trees[0], (tuple, list)):
        return tuple(_tree_multi(fn, [t[i] for t in trees])
                     for i in range(len(trees[0])))
    return fn(trees)


def _tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _write_tree(dst, src):
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, s in zip(dst, src):
        _write_tree(d, s)


def _host_tensor(a) -> torch.Tensor:
    """A saved state array (bf16 as ml_dtypes' bfloat16 included) as a
    host tensor of its dtype."""
    from ..context import cpu
    from ..ndarray.ndarray import array

    a = np.asarray(a)
    return array(a, ctx=cpu(), dtype=a.dtype)._data


def _pad_flat(t: torch.Tensor, padded: int) -> torch.Tensor:
    f = t.reshape(-1)
    if f.numel() == padded:
        return f
    return torch.nn.functional.pad(f, (0, padded - f.numel()))


class SpmdUpdater(Updater):
    """Updater whose step (:meth:`update_all_mesh`) sums the gradients and
    updates every parameter over the shards, states split between them
    (see the module docstring)."""

    def __init__(self, optimizer: Optimizer,
                 zero_states: Optional[bool] = None):
        super().__init__(optimizer)
        self._zero = _env.get_bool("MXNET_ZERO_STATES") \
            if zero_states is None else bool(zero_states)
        self._layout = None          # (local devices, dist)
        self._dist = False
        self._nshard = 1
        self._shards: List[Tuple[int, torch.device]] = []
        self._flat = False
        self._plan: Optional[_Plan] = None
        self._plan_indices: Optional[Tuple[int, ...]] = None
        # the states: a bucket's blocks, {bucket ordinal: [tree per local
        # shard]}; a single's blocks, {index: [tree per local shard]}; a
        # small one's, {index: tree}
        self._bstate: Dict[int, List[Any]] = {}
        self._sstate: Dict[int, List[Any]] = {}
        self._pstate: Dict[int, Any] = {}
        self._mp: Dict[int, bool] = {}
        self._meta: Dict[int, _Meta] = {}
        self._pending: Optional[Dict[int, Any]] = None
        self._quant = _comm.config()
        self._overlap = _env.get_bool("MXNET_COMM_OVERLAP")
        # a quantized bucket's residuals, {bucket ordinal: [(grad row,
        # weight block) per local shard]}
        self._qstate: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
        self._pending_q: Optional[Dict[str, Any]] = None

    # ---- the shards -------------------------------------------------------
    def _ensure_layout(self, devices: List[torch.device], dist: bool):
        from ..parallel import dist as _dist

        dist = dist and _dist.num_workers() > 1
        key = (tuple(str(d) for d in devices), dist)
        if self._layout is not None:
            if self._layout != key:
                raise FusedUnsupported(
                    "spmd: the replica layout changed mid-run; falling "
                    "back to the per-replica path")
            return
        self._layout = key
        if dist:
            self._nshard = _dist.num_workers()
            self._shards = [(_dist.rank(), devices[0])]
        else:
            self._nshard = len(devices)
            self._shards = list(enumerate(devices))
        self._dist = dist
        self._flat = self._zero and self._nshard > 1

    @property
    def nshard(self) -> int:
        return self._nshard

    def shard_factor(self) -> int:
        """Ways the bucketed states split."""
        return self._nshard if self._flat else 1

    def state_bytes(self, local: bool = False) -> int:
        """Bytes of the optimizer states (fp32 master copies included,
        the residuals of ``MXNET_COMM_QUANT`` not): the whole job's, or
        with ``local`` this process's."""
        def nbytes(trees):
            return sum(x.numel() * x.element_size() for t in trees
                       for x in _tree_leaves(t))

        split = nbytes([t for ts in self._bstate.values() for t in ts]) \
            + nbytes([t for ts in self._sstate.values() for t in ts])
        whole = nbytes(list(self._pstate.values()))
        if not local and self._dist:
            split *= self._nshard
        return split + whole

    # ---- the plan ---------------------------------------------------------
    def _build_plan(self, indices: List[int]) -> _Plan:
        opt = self.optimizer
        elementwise = bool(opt._FUSED_ELEMENTWISE)
        zero_min = _env.get_int("MXNET_ZERO_MIN_SIZE") or 0
        cap = _env.get_int("MXNET_SPMD_BUCKET_BYTES") \
            or _env.get_int("MXNET_FUSED_BUCKET_BYTES")
        buckets: List[_Bucket] = []
        smalls: Dict[Tuple, List[int]] = {}
        singles: List[int] = []
        cur: List[int] = []
        cur_key, cur_bytes = None, 0

        def close():
            nonlocal cur, cur_bytes
            if cur:
                sizes = tuple(self._meta[indices[q]].padded for q in cur)
                offs, off = [], 0
                for s in sizes:
                    offs.append(off)
                    off += s
                buckets.append(_Bucket(tuple(cur), tuple(offs), sizes,
                                       off, self._mp[indices[cur[0]]]))
            cur, cur_bytes = [], 0

        for p, i in enumerate(indices):
            m = self._meta[i]
            if not self._flat or m.size < zero_min:
                smalls.setdefault((str(m.dtype), self._mp[i]),
                                  []).append(p)
                continue
            if not elementwise:
                singles.append(p)
                continue
            key = (m.dtype, self._mp[i])
            nbytes = m.padded * torch.empty((), dtype=m.dtype).element_size()
            if cur and (key != cur_key or cur_bytes + nbytes > cap):
                close()
            cur.append(p)
            cur_key, cur_bytes = key, cur_bytes + nbytes
        close()
        small_groups = tuple(
            _Small(tuple(ps), tuple(self._meta[indices[p]].size for p in ps))
            for _, ps in sorted(smalls.items()))
        return _Plan(tuple(buckets), small_groups, tuple(singles))

    def _quant_buckets(self, plan: _Plan) -> Tuple[int, ...]:
        if not (self._flat and self._quant.active):
            return ()
        return tuple(bi for bi, b in enumerate(plan.buckets)
                     if self._quant.applies(b.total))

    def _block(self, n: int, s: int) -> slice:
        k = n // self._nshard
        return slice(s * k, (s + 1) * k)

    # ---- the states -------------------------------------------------------
    def _materialize(self, indices, weights0):
        """The plan's state storage from the pending payload, else from
        states made fresh on replica 0's weights."""
        opt = self.optimizer
        pend = self._pending or {}
        dev0 = self._update_device()

        def full_tree(i, w):
            if i in pend:
                return _tree_map(_host_tensor, pend[i])
            return _tree_map(lambda nd: nd._data,
                             opt.create_state_multi_precision(i, w))

        trees = {i: full_tree(i, w) for i, w in zip(indices, weights0)}
        plan = self._plan
        self._bstate.clear()
        self._sstate.clear()
        self._pstate.clear()
        for bi, b in enumerate(plan.buckets):
            def cat(leaves, b=b):
                flat = torch.cat([
                    _pad_flat(leaf, self._meta[indices[p]].padded)
                    for leaf, p in zip(leaves, b.pos)])
                return flat
            whole = _tree_multi(cat, [trees[indices[p]] for p in b.pos])
            self._bstate[bi] = [
                _tree_map(lambda f, s=s, d=d: f[self._block(b.total, s)]
                          .to(d, copy=True), whole)
                for s, d in self._shards]
        for g in plan.smalls:
            for p in g.pos:
                i = indices[p]
                self._pstate[i] = _tree_map(
                    lambda t: t.to(dev0, copy=True), trees[i])
        for p in plan.singles:
            i = indices[p]
            m = self._meta[i]
            whole = _tree_map(lambda t, m=m: _pad_flat(t, m.padded),
                              trees[i])
            self._sstate[i] = [
                _tree_map(lambda f, s=s, d=d, m=m: f[self._block(
                    m.padded, s)].to(d, copy=True), whole)
                for s, d in self._shards]
        self._qstate.clear()
        qbis = self._quant_buckets(plan)
        pq = self._pending_q or {}
        pg, pw = pq.get("grads") or {}, pq.get("weights") or {}
        for bi in qbis:
            b = plan.buckets[bi]
            gres = torch.zeros(b.total, dtype=torch.float32)
            wflat = torch.zeros(b.total, dtype=torch.float32)
            for p, off in zip(b.pos, b.offsets):
                i = indices[p]
                m = self._meta[i]
                if i in pg:
                    gres[off:off + m.size] = _host_tensor(
                        np.asarray(pg[i], np.float32)).reshape(-1)
                if i in pw:
                    wflat[off:off + m.size] = _host_tensor(
                        np.asarray(pw[i], np.float32)).reshape(-1)
            # the gradient side's sum over the rows is the state: it goes
            # to shard 0's row
            self._qstate[bi] = [
                ((gres if s == 0 else torch.zeros_like(gres)).to(d),
                 wflat[self._block(b.total, s)].to(d, copy=True))
                for s, d in self._shards]
        self._pending = None
        self._pending_q = None

    def _update_device(self) -> torch.device:
        return self._shards[0][1]

    # ---- probes -----------------------------------------------------------
    def supports(self, indices: List[int], weights) -> bool:
        """False when this set must take a fallback path: an optimizer
        whose update carries t, on half weights without a master copy."""
        opt = self.optimizer
        if not opt._FUSED_T_HYPER:
            return True
        return not any(
            w._data.dtype in (torch.float16, torch.bfloat16)
            and not opt.multi_precision for w in weights)

    # ---- the step ---------------------------------------------------------
    def update_all_mesh(self, indices: List[int], grads: List[List],
                        weights: List[List], dist: bool = False) -> None:
        """One step over every parameter: ``grads[p][r]`` and
        ``weights[p][r]`` are parameter p's replica r (NDArrays), replica
        r of every parameter on the same device; with ``dist`` the sum
        runs over the ranks of the process group too."""
        opt = self.optimizer
        nrep = len(weights[0])
        devices = [w._data.device for w in weights[0]]
        if opt._FUSED_T_HYPER and not opt.multi_precision and any(
                w[0]._data.dtype in (torch.float16, torch.bfloat16)
                for w in weights):
            raise FusedUnsupported(
                f"{type(opt).__name__}: half-precision weights without "
                "multi_precision need the eager loop")
        self._ensure_layout(devices, dist)
        for i, w in zip(indices, weights):
            if i not in self._meta:
                shp = tuple(w[0].shape)
                n = int(np.prod(shp)) if shp else 1
                self._meta[i] = _Meta(shp, w[0]._data.dtype, n,
                                      _padded(n, self._nshard))
            self._mp[i] = bool(opt.multi_precision and w[0]._data.dtype in (
                torch.float16, torch.bfloat16))
        idx_key = tuple(indices)
        if self._plan is None or self._plan_indices != idx_key:
            if self._plan is not None:
                self.set_states(self.get_states(dump_optimizer=False))
            self._plan = self._build_plan(indices)
            self._plan_indices = idx_key
            self._materialize(indices, [w[0] for w in weights])
        # the update count: N bumps, the scalars of the first
        hypers = []
        for i in indices:
            opt._update_count(i)
            t_first = opt._index_update_count[i]
            for _ in range(nrep - 1):
                opt._update_count(i)
            hypers.append(opt.fused_hyper(i, t_first))
        names = tuple(hypers[0])
        hdt = torch.float64 if any(self._meta[i].dtype == torch.float64
                                   for i in indices) else torch.float32
        host = torch.tensor([[h[k] for k in names] for h in hypers],
                            dtype=hdt)
        hyper_on = {}

        def hyper(p, dev):
            t = hyper_on.get(dev)
            if t is None:
                t = hyper_on[dev] = host.to(dev)
            return {k: t[p, j] for j, k in enumerate(names)}

        with torch.no_grad():
            self._step(indices, grads, weights, hyper)

    def _local_sum(self, g: List, dev) -> torch.Tensor:
        """A parameter's gradient summed over this process's replicas,
        pairwise, on ``dev``."""
        parts = [x._data.detach().to(dev) for x in g]
        return parts[0] if len(parts) == 1 else _balanced_sum(parts)

    def _step(self, indices, grads, weights, hyper):
        from ..parallel import dist as _dist

        plan = self._plan
        metas = [self._meta[i] for i in indices]
        qbis = set(self._quant_buckets(plan))
        dev0 = self._update_device()
        # -- the reduce: every bucket's collective (in reverse order under
        # MXNET_COMM_OVERLAP, each issued before any is waited for)
        order = range(len(plan.buckets))
        if self._overlap:
            order = reversed(order)
        pending = {}
        for bi in order:
            b = plan.buckets[bi]
            if bi in qbis:
                pending[bi] = self._reduce_quant(bi, b, grads, metas)
            else:
                pending[bi] = self._reduce_bucket(b, grads, metas)
            if not self._overlap:
                pending[bi] = pending[bi]()
        for bi in list(pending):
            if callable(pending[bi]):
                pending[bi] = pending[bi]()
        # -- the buckets' updates, block by block
        new_parts = {}
        for bi, b in enumerate(plan.buckets):
            blocks = pending[bi]
            outs = []
            for (s, d), gblk, st in zip(self._shards, blocks,
                                        self._bstate[bi]):
                outs.append(self._update_block(b, s, d, gblk, st, indices,
                                               weights, hyper))
            new_parts[bi] = outs
        # -- the small groups: one all-reduce each, whole updates
        for g in plan.smalls:
            cat = torch.cat([self._local_sum(grads[p], dev0).reshape(-1)
                             for p in g.pos])
            if self._dist:
                cat = _dist.all_reduce_(_dist._on_group_device(cat)).to(dev0)
            off = 0
            for p in g.pos:
                i, m = indices[p], metas[p]
                gi = cat[off:off + m.size].view(m.shape)
                off += m.size
                w = weights[p][0]._data
                nw, ns = apply_param(self.optimizer, w, gi, self._pstate[i],
                                     self._mp[i], hyper(p, dev0))
                _write_tree(self._pstate[i], ns)
                for r in weights[p]:
                    r._data.copy_(nw)
        # -- the singles (LAMB): phase 1 per shard, the norms, phase 2
        for p in plan.singles:
            self._step_single(p, indices[p], metas[p], grads[p], weights[p],
                              hyper)
        # -- the gather: every bucket's new weights into every replica
        for bi, b in enumerate(plan.buckets):
            if bi in qbis:
                full = self._gather_quant(bi, b, new_parts[bi], weights,
                                          metas)
            else:
                full = self._gather(new_parts[bi], b.total)
            self._scatter_weights(b, full, weights, metas)

    def _reduce_bucket(self, b: _Bucket, grads, metas):
        """Start a bucket's reduce-scatter: returns the function that
        gives each local shard's block of the summed gradient."""
        from ..parallel import dist as _dist

        dev0 = self._update_device()
        flat = torch.cat([_pad_flat(self._local_sum(grads[p], dev0),
                                    metas[p].padded) for p in b.pos])
        if self._dist:
            wait = _dist.reduce_scatter_start(_dist._on_group_device(flat))
            return lambda: [wait().to(dev0)]
        return lambda: [flat[self._block(b.total, s)].to(d)
                        for s, d in self._shards]

    def _rows(self, b: _Bucket, grads, metas):
        """This process's rows of a bucket's gradient (fp32): one per
        local replica, or on a dist job the rank's local sum."""
        dev0 = self._update_device()
        if self._dist:
            return [torch.cat([
                _pad_flat(self._local_sum(grads[p], dev0), metas[p].padded)
                for p in b.pos]).float()]
        return [torch.cat([_pad_flat(grads[p][s]._data.detach().to(d),
                                     metas[p].padded) for p in b.pos])
                .float() for s, d in self._shards]

    def _exchange(self, codes_scales):
        """Every shard's (codes, scale), shard order, on each local
        shard's device: gathered over the ranks on a dist job.  Returns
        the function that gives the list."""
        from ..parallel import dist as _dist

        if not self._dist:
            return lambda: [codes_scales] * len(self._shards)
        codes, scale = codes_scales[0]
        bits = codes.view(torch.uint8) if codes.dtype != torch.int8 \
            else codes
        w_codes = _dist.all_gather_list_start(_dist._on_group_device(bits))
        w_scale = _dist.all_gather_list_start(_dist._on_group_device(scale))
        dev0 = self._update_device()

        def wait():
            cs = [c.to(dev0) for c in w_codes()]
            if codes.dtype != torch.int8:
                cs = [c.view(codes.dtype) for c in cs]
            return [list(zip(cs, [s.to(dev0) for s in w_scale()]))]
        return wait

    def _reduce_quant(self, bi, b: _Bucket, grads, metas):
        """Start a quantized bucket's reduce: each row (plus its residual)
        encoded; every shard sums the decoded rows of its block."""
        mode, ef = self._quant.mode, self._quant.ef
        rows = self._rows(b, grads, metas)
        enc = []
        for j, row in enumerate(rows):
            gres = self._qstate[bi][j][0]
            acc = (row + gres if ef else row)[None]
            codes, scale = _comm.encode(acc, mode)
            gres.copy_((acc - _comm.decode(codes, scale))[0] if ef
                       else torch.zeros_like(gres))
            enc.append((codes, scale))
        wait = self._exchange(enc)
        gdt = self._meta[self._plan_indices[b.pos[0]]].dtype

        def finish():
            got = wait()
            out = []
            for (s, d), every in zip(self._shards, got):
                blk = self._block(b.total, s)
                red = None
                for codes, scale in every:
                    v = _comm.decode(codes.to(d), scale.to(d))[0, blk]
                    red = v if red is None else red + v
                out.append(red.to(gdt))
            return out
        return finish

    def _update_block(self, b: _Bucket, s, dev, gblk, state, indices,
                      weights, hyper):
        """Shard s's block of bucket ``b`` updated, parameter by
        parameter on its slice: the block's new weights, rounded to the
        weights' dtype (as the JAX ``apply_param`` returns them, and as
        the per-replica update writes them)."""
        k = b.total // self._nshard
        lo, hi = s * k, (s + 1) * k
        out = None
        for p, off, sz in zip(b.pos, b.offsets, b.sizes):
            a, z = max(lo, off), min(hi, off + sz)
            if a >= z:
                continue
            m = self._meta[indices[p]]
            w = _pad_flat(weights[p][0]._data.detach(), m.padded)[
                a - off:z - off].to(dev)
            sl = slice(a - lo, z - lo)
            st = _tree_map(lambda t: t[sl], state)
            nw, ns = apply_param(self.optimizer, w, gblk[sl], st, b.mp,
                                 hyper(p, dev))
            _write_tree(st, ns)
            if out is None:
                out = torch.empty(k, dtype=m.dtype, device=dev)
            out[sl] = nw
        return out

    def _gather(self, blocks, total):
        """The full flat from every shard's block."""
        from ..parallel import dist as _dist

        if self._dist:
            blk = blocks[0]
            full = torch.empty(total, dtype=blk.dtype,
                               device=_dist._on_group_device(blk).device)
            _dist.all_gather_(full, _dist._on_group_device(blk))
            return full.to(blk.device)
        dev0 = self._update_device()
        return torch.cat([x.to(dev0) for x in blocks])

    def _gather_quant(self, bi, b: _Bucket, blocks, weights, metas):
        """A quantized bucket's weight leg: each block's delta to the old
        weights (plus its residual) encoded and gathered; the old flat
        plus the decoded deltas."""
        mode, ef = self._quant.mode, self._quant.ef
        dev0 = self._update_device()
        old = torch.cat([_pad_flat(weights[p][0]._data.detach().to(dev0),
                                   metas[p].padded).float()
                         for p in b.pos])
        enc = []
        for j, ((s, d), blk) in enumerate(zip(self._shards, blocks)):
            wres = self._qstate[bi][j][1]
            delta = blk.float() - old[self._block(b.total, s)].to(d)
            acc = (delta + wres if ef else delta)[None]
            codes, scale = _comm.encode(acc, mode)
            wres.copy_((acc - _comm.decode(codes, scale))[0] if ef
                       else torch.zeros_like(wres))
            enc.append((codes, scale))
        every = self._exchange(enc)()[0]
        deq = torch.cat([_comm.decode(c.to(dev0), sc.to(dev0))[0]
                         for c, sc in every])
        return old + deq

    def _scatter_weights(self, b: _Bucket, full, weights, metas):
        for p, off in zip(b.pos, b.offsets):
            m = metas[p]
            seg = full[off:off + m.size].view(m.shape)
            for r in weights[p]:
                r._data.copy_(seg)

    def _step_single(self, p, i, m: _Meta, g, w, hyper):
        """A norm-based optimizer's tensor, split over the shards."""
        from ..parallel import dist as _dist

        opt = self.optimizer
        dev0 = self._update_device()
        flat = _pad_flat(self._local_sum(g, dev0), m.padded)
        if self._dist:
            flat = flat.clone()  # the collective writes into it
            gblks = [_dist.reduce_scatter(_dist._on_group_device(flat))
                     .to(dev0)]
        else:
            gblks = [flat[self._block(m.padded, s)].to(d)
                     for s, d in self._shards]
        wflat = _pad_flat(w[0]._data.detach(), m.padded)
        mp = self._mp[i]
        phase1 = []
        sq = None
        for (s, d), gb, st in zip(self._shards, gblks, self._sstate[i]):
            h = hyper(p, d)
            if mp:
                inner, w32 = st
                wb, inner_st = w32, inner
                gb = gb.to(torch.float32)
            else:
                wb, inner_st = wflat[self._block(m.padded, s)].to(d), st
            direction, ns = opt.fused_phase1(wb, gb, inner_st, h)
            part = torch.stack([wb.square().sum(),
                                direction.square().sum()]).to(dev0)
            sq = part if sq is None else sq + part
            phase1.append((wb, direction, ns, h))
        if self._dist:
            sq = _dist.all_reduce_(_dist._on_group_device(sq)).to(dev0)
        norms = sq.sqrt()
        blocks = []
        for ((s, d), st, (wb, direction, ns, h)) in zip(
                self._shards, self._sstate[i], phase1):
            nw = opt.fused_phase2(wb, direction, norms[0].to(d),
                                  norms[1].to(d), h)
            if mp:
                _write_tree(st, (ns, nw))
            else:
                _write_tree(st, ns)
            blocks.append(nw)
        full = self._gather(blocks, m.padded)
        seg = full[:m.size].view(m.shape)
        for r in w:
            r._data.copy_(seg)

    # ---- serialization ----------------------------------------------------
    def _whole(self, blocks, n: int) -> torch.Tensor:
        """A state leaf's full flat (host) from its local blocks."""
        return self._gather(list(blocks), n).cpu()

    def get_states(self, dump_optimizer=False):
        """The canonical payload: per parameter index, full-shape host
        states, as ``Updater.get_states`` gives (a collective on a dist
        job)."""
        payload: Dict[Any, Any] = {}
        indices = list(self._plan_indices or ())
        plan = self._plan
        if plan is not None:
            for bi, b in enumerate(plan.buckets):
                trees = self._bstate[bi]
                whole = _tree_multi(lambda ls, b=b: self._whole(ls, b.total),
                                    trees)
                for p, off in zip(b.pos, b.offsets):
                    m = self._meta[indices[p]]
                    payload[indices[p]] = _tree_map(
                        lambda f, off=off, m=m: to_numpy(
                            f[off:off + m.size].reshape(m.shape)), whole)
            for i, trees in self._sstate.items():
                m = self._meta[i]
                whole = _tree_multi(lambda ls, m=m: self._whole(ls,
                                                                m.padded),
                                    trees)
                payload[i] = _tree_map(lambda f, m=m: to_numpy(
                    f[:m.size].reshape(m.shape)), whole)
            for i, tree in self._pstate.items():
                payload[i] = _tree_map(to_numpy, tree)
        for i, tree in (self._pending or {}).items():
            if i not in payload:
                payload[i] = _tree_map(np.asarray, tree)
        if self._qstate and plan is not None:
            gsum_d, wflat_d = {}, {}
            for bi, pairs in sorted(self._qstate.items()):
                b = plan.buckets[bi]
                gsum = self._sum_rows([g for g, _ in pairs], b.total)
                wflat = self._whole([w for _, w in pairs], b.total)
                for p, off in zip(b.pos, b.offsets):
                    i = indices[p]
                    m = self._meta[i]
                    gsum_d[i] = gsum[off:off + m.size].reshape(
                        m.shape).numpy()
                    wflat_d[i] = wflat[off:off + m.size].reshape(
                        m.shape).numpy()
            payload[_comm.RESIDUAL_KEY] = _comm.canonical_residuals(
                gsum_d, wflat_d, self._quant.mode)
        elif self._pending_q is not None:
            payload[_comm.RESIDUAL_KEY] = self._pending_q
        if dump_optimizer:
            return pickle.dumps((payload, type(self.optimizer).__name__,
                                 self.optimizer.__dict__.copy()))
        return pickle.dumps(payload)

    def _sum_rows(self, rows, n: int) -> torch.Tensor:
        """The sum of every shard's gradient residual row (host)."""
        from ..parallel import dist as _dist

        if self._dist:
            got = _dist.all_gather_list(_dist._on_group_device(rows[0]))
            rows = got
        total = None
        for r in rows:
            r = r.cpu()
            total = r if total is None else total + r
        return total

    def set_states(self, states, ctx=None):
        """Take a payload; it is split over whatever shards the next step
        runs on (``ctx`` is not needed: the shards place it)."""
        data = pickle.loads(states)
        if isinstance(data, tuple) and len(data) == 3:
            data = data[0]
        data = dict(data)
        self._pending_q = data.pop(_comm.RESIDUAL_KEY, None)
        self._pending = data
        self._bstate.clear()
        self._sstate.clear()
        self._pstate.clear()
        self._qstate.clear()
        self._plan = None
        self._plan_indices = None
