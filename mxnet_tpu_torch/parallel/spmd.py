"""SPMDTrainer (counterpart of ``mxnet_tpu/parallel/spmd.py``).

The JAX package compiles forward, backward and update into one sharded
XLA program per step.  PyTorch runs eagerly, so here a step is the same
three phases in order on this rank's device:

  1. the forward of the block and the loss inside ``ActiveTrace(train=
     True)`` and the mesh scope, so that code gated on a trace (the
     fused ResNet path, BatchNorm's train flag) behaves as in the JAX
     trace, and the loss is the mean over the batch; dropout draws from
     the step's device's generator (``random.generator``), as the JAX
     step takes a fresh key a step;
  2. ``torch.autograd.grad`` over the trainable parameters, each tensor
     once: a tied parameter (one ``nn.Parameter`` under several
     structural names, BERT's decoder weight, the Transformer's shared
     embedding) is trained under its first name in the block's order,
     as the JAX package's ``collect_params`` lists it once;
  3. the per-parameter update of the functional optimizer under
     ``torch.no_grad``, written back in place into the block's
     parameters and the optimizer state.

Over a mesh of N > 1 positions (one rank per position over a
``parallel.dist`` process group; ``make_mesh(dp=2)``, ``make_mesh(fsdp=2)``,
``make_mesh(tp=2)``, ``make_mesh(dp=2, sp=2)``): every rank is handed the
global batch and keeps its own block of rows (``shard_batch``: the block
of its ``dp`` x ``fsdp`` position; the ranks along ``tp``, ``sp`` and the
other axes hold the same rows).  The reductions that GSPMD places in the
JAX package are placed by hand:

  (a) sums over the batch inside the forward (BatchNorm statistics, the
      fused unit's s1/s2) go through ``dist.all_reduce_sum`` over the
      batch axes' group, whose backward sums their cotangents;
  (b) after ``torch.autograd.grad`` each gradient is summed over the
      batch axes it still lacks, one flat bucket per group and dtype,
      before the update, so that weight decay and clipping see the
      global gradient.  Never over ``tp`` or ``sp``: their ranks hold the
      same rows and compute the same gradient.

Each rank differentiates its share of the global mean loss, Σ_local ℓ /
N_global, so (b) yields the gradient of the global mean; ``step``
returns the summed shares, the global mean loss.  Parameters and buffers
are broadcast from rank 0 when the trainer is built, so every rank
starts from the same state.

Sharded parameters: ``rules`` (a ``ShardingRules`` table, matched against
each parameter's MXNet name, ``gluon.block.mx_param_names``, as the JAX
trainer matches ``collect_params``' names) give each trained tensor its
spec.  Rank r keeps only its block of a tensor whose spec splits it
(``parallel._compat.block_of``; the module's ``nn.Parameter`` holds the
block, so 1/k of its bytes rest on the rank) and only that block's
optimizer state.  The forward gathers the blocks on use
(``_compat.gather``, swapped into the modules for the step, as
``_OnReplica`` swaps replicas); the backward of the gather brings the
gradient back onto the block: over a batch axis (``fsdp``) the ranks
hold different rows, so it is a reduce-scatter (sum); over ``tp``,
``sp`` or ``ep`` they hold the same rows, so it keeps this rank's slice
and sums nothing.  The gathered forward computes what the JAX package
computes (Megatron's column/row-parallel layout, with activations split
over ``tp``, is a performance change this port does not make).  After
training, ``sync_to_block()`` puts the gathered tensors back into the
block (the next step cuts them again).

BatchNorm running statistics are updated in place during the forward
(the JAX package folds them back after the step; the values are the
same).  Each parameter's ``lr_mult`` and ``wd_mult`` (read when the
trainer is built, as the JAX package reads them) scale its lr and wd.

The compiled step (the JAX package's ``_get_step``): on one device the
whole step — forward, backward and update — is captured as a CUDA graph
once per signature and replayed per call (``_graphs``).  The
signature is the JAX package's (the block, the parameter names and
mults, the optimizer class and statics, the devices, the inputs' shapes
and dtypes) plus the fused-unit knobs the forward reads and the address
of every parameter, buffer and state tensor: a tensor whose storage
moved (``load_parameters``, ``cast``) forces a counted new capture,
never a replay onto old storage.  A trainer keeps 16 signatures
(``_STEP_FNS_MAX``); ``step_compile_stats()`` counts the builds.  The
per-step scalars lr (fp32) and t (int32) live in device buffers that the
host writes before each step, as the JAX step takes them as arguments,
so ``set_learning_rate`` never captures again; dropout draws from the
device's generator, registered with the graph, so each replay draws a
fresh mask.  The step returns a fresh loss tensor each call.  Over
several ranks the step stays eager (the process group's collectives are
not captured; ``step_compile_stats()["eager"]`` counts those steps), and
``_step_eager`` is the eager step the captured one is held against.

The JAX keywords: ``rules`` (above), ``batch_spec``/``label_spec`` (one
spec per input, any layout the JAX trainer takes, checked as its
``device_put`` checks it; ``None`` or a spec splitting dim 0 over a batch
axis gives each rank its block of rows over all the batch axes, and
splits of other dims change placement only, ``sharding.input_split``;
when not every argument is split, each rank is given every argument
whole and runs the whole batch as one device would, with no batch sum in
its forward and no gradient sum, and the loss is the same global mean),
``donate``
(accepted; the update is in place already) and
``remat`` (the forward runs under ``ActiveTrace(mirror=True)``: each
sub-block that owns parameters is a checkpoint segment, the JAX
package's ``jax.checkpoint`` segments; captured at dp = 1 like any
step).

ZeRO-1 (``MXNET_ZERO_STATES``, default on, as in the JAX package): when
the batch is split, the optimizer state of a trained tensor of at least
``MXNET_ZERO_MIN_SIZE`` elements is split over the batch axes its spec
does not use, on the largest dim of its block that they divide
(``sharding.zero_state_spec``); each rank keeps its block of each state
(and of the fp32 master weight under ``multi_precision``).  Such a
tensor's gradient is reduce-scattered over those axes (one flat bucket
per group and dtype, laid out rank-major), the rank updates its block of
the weight with its block of the state, and the blocks are all-gathered
into the weight.  The update is elementwise, so the weights are the bits
of the replicated update; smaller tensors keep whole states and the
all-reduce of (b).

``save_checkpoint``/``load_checkpoint`` (``parallel.checkpoint``) write
and read the parameters, buffers, every optimizer state as global
tensors and the step count; a load lands on any mesh (fsdp = 2 resumes at
dp = 2 or dp = 1) and writes into the existing storages, so a captured
step stays valid.  ``forward`` runs each rank's rows and gathers the
outputs over the batch axes into the global batch, as the JAX trainer
returns it.

Not ported in this slice: flat optimizer groups
(``MXNET_FUSED_OPTIMIZER``, ROADMAP.md queue A item 2) and the telemetry
hooks (item 10). MXNet's own data-parallel API (``gluon.Trainer`` over
replicas and dist KVStores, its ``spmd=True`` step) is
``gluon/trainer.py``, ``kvstore.py`` and ``optimizer/spmd.py``; its ZeRO
layout is the flat padded bucket, this trainer's the split of each state
along one dim.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..base import MXNetError
from ..gluon.block import ActiveTrace, _homes, mx_param_names, param_keys
from .. import ops
from .. import optimizer as opt_mod
from .. import random as _random
from .. import _graphs
from ..util import env as _env
from . import dist
from ._compat import block_of, gather, gather_blocks, gather_dim
from .mesh import BATCH_AXES, DeviceMesh, batch_shards, current_mesh, \
    make_mesh
from .sharding import (DEFAULT_RULES, P, ShardingRules, _axes_of,
                       input_split, shard_batch, spec_split,
                       zero_state_spec)

__all__ = ["SPMDTrainer", "functional_optimizer", "FunctionalOptimizer",
           "step_compile_stats"]

# signatures a trainer keeps captured steps for (the JAX package's
# per-trainer LRU of input shapes)
_STEP_FNS_MAX = 16
_STEP_CACHE = _graphs.ExecutableCache("parallel.spmd_step",
                                     per_owner_max=_STEP_FNS_MAX)


def step_compile_stats():
    """SPMDTrainer step builds in this process (the shape of
    ``optimizer.fused.compile_stats``)."""
    return _STEP_CACHE.stats()


def _rank_major(t, d, n):
    """``t`` with dim ``d`` first, as (n, -1): row r is block r of dim d."""
    return t.movedim(d, 0).reshape(n, -1)


def _scatter_rank_major(t, rows, d):
    """Copy the (n, -1) ``rows`` (block r of dim ``d`` in row r) into
    ``t``."""
    moved = (t.shape[d],) + tuple(s for i, s in enumerate(t.shape) if i != d)
    t.copy_(rows.reshape(moved).movedim(0, d))


class _Swapped:
    """The gathered tensor of every split parameter in its modules for
    the step (each home of a tied one), the blocks put back after."""

    def __init__(self, block, full: Dict[int, torch.Tensor]):
        self._block, self._full, self._undo = block, full, []

    def __enter__(self):
        for d, n, _ in _homes(self._block):
            t = d[n]
            if t is not None and id(t) in self._full:
                self._undo.append((d, n, t))
                d[n] = self._full[id(t)]
        return self

    def __exit__(self, *exc):
        for d, n, t in reversed(self._undo):
            d[n] = t
        self._undo = []
        return False


class FunctionalOptimizer:
    """Pure update ``(w, g, state, lr, t) -> (w', state')``.  lr is a
    float or a 0-d fp32 tensor, t an int or a 0-d int32 tensor (the
    step's device buffers); the two give the same bits."""

    def __init__(self, n_state: int, update: Callable, wd: float = 0.0,
                 clip_gradient: float = -1.0,
                 begin_step: Optional[Callable] = None):
        self.n_state = n_state
        self._update = update
        self.wd = wd
        self.clip_gradient = clip_gradient
        # set from Optimizer.multi_precision by functional_optimizer()
        self.multi_precision = False
        self._begin_step = begin_step

    def begin_step(self) -> None:
        """Forget what the previous step computed once for all leaves
        (Adam's bias correction); called at the start of every step, and
        of every capture, so a captured step computes it inside the
        graph."""
        if self._begin_step is not None:
            self._begin_step()

    def needs_master(self, value) -> bool:
        """Half-precision weights under multi_precision get fp32 state and
        an fp32 master weight, carried as the last state element."""
        return (self.multi_precision
                and value.dtype in (torch.bfloat16, torch.float16))

    def init(self, value) -> Tuple[torch.Tensor, ...]:
        if self.needs_master(value):
            return tuple(torch.zeros(value.shape, dtype=torch.float32,
                                     device=value.device)
                         for _ in range(self.n_state)) + (
                value.detach().float().clone(),)
        return tuple(torch.zeros_like(value) for _ in range(self.n_state))

    def apply(self, value, grad, state, lr, t, lr_mult=1.0, wd_mult=1.0):
        lr = lr if lr_mult == 1.0 else lr * lr_mult
        return self._update(value, grad, state, lr, self.wd * wd_mult,
                            self.clip_gradient, t)


def functional_optimizer(opt) -> FunctionalOptimizer:
    """The pure update for an Optimizer instance (or name): the JAX
    package's functional forms, of SGD, NAG, Adam, RMSProp (plain and
    centred), AdaGrad, Signum, SignSGD, AdaDelta, Adamax and Ftrl, over
    the same update ops; any other optimizer raises, with the JAX
    package's message."""
    if isinstance(opt, str):
        opt = opt_mod.create(opt)
    kind = type(opt).__name__
    make = _FORMS.get(kind)
    if make is None:
        raise MXNetError(
            f"no functional form for optimizer {kind}; supported: SGD, NAG, "
            "Adam, RMSProp, AdaGrad, Signum, SignSGD, AdaDelta, Adamax, Ftrl")
    wd = float(opt.wd)
    clip = float(opt.clip_gradient) if opt.clip_gradient is not None \
        else -1.0
    fo = make(opt, wd, clip)
    fo.multi_precision = bool(getattr(opt, "multi_precision", False))
    return fo


def _stateful(n_state, op, wd, clip, **statics) -> FunctionalOptimizer:
    """The form of an update op over n_state state tensors that returns
    (w', *state'); ``statics`` are its fixed attributes."""
    def update(w, g, s, lr, wd_, c, t):
        nw, *ns = op(w, g, *s, lr=lr, wd=wd_, clip_gradient=c, **statics)
        return nw, tuple(ns)
    return FunctionalOptimizer(n_state, update, wd, clip)


def _stateless(op, wd, clip) -> FunctionalOptimizer:
    def update(w, g, s, lr, wd_, c, t):
        return op(w, g, lr=lr, wd=wd_, clip_gradient=c), ()
    return FunctionalOptimizer(0, update, wd, clip)


def _functional_sgd(opt, wd, clip) -> FunctionalOptimizer:
    momentum = float(getattr(opt, "momentum", 0.0))
    if momentum == 0.0:
        return _stateless(ops.sgd_update, wd, clip)
    op = ops.nag_mom_update if type(opt).__name__ == "NAG" \
        else ops.sgd_mom_update
    return _stateful(1, op, wd, clip, momentum=momentum)


def _functional_rmsprop(opt, wd, clip) -> FunctionalOptimizer:
    """Plain or centred; the JAX form passes no ``clip_weights``."""
    g1 = float(getattr(opt, "gamma1", 0.9))
    eps = float(getattr(opt, "epsilon", 1e-8))
    if getattr(opt, "centered", False):
        return _stateful(3, ops.rmspropalex_update, wd, clip, gamma1=g1,
                         gamma2=float(getattr(opt, "gamma2", 0.9)),
                         epsilon=eps)
    return _stateful(1, ops.rmsprop_update, wd, clip, gamma1=g1,
                     epsilon=eps)


def _functional_adagrad(opt, wd, clip) -> FunctionalOptimizer:
    return _stateful(1, ops.adagrad_update, wd, clip,
                     epsilon=float(opt.float_stable_eps))


def _functional_signum(opt, wd, clip) -> FunctionalOptimizer:
    momentum = float(getattr(opt, "momentum", 0.0))
    if momentum == 0.0:
        return _stateless(ops.signsgd_update, wd, clip)
    return _stateful(1, ops.signum_update, wd, clip, momentum=momentum)


def _functional_adadelta(opt, wd, clip) -> FunctionalOptimizer:
    return _stateful(2, ops.adadelta_update, wd, clip, rho=float(opt.rho),
                     epsilon=float(opt.epsilon))


def _functional_ftrl(opt, wd, clip) -> FunctionalOptimizer:
    return _stateful(2, ops.ftrl_update, wd, clip,
                     lamda1=float(opt.lamda1), beta=float(opt.beta))


def _on_device_t(t, dev):
    """The step t as an fp32 0-d tensor on ``dev``, read from the step's
    int buffer (a host copy would be frozen into a captured step)."""
    return (t if isinstance(t, torch.Tensor) else torch.tensor(
        t, dtype=torch.int32, device=dev)).to(dev).float()


def _functional_adamax(opt, wd, clip) -> FunctionalOptimizer:
    """Adamax as the JAX form writes it: lr_t = lr / (1 - beta1^t) in fp32
    on the device from the int step t, passed to ``adamax_update`` as its
    lr with the op's own t left at 1, so the op divides lr_t by (1 -
    beta1) once more, as the JAX step does."""
    b1, b2 = float(opt.beta1), float(opt.beta2)
    dens = {}

    def update(w, g, s, lr, wd_, c, t):
        key = (t if isinstance(t, int) else id(t), w.device)
        if key not in dens:
            dens[key] = 1.0 - b1 ** _on_device_t(t, w.device)
        den = dens[key]
        lr_t = (lr.float() if isinstance(lr, torch.Tensor) else torch.full(
            (), float(lr), dtype=torch.float32, device=w.device)) / den
        nw, nm, nv = ops.adamax_update(w, g, s[0], s[1], lr=lr_t, beta1=b1,
                                       beta2=b2, wd=wd_, clip_gradient=c)
        return nw, (nm, nv)
    return FunctionalOptimizer(2, update, wd, clip, begin_step=dens.clear)


def _functional_adam(opt, wd, clip) -> FunctionalOptimizer:
    """Adam as the JAX package's functional form writes it: ``adam_update``
    with lr 1.0, then w + (w' - w) * (lr * coef), the bias correction
    coef = sqrt(1 - beta2^t) / (1 - beta1^t) in fp32 on the device from
    the int step t.  lr * coef is an fp32 tensor, so a half weight's step
    w' - w (rounded in its dtype) is scaled and added in fp32, then the
    caller casts the result to the weight's dtype.  Under
    ``multi_precision`` the same ``adam_update`` runs on the fp32 master
    with the half gradient, as the JAX package's ``apply_one`` runs it
    (``mp_adam_update`` would clip the gradient in fp32, where the JAX
    step clips it in its own dtype)."""
    b1, b2, eps = float(opt.beta1), float(opt.beta2), float(opt.epsilon)
    coefs = {}

    def coef_at(t, dev):
        """The bias correction of step t, once a step and device; t read
        on the device from the step's buffer (a host copy of an int t
        would be frozen into a captured step)."""
        key = (t if isinstance(t, int) else id(t), dev)
        if key not in coefs:
            tt = _on_device_t(t, dev)
            coefs[key] = torch.sqrt(1.0 - b2 ** tt) / (1.0 - b1 ** tt)
        return coefs[key]

    def update(w, g, s, lr, wd_, c, t):
        nw, nm, nv = ops.adam_update(w, g, s[0], s[1], lr=1.0, beta1=b1,
                                     beta2=b2, epsilon=eps, wd=wd_,
                                     clip_gradient=c)
        acc = torch.promote_types(w.dtype, torch.float32)
        lr = lr.to(acc) if isinstance(lr, torch.Tensor) else float(lr)
        scale = coef_at(t, w.device) * lr
        return w.to(acc) + (nw - w).to(acc) * scale, (nm, nv)
    return FunctionalOptimizer(2, update, wd, clip, begin_step=coefs.clear)


_FORMS = {"SGD": _functional_sgd, "NAG": _functional_sgd,
          "Adam": _functional_adam, "RMSProp": _functional_rmsprop,
          "AdaGrad": _functional_adagrad, "Signum": _functional_signum,
          "SignSGD": _functional_signum, "AdaDelta": _functional_adadelta,
          "Adamax": _functional_adamax, "Ftrl": _functional_ftrl}


class SPMDTrainer:
    """One training step per call over a DeviceMesh: one device, or data
    parallel over the ranks of a process group.

    Usage (bench.py's configuration)::

        parallel.dist.init()                  # DMLC_* env; no-op alone
        mesh = parallel.make_mesh(dp=parallel.dist.num_workers())
        trainer = parallel.SPMDTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}, mesh=mesh)
        loss = trainer.step(images, labels)   # 0-d tensor on the device

    The last ``n_labels`` arguments of ``step`` are labels, the rest
    model inputs, each the global batch.  Parameters are updated in
    place in the block.
    """

    def __init__(self, block, loss: Callable, optimizer="sgd",
                 optimizer_params: Optional[dict] = None,
                 mesh: Optional[DeviceMesh] = None,
                 rules: ShardingRules = DEFAULT_RULES,
                 batch_spec: Optional[Sequence] = None,
                 label_spec: Optional[Sequence] = None,
                 n_labels: int = 1, donate: bool = True,
                 remat: bool = False):
        self.block = block
        self.loss = loss
        self.mesh = mesh or current_mesh() or make_mesh()
        self.rules = rules
        self._batch_spec = batch_spec
        self._label_spec = label_spec
        self.n_labels = n_labels
        self._donate = bool(donate)  # no effect: updates are in place
        self.remat = bool(remat)
        self.device = self.mesh.local_device
        self._world = self.mesh.size()
        self._shards = batch_shards(self.mesh)
        # the batch axes of size > 1, in the mesh's order (the order of
        # their groups' ranks)
        self._batch_axes = tuple(a for a in self.mesh.axis_sizes
                                 if a in BATCH_AXES
                                 and self.mesh.size(a) > 1)
        # the forward's mesh when no input is split: every rank runs the
        # whole batch, as one device would
        self._solo = DeviceMesh({"dp": 1}, [self.device])
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        elif optimizer_params:
            raise MXNetError("optimizer_params must be None when optimizer "
                             "is an instance")
        self._optimizer = optimizer
        self._fopt = functional_optimizer(optimizer)
        block.to(self.device)
        named = block.state_dict(keep_vars=True)
        self._plist = sorted(named.items())
        if self._world > 1:
            # one start on every rank: rank 0's parameters and buffers
            uniq = {id(t): t for _, t in self._plist}
            dist.flat_buckets(list(uniq.values()), dist.broadcast_)
        first = {}  # a tied tensor's first structural name
        for n, p in named.items():
            first.setdefault(id(p), n)
        self._trainable = [n for n, p in self._plist
                           if isinstance(p, nn.Parameter) and p.requires_grad
                           and first[id(p)] == n]
        params = dict(self._plist)
        self.params: Dict[str, torch.Tensor] = {
            n: params[n] for n in self._trainable}
        # each trained tensor's spec, by its MXNet name (the names the
        # JAX trainer matches); a split one keeps this rank's block only
        mx_names = mx_param_names(block)
        self._shapes = {n: tuple(p.shape) for n, p in self.params.items()}
        self._specs: Dict[str, P] = {}
        for n, p in self.params.items():
            spec = rules.spec_for(mx_names.get(n, n), self._shapes[n],
                                  self.mesh)
            if spec_split(spec, self.mesh) > 1:
                self._specs[n] = P(*spec)
        self._split_ids = {id(self.params[n]): n for n in self._specs}
        self._ensure_blocks()
        # the batch axes each gradient is still summed over after its
        # gather's backward: those its spec does not split
        self._free = {n: tuple(a for a in self._batch_axes if a not in
                               {x for e in self._specs.get(n, ())
                                for x in _axes_of(e)})
                      for n in self._trainable}
        # ZeRO-1: the dim of its block each sharded state splits over
        # the free batch axes
        self._zero_dims: Dict[str, int] = {}
        if self._shards > 1 and _env.get_bool("MXNET_ZERO_STATES"):
            min_size = _env.get_int("MXNET_ZERO_MIN_SIZE")
            for n in self._trainable:
                spec = self._specs.get(n, P())
                sspec = zero_state_spec(spec, self._shapes[n], self.mesh,
                                        min_size=min_size)
                dims = [i for i, e in enumerate(sspec) if e is not None
                        and (i >= len(spec) or spec[i] is None)]
                if dims:
                    self._zero_dims[n] = dims[0]
        self._has_master = {n: self._fopt.needs_master(p)
                            for n, p in self.params.items()}
        self.opt_state: Dict[str, Tuple[torch.Tensor, ...]] = {
            n: self._fopt.init(self._block_of(n, p).contiguous())
            for n, p in self.params.items()}
        self._t = 0
        # each trained tensor's (lr_mult, wd_mult), read now, as the JAX
        # package reads them when its trainer is built
        self._mults = {n: (float(getattr(p, "_mx_lr_mult", 1.0)),
                           float(getattr(p, "_mx_wd_mult", 1.0)))
                       for n, p in self.params.items()}
        # the per-step scalars, written by the host before each step
        self._lr_buf = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self._t_buf = torch.zeros((), dtype=torch.int32, device=self.device)
        self._static_sig = (
            "spmd-train-step", _graphs.owner_token(block),
            f"{type(block).__module__}.{type(block).__qualname__}",
            tuple(n for n, _ in self._plist),
            tuple(sorted(self._mults.items())), type(optimizer),
            self._opt_static_fingerprint(),
            tuple(str(d) for d in self.mesh.devices), self._shards,
            self.remat, tuple(sorted(self._zero_dims.items())))

    def _ensure_blocks(self):
        """Cut every split parameter to this rank's block, where it holds
        the whole tensor (when the trainer is built, after
        ``sync_to_block``)."""
        with torch.no_grad():
            for n, spec in self._specs.items():
                p = self.params[n]
                if tuple(p.shape) == self._shapes[n]:
                    p.data = block_of(p.data, spec, self.mesh).clone()

    def _block_of(self, n, t):
        """This rank's ZeRO block of ``t``, the rank's block of trained
        parameter ``n`` or a state of it (a view): the whole of ``t``
        unless its state is split."""
        d = self._zero_dims.get(n)
        if d is None:
            return t
        free = self._free[n]
        k = t.shape[d] // self.mesh.size(free)
        return t.narrow(d, self.mesh.index(free) * k, k)

    def state_full(self, n) -> Tuple[torch.Tensor, ...]:
        """Parameter ``n``'s optimizer state as global tensors (the ranks'
        blocks gathered under ZeRO and for a split parameter; all ranks
        call it together)."""
        d = self._zero_dims.get(n)
        out = []
        for s in self.opt_state[n]:
            if d is not None:
                s = gather_dim(s, d, self._free[n], self.mesh)
            if n in self._specs:
                s = gather_blocks(s, self._specs[n], self.mesh)
            out.append(s)
        return tuple(out)

    def load_state_full(self, n, values) -> None:
        """Copy global state tensors into parameter ``n``'s state (this
        rank's block of each), in place."""
        spec = self._specs.get(n, P())
        with torch.no_grad():
            for s, v in zip(self.opt_state[n], values):
                s.copy_(self._block_of(n, block_of(v.to(s.device), spec,
                                                   self.mesh)))

    def value_full(self, t: torch.Tensor) -> torch.Tensor:
        """The global value of the block's parameter or buffer ``t``
        (gathered when it is split: a collective, every rank calls it)."""
        n = self._split_ids.get(id(t))
        if n is None:
            return t.detach()
        return gather_blocks(t.detach(), self._specs[n], self.mesh)

    def load_value_full(self, t: torch.Tensor, v: torch.Tensor) -> None:
        """Copy the global value ``v`` into ``t`` (its block when it is
        split), in place."""
        n = self._split_ids.get(id(t))
        if n is not None:
            v = block_of(v, self._specs[n], self.mesh)
        with torch.no_grad():
            t.copy_(v)

    def global_shape(self, t: torch.Tensor) -> Tuple[int, ...]:
        n = self._split_ids.get(id(t))
        return tuple(t.shape) if n is None else self._shapes[n]

    def _opt_static_fingerprint(self) -> Tuple:
        """The optimizer attributes the step reads as constants (wd,
        momentum, betas, ...); lr and rescale_grad are not among them."""
        skip = {"lr", "rescale_grad", "num_update", "begin_num_update"}
        return tuple(sorted(
            (k, v) for k, v in self._optimizer.__dict__.items()
            if k not in skip and isinstance(v, (int, float, bool, str))))

    def _state_keys(self) -> Tuple:
        """The address, dtype, shape and strides of every tensor the
        step reads or writes in place: parameters and buffers, optimizer
        state, the lr and t buffers."""
        key = _graphs.tensor_key
        return (param_keys(self.block),
                tuple(key(t) for n in self._trainable
                      for t in self.opt_state[n]),
                key(self._lr_buf), key(self._t_buf))

    def _rows_split(self, args, n_lab=None) -> bool:
        """Whether each rank takes its block of every argument's rows (of
        ``step``'s; of ``forward``'s with ``n_lab`` 0) rather than the
        whole arrays: only when the batch is split and every argument's
        spec splits its rows (``None`` does; ``sharding.input_split``).
        A whole argument's batch rows could not be told from its other
        dims, so a step that mixes the two places every argument whole
        and each rank runs the global batch as one device.  Every given
        spec is checked against the mesh and its argument's shape, as
        the JAX package's ``device_put`` checks it."""
        n_lab = self.n_labels if n_lab is None else n_lab
        n_in = len(args) - n_lab
        specs = list(self._batch_spec or [None] * n_in) + (
            list(self._label_spec or [None] * n_lab) if n_lab else [])
        if len(specs) != len(args):
            if self._world == 1:
                return False
            raise MXNetError(f"SPMDTrainer: {len(specs)} batch/label specs "
                             f"for {len(args)} arguments")
        rows = [s is None or input_split(s, self.mesh,
                                         getattr(x, "shape", None))
                for s, x in zip(specs, args)]
        return self._shards > 1 and all(rows)

    def _place(self, x, split=False):
        """``x`` on this rank's device: its rows of the global batch when
        ``split``, else the whole array."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        if split:
            t = shard_batch(t, self.mesh)
        return t.to(self.device)

    def _begin(self, args):
        """This rank's inputs and labels on the device; the step count
        and the lr and t buffers for this step."""
        self._split = self._rows_split(args)
        self._ensure_blocks()
        vals = tuple(self._place(x, self._split) for x in args)
        self._t += 1
        self._optimizer._update_count(0)
        self._lr_buf.fill_(float(self._optimizer.learning_rate))
        self._t_buf.fill_(self._t)
        return vals

    def step(self, *args) -> torch.Tensor:
        """One training step on a global batch; returns the mean loss over
        it as a fresh 0-d tensor on the device (it synchronises only when
        read).  On one device the step is captured once per signature
        and replayed (see the module docstring)."""
        vals = self._begin(args)
        if self._world > 1:
            _STEP_CACHE.note_eager()
            return self._body(*vals)
        if not _graphs.capture_enabled():
            return self._body(*vals)
        return self._get_step(vals, tuple((tuple(v.shape), v.dtype)
                                          for v in vals))

    def _step_eager(self, *args) -> torch.Tensor:
        """The same step run eagerly, outside the cache: the path a
        captured step is held against."""
        return self._body(*self._begin(args))

    def _get_step(self, vals, ikey):
        """Replay the step captured for this signature, or build it (the
        build runs this step); returns the loss."""
        slot = (ikey, _env.trace_knobs())
        sig = (self._static_sig, slot, self._state_keys())
        gens = (_random.generator(self.device),) \
            if self.device.type == "cuda" else ()
        return _STEP_CACHE.run(self, slot, sig, lambda: self._body, vals,
                               self.device, generators=gens)

    def graphs(self):
        """This trainer's live captured steps (``_graphs.Graphed``
        on the card)."""
        return _STEP_CACHE.entries(self)

    def _gathered(self, split):
        """The scope in which the modules hold every split parameter
        gathered (differentiably: see the module docstring)."""
        full = {}
        for n, spec in self._specs.items():
            p = self.params[n]
            used = {x for e in spec for x in _axes_of(e)}
            partial = tuple(a for a in self._batch_axes if a in used) \
                if split else ()
            full[id(p)] = gather(p, spec, self.mesh, partial)
        return _Swapped(self.block, full)

    def _body(self, *vals) -> torch.Tensor:
        """Forward, backward and update on this rank's inputs and labels;
        reads lr and t from their buffers."""
        n_lab = self.n_labels
        ivals, lvals = (vals, ()) if n_lab == 0 \
            else (vals[:-n_lab], vals[-n_lab:])
        self._fopt.begin_step()
        gen = _random.generator(self.device)
        # split: each rank holds its rows and sums over the batch ranks;
        # else each holds the whole batch and the step is one device's
        split = self._split
        mesh = self._solo if self._shards > 1 and not split else self.mesh
        weights = [self.params[n] for n in self._trainable]
        # the gathered tensors stay in the modules through the backward,
        # where remat's segments run their forwards again
        with self._gathered(split):
            with mesh, ActiveTrace(
                    train=True, generator=gen, mirror=self.remat):
                out = self.block(*ivals)
                outs = out if isinstance(out, (list, tuple)) else (out,)
                l = self.loss(outs[0], *lvals)
            lval = (l[0] if isinstance(l, (list, tuple)) else l).mean()
            if split:
                lval = lval / self._shards  # this rank's share of the mean
            grads = torch.autograd.grad(lval, weights)
        lval = lval.detach()
        zero = self._zero_dims
        if split:
            by_free: Dict[Tuple[str, ...], list] = {}
            for n, g in zip(self._trainable, grads):
                if n not in zero and self._free[n]:
                    by_free.setdefault(self._free[n], []).append(g)
            for free, gs in by_free.items():
                group = self.mesh.group(free)
                dist.flat_buckets(gs, lambda t, g=group: dist.all_reduce_(
                    t, g))
            dist.all_reduce_(lval, self.mesh.batch_group())
        with torch.no_grad():
            for n, w, g in zip(self._trainable, weights, grads):
                if n not in zero:
                    self._apply_one(n, w, g)
            if zero:
                self._zero_update([(n, g) for n, g in
                                   zip(self._trainable, grads)
                                   if n in zero], split)
        return lval

    def _zero_update(self, named_grads, reduce):
        """ZeRO-1 update of the tensors whose states are split: per group
        of free batch axes and dtype, one reduce-scatter of the gradients
        laid out rank-major (block r of every tensor, then block r+1;
        without ``reduce`` each rank already holds the whole gradient and
        takes its blocks), the update of this rank's block of each
        weight, one all-gather of the new blocks into the weights."""
        groups: Dict[Tuple, list] = {}
        for n, g in named_grads:
            groups.setdefault((self._free[n], g.dtype), []).append((n, g))
        for (free, _), group in groups.items():
            n_sh, r = self.mesh.size(free), self.mesh.index(free)
            pg = self.mesh.group(free)
            rows = [_rank_major(g, self._zero_dims[n], n_sh)
                    for n, g in group]
            if reduce:
                mine = dist.reduce_scatter(torch.cat(rows, 1).reshape(-1),
                                           pg)
            else:
                mine = torch.cat([m[r] for m in rows])
            blocks, off = [], 0
            for (n, g), m in zip(group, rows):
                d, w = self._zero_dims[n], self.params[n]
                wb = self._block_of(n, w)
                moved = (wb.shape[d],) + tuple(
                    s for i, s in enumerate(wb.shape) if i != d)
                gb = mine[off:off + m.shape[1]].view(moved).movedim(0, d)
                self._apply_one(n, wb, gb)
                blocks.append(wb.movedim(d, 0).reshape(-1))
                off += m.shape[1]
            local = torch.cat(blocks)
            full = torch.empty(n_sh * local.numel(), dtype=local.dtype,
                               device=local.device)
            full = dist.all_gather_(full, local, pg).view(n_sh, -1)
            off = 0
            for (n, g), m in zip(group, rows):
                _scatter_rank_major(self.params[n], full[:, off:off
                                                         + m.shape[1]],
                                    self._zero_dims[n])
                off += m.shape[1]

    def _apply_one(self, n, w, g):
        """Update one weight and its state in place, with its lr_mult and
        wd_mult; the fp32 master weight, when present, is what the
        update math runs on."""
        state = self.opt_state[n]
        lm, wm = self._mults[n]
        lr, t = self._lr_buf, self._t_buf
        if self._has_master[n]:
            nw32, ns = self._fopt.apply(state[-1], g, state[:-1], lr, t,
                                        lr_mult=lm, wd_mult=wm)
            ns = ns + (nw32,)
            w.copy_(nw32)
        else:
            nw, ns = self._fopt.apply(w, g, state, lr, t, lr_mult=lm,
                                      wd_mult=wm)
            w.copy_(nw)
        for s, v in zip(state, ns):
            s.copy_(v)

    def save_checkpoint(self, path: str):
        """Parameters, buffers, optimizer state and step count under the
        directory ``path`` (``parallel.checkpoint``); every rank calls it
        and the load may land on another dp size."""
        from .checkpoint import save_sharded

        save_sharded(path, self)

    def load_checkpoint(self, path: str):
        from .checkpoint import load_sharded

        load_sharded(path, self)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def sync_to_block(self):
        """Put the global value of every split parameter back into the
        block (a collective: every rank calls it), so that the block runs,
        and saves, on its own; the next step or forward cuts each back to
        this rank's block.  Without split parameters there is nothing to
        copy: the step updates the block's parameters in place."""
        with torch.no_grad():
            for n, spec in self._specs.items():
                p = self.params[n]
                if tuple(p.shape) != self._shapes[n]:
                    p.data = gather_blocks(p.data, spec, self.mesh)

    def forward(self, *inputs):
        """Inference with the trainer's current parameters (moving BN
        statistics): each rank runs its rows and the outputs come back
        gathered over the batch axes, in rank order, into the global
        batch (the JAX trainer's output), the same on every rank."""
        split = self._rows_split(inputs, 0)
        self._ensure_blocks()
        ivals = tuple(self._place(x, split) for x in inputs)
        mesh = self._solo if self._shards > 1 and not split else self.mesh
        with torch.no_grad(), self._gathered(False), mesh, \
                ActiveTrace(train=False):
            out = self.block(*ivals)
        if not split:
            return out
        spec = P(self._batch_axes)

        def whole(o):
            if isinstance(o, torch.Tensor):
                return gather_blocks(o, spec, self.mesh)
            if isinstance(o, (list, tuple)):
                return type(o)(whole(x) for x in o)
            return o
        return whole(out)
