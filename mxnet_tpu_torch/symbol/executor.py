"""GraphExecutor: a bound symbol run as one captured step (counterpart of
``mxnet_tpu/symbol/executor.py``).

The JAX package compiles the bound graph once per (train flag, shapes):
the forward, and in training the forward and the backward with ones
cotangents as one program (``_get_train_step``).  The port runs the same
walk of the graph on the executor's own tensors, and on the card
captures it as a CUDA graph once per signature through
``_graphs.ExecutableCache`` and replays it (``_graphs.no_capture()``
runs it eagerly, with the same bits):

  * ``forward(is_train=False)`` runs the graph without autograd;
  * ``forward(is_train=True)`` runs it with the train flag (BatchNorm's
    batch statistics, Dropout), computes the gradients of the arguments
    whose ``grad_req`` is not ``null`` with ones cotangents, and writes
    BatchNorm's new moving statistics into the aux states in place,
    all inside the one step; ``backward()`` then writes (``write``) or
    adds (``add``) those gradients into the gradient arrays in place;
  * ``backward(out_grads)`` recomputes the forward eagerly with the
    generator's state of the last forward (the JAX package's
    ``_last_key``) and the aux states as they are now, and takes the
    gradients for those cotangents.

A captured step reads the argument and aux tensors in place, so the
signature holds every one's address (``_graphs.tensor_key``): inputs
given to ``forward`` and parameters given to ``copy_params_from`` are
copied into the tensors already bound when shape and dtype agree, and an
array rebound to other storage makes a new step instead of replaying
onto the old one.  The ops get the JAX package's attributes from the
graph, and the train flag and the device's generator as the port's ops
take them (``train=``, ``generator=``).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import _graphs
from .. import random as _random
from ..base import MXNetError
from ..context import resolve
from ..ndarray.ndarray import NDArray, array, zeros
from ..ops.registry import get_op
from ..util import env as _env
from .symbol import KEYED_OPS, TRAIN_AWARE_OPS, Symbol, op_attrs

__all__ = ["GraphExecutor", "executor_stats"]

_EXEC_CACHE = _graphs.ExecutableCache("symbol.executor", per_owner_max=8)


def executor_stats():
    """Executor steps built in this process (the shape of
    ``optimizer.fused.compile_stats``)."""
    return _EXEC_CACHE.stats()


class GraphExecutor:
    def __init__(self, symbol: Symbol, ctx, args, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._ctx = resolve(ctx)
        self._heads = symbol._heads
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        # the walk: each node with its op and attributes, resolved now so
        # an op the port does not register fails at bind
        self._plan = [(n, None if n.op is None else get_op(n.op),
                       op_attrs(n)) for n in symbol._topo()]
        self._keyed = any(n.op in KEYED_OPS for n, _, _ in self._plan)
        self.arg_arrays = self._as_list(args, self.arg_names, "args")
        self.aux_arrays = self._as_list(aux_states, self.aux_names,
                                        "aux_states", allow_none=True)
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self.arg_names}
        if args_grad is None:
            self.grad_arrays = [
                NDArray(torch.zeros_like(a._data))
                if self._grad_req[n] != "null" else None
                for n, a in zip(self.arg_names, self.arg_arrays)]
        else:
            self.grad_arrays = self._as_list(args_grad, self.arg_names,
                                             "args_grad", allow_none=True,
                                             pad=True)
        self._diff_idx = [i for i, n in enumerate(self.arg_names)
                          if self._grad_req[n] != "null"]
        self.outputs: List[NDArray] = []
        self._pending = None
        self._rng_state = None

    # ---- construction helpers --------------------------------------------
    def _as_list(self, vals, names, what, allow_none=False, pad=False):
        if vals is None:
            if allow_none and what == "aux_states" and names:
                return [zeros(s, ctx=self._ctx) for s in self._aux_shapes()]
            if allow_none:
                return [None] * len(names)
            raise MXNetError(f"{what} must be provided")
        if isinstance(vals, dict):
            out = []
            for n in names:
                v = vals.get(n)
                if v is None and not (allow_none or pad):
                    raise MXNetError(f"{what} missing entry for '{n}'")
                out.append(self._to_ctx(v))
            return out
        if len(vals) != len(names):
            raise MXNetError(f"{what}: expected {len(names)} entries "
                             f"({names}), got {len(vals)}")
        return [self._to_ctx(v) for v in vals]

    def _to_ctx(self, v):
        if v is None:
            return None
        if not isinstance(v, NDArray):
            return array(v, ctx=self._ctx)
        return v.as_in_context(self._ctx)

    def _aux_shapes(self):
        shapes = {n: a.shape for n, a in zip(self.arg_names, self.arg_arrays)}
        _, _, aux = self._symbol.infer_shape_partial(**shapes)
        for n, s in zip(self.aux_names, aux):
            if s is None:
                raise MXNetError(f"cannot infer shape of aux state '{n}'")
        return aux

    def _assign(self, arr: NDArray, v):
        """Write ``v`` into ``arr``'s tensor when shape and dtype agree
        (a captured step keeps reading it), else rebind ``arr``."""
        src = v._data if isinstance(v, NDArray) else None
        if src is None:
            src = array(v, ctx=self._ctx)._data
        if src.shape == arr._data.shape and src.dtype == arr._data.dtype:
            with torch.no_grad():
                arr._data.copy_(src)
        else:
            arr._data = src.to(self._ctx, copy=src.device == self._ctx)

    # ---- dicts -----------------------------------------------------------
    @property
    def arg_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self.arg_names, self.arg_arrays))

    @property
    def grad_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self.arg_names, self.grad_arrays))

    @property
    def aux_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self.aux_names, self.aux_arrays))

    @property
    def output_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for params, table, what in ((arg_params, self.arg_dict, "argument"),
                                    (aux_params, self.aux_dict,
                                     "aux state")):
            for n, v in (params or {}).items():
                if n in table:
                    self._assign(table[n], v)
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} '{n}'")

    # ---- the graph on tensors --------------------------------------------
    def _graph(self, args, auxs, train: bool, gen):
        """Walk the graph on tensors: (head tensors, {aux name: new
        value} from BatchNorm in training)."""
        vals = dict(zip(self.arg_names, args))
        vals.update(zip(self.aux_names, auxs))
        env = {}
        new_aux = {}
        for node, op, attrs in self._plan:
            if op is None:
                env[(id(node), 0)] = vals[node.name]
                continue
            ins = [env[(id(i), ix)] for i, ix in node.inputs]
            kw = dict(attrs)
            if node.op in TRAIN_AWARE_OPS:
                kw["train"] = train
            elif node.op == "Custom":
                kw["_train"] = train
            if node.op in KEYED_OPS:
                kw["generator"] = gen
            out = op.fn(*ins, **kw)
            if node.op == "BatchNorm" and isinstance(out, tuple) \
                    and node.num_outputs == 1:
                out, new_aux[node.inputs[3][0].name], \
                    new_aux[node.inputs[4][0].name] = out
            outs = out if isinstance(out, (tuple, list)) else [out]
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
        return [env[(id(n), i)] for n, i in self._heads], new_aux

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for n, a in zip(self.aux_names, self.aux_arrays):
                if n in new_aux:
                    a._data.copy_(new_aux[n])

    def _grads(self, args, auxs, gen, cts=None, write_aux=False):
        """Heads and the gradients of the differentiable arguments for
        the cotangents ``cts`` (ones when None), in training mode."""
        with torch.enable_grad():
            leaves = list(args)
            want = []
            for j in self._diff_idx:
                if leaves[j].is_floating_point():
                    leaves[j] = leaves[j].detach().requires_grad_()
                    want.append(j)
            heads, new_aux = self._graph(leaves, auxs, True, gen)
            if cts is None:
                cts = [torch.ones_like(h) for h in heads]
            pairs = [(h, c) for h, c in zip(heads, cts) if h.requires_grad]
            got = torch.autograd.grad(
                [h for h, _ in pairs], [leaves[j] for j in want],
                [c for _, c in pairs], allow_unused=True) \
                if pairs and want else [None] * len(want)
        by_idx = dict(zip(want, got))
        grads = [by_idx.get(j) if by_idx.get(j) is not None
                 else torch.zeros_like(args[j]) for j in self._diff_idx]
        if write_aux:
            self._write_aux(new_aux)
        return [h.detach() for h in heads], grads

    def _make_step(self, train: bool, with_grads: bool, gen):
        def make_fn():
            def step():
                args = [a._data for a in self.arg_arrays]
                auxs = [a._data for a in self.aux_arrays]
                if with_grads:
                    return self._grads(args, auxs, gen, write_aux=True)
                with torch.no_grad():
                    heads, new_aux = self._graph(args, auxs, train, gen)
                    if train:
                        self._write_aux(new_aux)
                return heads, []
            return step
        return make_fn

    def _run(self, train: bool, with_grads: bool):
        """One forward (and with ``with_grads`` the gradients), captured
        on the card once per signature."""
        gen = _random.generator(self._ctx) if self._keyed else None
        make_fn = self._make_step(train, with_grads, gen)
        if not _graphs.capture_enabled():
            return make_fn()()
        slot = (train, with_grads, _env.trace_knobs())
        sig = (slot, tuple(_graphs.tensor_key(a._data)
                           for a in self.arg_arrays + self.aux_arrays))
        gens = (gen,) if gen is not None and gen.device.type == "cuda" \
            else ()
        return _EXEC_CACHE.run(self, slot, sig, make_fn, [], self._ctx,
                               generators=gens)

    def graphs(self):
        """The captured steps of this executor (``Graphed`` entries on the
        card; CPU markers otherwise)."""
        return _EXEC_CACHE.entries(self)

    # ---- public API ------------------------------------------------------
    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        for k, v in kwargs.items():
            if k not in self.arg_names:
                raise MXNetError(f"unknown argument '{k}' in forward")
            self._assign(self.arg_arrays[self.arg_names.index(k)], v)
        self._pending = None
        self._rng_state = _random.generator(self._ctx).get_state() \
            if self._keyed and is_train else None
        heads, grads = self._run(bool(is_train),
                                 bool(is_train and self._diff_idx))
        if is_train and self._diff_idx:
            self._pending = grads
        self.outputs = [NDArray(h) for h in heads]
        return self.outputs

    def backward(self, out_grads=None):
        """Write (``write``) or add (``add``) the gradients into the
        gradient arrays: those of the last ``forward(is_train=True)``, or
        with ``out_grads`` those of a recomputed forward for these
        cotangents."""
        if not self._diff_idx:
            return
        if out_grads is None:
            if self._pending is None:
                raise MXNetError("backward() requires a prior "
                                 "forward(is_train=True)")
            grads = self._pending
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cts = [self._to_ctx(g)._data for g in out_grads]
            grads = self._recompute(cts)
        with torch.no_grad():
            for g, j in zip(grads, self._diff_idx):
                garr = self.grad_arrays[j]
                if garr is None:
                    continue
                if garr._data.shape != g.shape:  # the argument was rebound
                    garr._data = torch.zeros_like(g)
                elif garr._data.dtype != g.dtype:
                    garr._data = garr._data.to(g.dtype)
                if self._grad_req[self.arg_names[j]] == "add":
                    garr._data.add_(g)
                else:
                    garr._data.copy_(g)

    def _recompute(self, cts):
        gen = _random.generator(self._ctx) if self._keyed else None
        saved = None
        if gen is not None and self._rng_state is not None:
            saved = gen.get_state()
            gen.set_state(self._rng_state)
        try:
            _, grads = self._grads([a._data for a in self.arg_arrays],
                                   [a._data for a in self.aux_arrays],
                                   gen, cts=cts)
        finally:
            if saved is not None:
                gen.set_state(saved)
        return grads

    # ---- simple_bind -----------------------------------------------------
    @staticmethod
    def simple_bind(symbol: Symbol, ctx, grad_req="write",
                    **shape_kwargs) -> "GraphExecutor":
        """Bind zeros of the shapes ``infer_shape`` gives (fp32)."""
        dev = resolve(ctx)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        return GraphExecutor(symbol, dev,
                             [zeros(s, ctx=dev) for s in arg_shapes],
                             grad_req=grad_req,
                             aux_states=[zeros(s, ctx=dev)
                                         for s in aux_shapes])
