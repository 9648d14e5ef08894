"""``gluon.Trainer``'s fused update: one CUDA graph over every parameter,
per signature (counterpart of ``mxnet_tpu/optimizer/fused.py``).

:class:`FusedUpdater` (``gluon.Trainer``'s default update) applies each
optimizer's ``fused_apply`` — the update ops of ``ops/optimizer_ops.py``,
as the eager per-parameter path runs them — over every parameter in one
captured step per signature, through the port's graph cache
(``mxnet_tpu_torch._graphs``).  The per-step scalars (lr with its mult
and Adam's bias correction folded in, wd with its mult, rescale_grad) are
one (n, 3) input written before each replay (fp32; float64 when a
weight is float64, so the scalars keep the eager path's Python floats
there too), so
``set_learning_rate`` and a new batch size never capture again; the
statics (momentum, betas, epsilon, clip_gradient) are in the signature.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .._graphs import ExecutableCache, capture_enabled, tensor_key
from .optimizer import Optimizer, Updater

__all__ = ["FusedUpdater", "FusedUnsupported", "apply_param",
           "compile_stats"]


class FusedUnsupported(Exception):
    """This parameter set cannot take the fused path exactly (raised
    before any state changes): the caller runs the eager loop."""


_FUSED_CACHE = ExecutableCache("optimizer.fused_step")


def compile_stats() -> Dict[str, float]:
    """How many fused-update entries were built in this process, and the
    seconds spent building them (the JAX package's keys, with the
    port's; see :meth:`ExecutableCache.stats`)."""
    return _FUSED_CACHE.stats()


def _state_data(s):
    """NDArray state tree -> tensor tree (same structure)."""
    if s is None:
        return None
    if isinstance(s, (tuple, list)):
        return tuple(_state_data(x) for x in s)
    return s._data


def _write_state(old, new) -> None:
    """Write the new state tensors into the state's tensors, in place."""
    if old is None:
        return
    if isinstance(old, torch.Tensor):
        old.copy_(new)
        return
    for o, n in zip(old, new):
        _write_state(o, n)


def _state_keys(s):
    if s is None:
        return ()
    if isinstance(s, torch.Tensor):
        return (tensor_key(s),)
    return tuple(k for x in s for k in _state_keys(x))


def apply_param(opt: Optimizer, w, g, s, mp: bool, h: Dict[str, Any]):
    """One parameter's update on tensors (the math the captured step
    runs; the JAX package's ``apply_param``).  ``h`` maps hyper keys to
    0-d fp32 (float64 over float64 weights) tensors.  Under mp the fp32
    master weight, the last state element, is what the math runs on, and
    the new weight is the new master (the caller's write casts it).  Without it the scalars keep
    fp32: the update ops round them as the eager path's floats."""
    if mp:
        inner, w32 = s
        nw32, ninner = opt.fused_apply(w32, g.to(torch.float32), inner, h)
        return nw32, (ninner, nw32)
    return opt.fused_apply(w, g, s, h)


class FusedUpdater(Updater):
    """Updater whose batch entry point (:meth:`update_all`) runs the
    whole parameter list as one captured step; the inherited
    per-parameter ``__call__`` is the eager path."""

    def update_all(self, indices: List[int], grads: List,
                   weights: List) -> None:
        """One optimizer step over every (index, grad, weight) triple of
        one device.  Raises :class:`FusedUnsupported`, after creating the
        states the eager path would create and before changing any, when
        the set must take the eager loop (the JAX package's rule: an
        optimizer whose fused step carries the step count t, on half
        weights without a master copy)."""
        opt = self.optimizer
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = opt.create_state_multi_precision(i, w)
        states = [self.states[i] for i in indices]
        mp_flags = tuple(opt._mp_active(w, s)
                         for w, s in zip(weights, states))
        if opt._FUSED_T_HYPER and any(
                not mp and w._data.dtype in (torch.float16, torch.bfloat16)
                for w, mp in zip(weights, mp_flags)):
            raise FusedUnsupported(
                f"{type(opt).__name__}: half-precision weights without "
                "multi_precision need the eager loop (the fused step "
                "carries t in the weight's dtype)")
        hypers = []
        for i in indices:
            opt._update_count(i)
            hypers.append(opt.fused_hyper(i, opt._index_update_count[i]))
        names = tuple(hypers[0]) if hypers else ()
        ws = [w._data for w in weights]
        gs = [g._data for g in grads]
        ss = [_state_data(s) for s in states]
        dev = ws[0].device
        hdt = torch.float64 if any(w.dtype == torch.float64 for w in ws) \
            else torch.float32
        host = torch.tensor([[h[k] for k in names] for h in hypers],
                            dtype=hdt)
        if dev.type == "cuda":
            host = host.pin_memory()
        slot = (type(opt), opt.fused_static_key(), mp_flags, str(dev),
                tuple(indices), names, hdt)
        sig = (slot, tuple(tensor_key(t) for t in ws),
               tuple(tensor_key(t) for t in gs),
               tuple(_state_keys(s) for s in ss))
        if not capture_enabled():
            # the scalars on the device, as the captured step reads them
            # (a CPU scalar divides through its reciprocal on the card)
            self._make_fn(opt, ws, gs, ss, mp_flags, names)(host.to(dev))
            return
        _FUSED_CACHE.run(self, slot, sig, lambda: self._make_fn(
            opt, ws, gs, ss, mp_flags, names), [host], dev)

    @staticmethod
    def _make_fn(opt, ws, gs, ss, mp_flags, names):
        def step(hyper):
            with torch.no_grad():
                for i, (w, g, s, mp) in enumerate(zip(ws, gs, ss,
                                                      mp_flags)):
                    h = {k: hyper[i, j] for j, k in enumerate(names)}
                    nw, ns = apply_param(opt, w, g, s, mp, h)
                    w.copy_(nw)
                    _write_state(s, ns)
        return step
