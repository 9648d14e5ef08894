"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``:

  * Children and parameters are registered by attribute name, so
    ``state_dict()`` keys are the structural names that
    ``_collect_params_with_prefix`` gives in the JAX package
    (``features.4.0.body.0.weight``); ``save_parameters`` and
    ``load_parameters`` key on them, and a file written by the JAX
    package's ``save_parameters`` loads here.  BatchNorm running
    statistics are buffers.
  * ``hybridize()`` has no program to compile — PyTorch runs eagerly.
    It switches on a trace scope (:class:`ActiveTrace`, read through
    :func:`current_trace`) around the forward, with the same ``train``
    flag, so that code gated on a trace (the fused ResNet path) behaves
    as in the JAX package.  ``train`` is ``module.training``.
  * ``collect_params()`` is keyed on the structural names (the JAX
    package keys its ParameterDict on name-scope names).
  * Parameter shapes are known at construction: deferred shape
    inference (``in_channels=0``) is not ported.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import context as _context
from .. import initializer as init_mod
from .. import ops as _ops
from ..base import MXNetError

__all__ = ["Block", "HybridBlock", "ActiveTrace", "current_trace",
           "load_numpy_params", "dtype_of"]


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def dtype_of(dtype) -> torch.dtype:
    """'bfloat16' (a name) or a torch.dtype -> torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


# ---------------------------------------------------------------------------
# trace scope — active while a hybridized block runs its forward
# ---------------------------------------------------------------------------

class _TraceState(threading.local):
    def __init__(self):
        self.scope: Optional["ActiveTrace"] = None


_TRACE = _TraceState()


class ActiveTrace:
    """The scope a hybridized forward runs in (thread-local)."""

    def __init__(self, train: bool):
        self.train = train

    def __enter__(self):
        self._old = _TRACE.scope
        _TRACE.scope = self
        return self

    def __exit__(self, *exc):
        _TRACE.scope = self._old
        return False


def current_trace() -> Optional[ActiveTrace]:
    return _TRACE.scope


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """Base container.  ``prefix``/``params`` are accepted so that zoo code
    reads as in the JAX package; names are structural and ignore them."""

    def __init__(self, prefix: Optional[str] = None, params=None):
        super().__init__()
        # local parameter/buffer name -> its initializer (None = default)
        self._inits: Dict[str, object] = {}

    def _param(self, name, shape, init=None, dtype="float32"):
        """Register a parameter of known shape, filled at initialize()."""
        if any(int(s) <= 0 for s in shape):
            raise MXNetError(
                f"{type(self).__name__}.{name}: unknown shape {tuple(shape)} "
                "— deferred shape inference is not ported; pass "
                "in_channels/in_units")
        p = nn.Parameter(torch.zeros(tuple(int(s) for s in shape),
                                     dtype=dtype_of(dtype)))
        self.register_parameter(name, p)
        self._inits[name] = init
        return p

    def _buffer(self, name, shape, init=None):
        self.register_buffer(name, torch.zeros(tuple(int(s) for s in shape)))
        self._inits[name] = init

    def collect_params(self) -> "OrderedDict[str, torch.Tensor]":
        """Parameters and buffers by structural name."""
        return OrderedDict(self.state_dict(keep_vars=True))

    def initialize(self, init=None, ctx=None, seed: int = 0):
        """Fill every parameter and buffer, then move the block to ``ctx``
        (default: gpu(0); raises when there is none — pass cpu()).

        A parameter's own initializer (e.g. a bias's "zeros") fills it
        unconditionally; the others take ``init`` (default Uniform(0.07))
        by name.  Draws come from a CPU ``torch.Generator`` seeded with
        ``seed``."""
        dev = _context.resolve(ctx)
        gen = torch.Generator().manual_seed(int(seed))
        default = init_mod.create(init)
        with torch.no_grad():
            for mname, mod in self.named_modules():
                inits = getattr(mod, "_inits", {})
                for local, spec in inits.items():
                    t = getattr(mod, local)
                    full = f"{mname}.{local}" if mname else local
                    buf = torch.zeros(t.shape, dtype=torch.float32)
                    if spec is not None:
                        init_mod.create(spec).init_array(full, buf, gen)
                    else:
                        default(full, buf, gen)
                    t.data = buf.to(dtype=t.dtype)
        self.to(dev)
        return self

    def hybridize(self, active: bool = True):
        for c in self.children():
            if isinstance(c, Block):
                c.hybridize(active)
        return self

    def cast(self, dtype):
        """Cast parameters (and non-statistics buffers) to ``dtype``."""
        dt = dtype_of(dtype)
        for c in self.children():
            if isinstance(c, Block):
                c.cast(dtype)
        for name in self._inits:
            t = getattr(self, name)
            t.data = t.data.to(dt)
        return self

    def save_parameters(self, filename: str) -> None:
        from ..serialization import save_ndarrays

        save_ndarrays(filename, {k: v.detach().cpu()
                                 for k, v in self.collect_params().items()})

    def load_parameters(self, filename: str) -> None:
        """Load a ``.params`` file keyed on structural names (one written
        by the JAX package's ``save_parameters`` included)."""
        from ..serialization import load_ndarrays

        loaded = load_ndarrays(filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename}: parameters must be named")
        _load_tensors(self, loaded, what=filename)


def _to_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: same bits
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _load_tensors(block, values, what="dict"):
    """Every name, present and of the right shape, or raise before any
    parameter changes; each value keeps its dtype and moves to the
    parameter's device."""
    params = block.collect_params()
    missing = [k for k in params if k not in values]
    extra = [k for k in values if k not in params]
    if missing:
        raise MXNetError(f"parameters missing in {what}: {missing[:5]}")
    if extra:
        raise MXNetError(f"parameters in {what} do not exist in this "
                         f"block: {extra[:5]}")
    tensors = {k: _to_tensor(v) for k, v in values.items()}
    for name, t in params.items():
        if tuple(tensors[name].shape) != tuple(t.shape):
            raise MXNetError(f"parameter {name}: shape "
                             f"{tuple(tensors[name].shape)} != "
                             f"{tuple(t.shape)}")
    with torch.no_grad():
        for name, t in params.items():
            t.data = tensors[name].to(device=t.device)


def load_numpy_params(block: Block, values: Dict[str, np.ndarray]) -> None:
    """Load ``{structural name: array}`` (numpy, ml_dtypes.bfloat16
    included, or tensors) into ``block``, keeping each array's dtype.
    Raises on a missing, extra or mis-shaped name."""
    _load_tensors(block, values)


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------

class HybridBlock(Block):
    """``hybrid_forward(F, x, *args)`` with F the ops namespace."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False

    def hybridize(self, active: bool = True):
        self._active = bool(active)
        return super().hybridize(active)

    def forward(self, x, *args):
        if self._active and current_trace() is None:
            with ActiveTrace(train=self.training):
                return self.hybrid_forward(_ops, x, *args)
        return self.hybrid_forward(_ops, x, *args)

    def hybrid_forward(self, F, x, *args):
        raise NotImplementedError
