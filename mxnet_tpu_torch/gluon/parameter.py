"""Gluon Parameter / ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A :class:`Parameter` is a handle on one tensor of a block: a registered
``nn.Parameter``, or a buffer (BatchNorm's running statistics, always
``grad_req='null'``).  The handle holds no state of its own: the tensor
is looked up on its module at each access (``Block.to`` replaces
buffers), and ``grad_req``, ``lr_mult``, ``wd_mult`` and the gradient
buffer live on the parameter tensor, so two ``collect_params()`` calls,
or a parent's and a child's, see the same values.  A parameter lives on
one device: ``list_ctx()`` has one entry, and several contexts raise
(replicas are ROADMAP queue A item 7).  Shapes are known at
construction: deferred initialization is not ported.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError, dtype_of, np_dtype
from ..context import resolve

__all__ = ["Parameter", "ParameterDict"]


class Parameter:
    """``name`` is the structural name (``0.weight``,
    ``features.1.running_mean``)."""

    def __init__(self, name: str, module, local: str):
        self.name = name
        self._module = module
        self._local = local

    # ---- the tensor --------------------------------------------------------
    @property
    def _tensor(self) -> torch.Tensor:
        return getattr(self._module, self._local)

    @property
    def _is_buffer(self) -> bool:
        return self._local in self._module._buffers

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def dtype(self):
        return np_dtype(self._tensor.dtype)

    # ---- training attributes -----------------------------------------------
    @property
    def grad_req(self) -> str:
        return "null" if self._is_buffer else autograd.grad_req_of(
            self._tensor)

    @grad_req.setter
    def grad_req(self, req):
        if self._is_buffer:
            if req != "null":
                raise MXNetError(f"{self.name} is a buffer (running "
                                 "statistics): its grad_req stays 'null'")
            return
        autograd.set_grad_req(self._tensor, req)

    def _attr(self, name):
        return 1.0 if self._is_buffer else getattr(self._tensor, name, 1.0)

    def _set_attr(self, name, value):
        if not self._is_buffer:
            setattr(self._tensor, name, float(value))

    lr_mult = property(lambda self: self._attr("_mx_lr_mult"),
                       lambda self, v: self._set_attr("_mx_lr_mult", v))
    wd_mult = property(lambda self: self._attr("_mx_wd_mult"),
                       lambda self, v: self._set_attr("_mx_wd_mult", v))

    # ---- access -------------------------------------------------------------
    def _check_ctx(self, ctx):
        t = self._tensor
        if ctx is not None and resolve(ctx) != t.device:
            raise MXNetError(f"Parameter {self.name} was not initialized on "
                             f"context {ctx}; it lives on {t.device}")
        return t

    def data(self, ctx=None):
        """The value as an NDArray sharing the tensor: a write into it
        writes the parameter, and under ``autograd.record()`` the
        parameter's gradient flows to :meth:`grad`."""
        from ..ndarray.ndarray import NDArray

        t = self._check_ctx(ctx)
        nd = NDArray(t)
        if self.grad_req != "null":
            nd._ag_leaf = t
        return nd

    def grad(self, ctx=None):
        from ..ndarray.ndarray import NDArray

        t = self._check_ctx(ctx)
        if self.grad_req == "null":
            raise MXNetError(f"Parameter {self.name} has grad_req='null'")
        return NDArray(autograd.grad_buffer(t))

    def list_data(self) -> List:
        return [self.data()]

    def list_grad(self) -> List:
        return [self.grad()]

    def list_ctx(self) -> List[torch.device]:
        return [self._tensor.device]

    def zero_grad(self):
        if self.grad_req != "null":
            autograd.grad_buffer(self._tensor).zero_()

    def set_data(self, data):
        """Write ``data`` (an NDArray, tensor or array) into the
        parameter, cast to its dtype, on its device."""
        from ..ndarray.ndarray import NDArray

        t = self._tensor
        v = data._data if isinstance(data, NDArray) else data
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        if tuple(v.shape) != tuple(t.shape):
            raise MXNetError(f"cannot change the shape of Parameter "
                             f"{self.name} from {tuple(t.shape)} to "
                             f"{tuple(v.shape)}")
        with torch.no_grad():
            t.copy_(v.to(device=t.device, dtype=t.dtype))

    def cast(self, dtype):
        dt = dtype_of(dtype)
        t = self._tensor
        if self._is_buffer:
            self._module._buffers[self._local] = t.to(dt)
        else:
            t.data = t.data.to(dt)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False, generator=None):
        """Fill the tensor by its block's own initializer (a bias's
        "zeros"), else ``init``, else ``default_init`` (Uniform(0.07))
        by the name rule, then move it to ``ctx`` (default gpu(0); raises
        without CUDA unless cpu() is given).  A parameter that its block
        or an earlier call initialized keeps its value unless
        ``force_reinit``."""
        dev = resolve(ctx)
        mod = self._module
        done = getattr(mod, "_mx_initialized", set())
        if self._local in done and not force_reinit:
            return
        spec = getattr(mod, "_inits", {}).get(self._local)
        t = self._tensor
        buf = torch.zeros(t.shape, dtype=torch.float32)
        gen = generator or torch.Generator().manual_seed(0)
        if spec is not None:
            init_mod.create(spec).init_array(self.name, buf, gen)
        elif init is not None:
            init_mod.create(init).init_array(self.name, buf, gen)
        else:
            init_mod.create(default_init)(self.name, buf, gen)
        value = buf.to(device=dev, dtype=t.dtype)
        with torch.no_grad():
            if self._is_buffer:
                mod._buffers[self._local] = value
            else:
                t.data = value
        mod._mx_initialized = done | {self._local}

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


def _unique(params) -> List[Parameter]:
    """One handle per tensor (a tied parameter is listed under several
    names; its first name wins)."""
    seen, out = set(), []
    for p in params:
        k = id(p._tensor)
        if k not in seen:
            seen.add(k)
            out.append(p)
    return out


class ParameterDict:
    """Ordered structural name -> :class:`Parameter`."""

    def __init__(self, params: Optional[Dict[str, Parameter]] = None):
        self._params: "OrderedDict[str, Parameter]" = OrderedDict(
            params or {})

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit: bool = False, seed: int = 0):
        """Initialize every parameter (see :meth:`Parameter.initialize`),
        drawing in this dict's order from one CPU generator seeded with
        ``seed``."""
        gen = torch.Generator().manual_seed(int(seed))
        for p in _unique(self._params.values()):
            p.initialize(None, ctx, default_init=init,
                         force_reinit=force_reinit, generator=gen)

    def zero_grad(self):
        for p in _unique(self._params.values()):
            p.zero_grad()

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, fname: str, strip_prefix: str = ""):
        from ..serialization import save_ndarrays

        out = {}
        for name, p in self._params.items():
            key = name[len(strip_prefix):] if name.startswith(strip_prefix) \
                else name
            out[key] = p._tensor.detach().cpu()
        save_ndarrays(fname, out)

    def load(self, fname: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = ""):
        from ..serialization import load_ndarrays

        loaded = load_ndarrays(fname)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{fname}: parameters must be named")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self._params:
                if name not in loaded:
                    raise MXNetError(f"Parameter {name} missing in file "
                                     f"{fname}")
        for name, value in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError(f"Parameter {name} in file is not in this "
                                 "dict")
            self._params[name].set_data(value)

    # mapping protocol
    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        lines = "\n".join(f"  {p}" for p in self._params.values())
        return f"ParameterDict (\n{lines}\n)"
