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
(replicas are ROADMAP queue A item 7).  ``Parameter(name, shape=...)``
made on its own (as in the JAX package) is a handle on a tensor of a
holder module of its own.

Deferred shapes, as in the JAX package: a zero in a shape means
"unknown".  The tensor is then a zero-element placeholder of that shape
(``(128, 0)`` for ``Dense(128)``); ``initialize`` records the
initializer instead of filling it (``allow_deferred_init``; without it,
an unknown shape raises), and the first forward sets the shape
(``_infer_param_shapes``) and fills it (:func:`finish_deferred`).  The
placeholder is resolved in place (``tensor.data = ...``), so what was
made before the first forward — a ``gluon.Trainer``, a
``collect_params()`` dict, a tied second name — sees the real tensor.
Until then ``data()`` raises :class:`DeferredInitializationError`.  The
deferred state lives on the owning module (buffers are replaced by
``Block.to``), in ``_mx_deferred`` (local name -> (initializer, default,
generator)) and ``_mx_shape`` (local name -> the shape set, not yet
materialized).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError, dtype_of, np_dtype
from ..context import resolve

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """``data()`` of a parameter whose shape is not known yet (the JAX
    package's name)."""


# ---------------------------------------------------------------------------
# the deferred state of one (module, local name)
# ---------------------------------------------------------------------------

def unknown(shape) -> bool:
    return any(int(s) <= 0 for s in shape)


def _state(mod, attr):
    d = mod.__dict__.get(attr)
    if d is None:
        d = mod.__dict__[attr] = {}
    return d


def tensor_of(mod, local):
    """The tensor registered on ``mod`` as parameter or buffer ``local``
    (a block's attribute of that name is its Gluon ``Parameter``)."""
    if local in mod._parameters:
        return mod._parameters[local]
    if local in mod._buffers:
        return mod._buffers[local]
    return mod.__dict__.get(local)  # set to None (a layer without bias)


def handle(mod, local, name=None) -> "Parameter":
    """The one ``Parameter`` of ``mod``'s parameter or buffer ``local``
    that its attribute and ``params.get`` give (made on first use, named
    ``name`` or ``local``)."""
    cache = mod.__dict__.setdefault("_mx_handles", {})
    h = cache.get(local)
    if h is None:
        h = cache[local] = Parameter._handle(name or local, mod, local)
    return h


def declared_shape(mod, local) -> tuple:
    """The shape set by ``_infer_param_shapes`` (not materialized yet),
    else the tensor's."""
    s = mod.__dict__.get("_mx_shape", {}).get(local)
    return s if s is not None else tuple(tensor_of(mod, local).shape)


def set_shape(mod, local, new_shape, name=None) -> None:
    """Set a parameter's shape: only its unknown (zero) dims may change,
    as in the JAX package's ``Parameter.shape`` setter."""
    new_shape = (int(new_shape),) if isinstance(new_shape, int) \
        else tuple(int(s) for s in new_shape)
    cur = declared_shape(mod, local)
    if cur == new_shape:
        return
    ok = len(cur) == len(new_shape) and all(
        a == 0 or a == b for a, b in zip(cur, new_shape))
    if not ok:
        raise MXNetError(f"cannot change shape of Parameter "
                         f"{name or local} from {cur} to {new_shape}")
    _state(mod, "_mx_shape")[local] = new_shape


def is_deferred(mod, local) -> bool:
    return local in mod.__dict__.get("_mx_deferred", {})


def fill(name, shape, spec, default, gen) -> torch.Tensor:
    """An fp32 CPU tensor of ``shape`` filled by the parameter's own
    initializer ``spec``, else ``default`` by the name rule."""
    buf = torch.zeros(shape, dtype=torch.float32)
    if spec is not None:
        init_mod.create(spec).init_array(name, buf, gen)
    else:
        init_mod.create(default)(name, buf, gen)
    return buf


def initialize_one(mod, local, name, default, gen, dev=None,
                   spec=None) -> None:
    """Fill ``mod.local`` now by its own initializer (else ``spec``,
    else ``default`` by the name rule), or record them when its shape is
    unknown (raising unless the parameter allows deferral)."""
    spec = getattr(mod, "_inits", {}).get(local) or spec
    shape = declared_shape(mod, local)
    if unknown(shape):
        if local not in mod.__dict__.get("_mx_allow_deferred", ()):
            raise MXNetError(f"cannot initialize Parameter {name}: unknown "
                             f"shape {shape} and allow_deferred_init=False")
        _state(mod, "_mx_deferred")[local] = (spec, default, gen)
        return
    t = tensor_of(mod, local)
    buf = fill(name, shape, spec, default, gen)
    t.data = buf.to(device=t.device if dev is None else dev, dtype=t.dtype)
    mod.__dict__.get("_mx_deferred", {}).pop(local, None)
    mod.__dict__.get("_mx_shape", {}).pop(local, None)
    mod._mx_initialized = getattr(mod, "_mx_initialized", set()) | {local}


def finish_deferred(mod, local, name=None) -> None:
    """Materialize a deferred parameter in place from the shape set and
    the initializer ``initialize`` recorded (nothing when it is not
    deferred)."""
    rec = mod.__dict__.get("_mx_deferred", {}).get(local)
    if rec is None:
        return
    shape = declared_shape(mod, local)
    if unknown(shape):
        raise DeferredInitializationError(
            f"Parameter {name or local} has unknown shape {shape}")
    spec, default, gen = rec
    initialize_one(mod, local, name or local, default, gen, spec=spec)


# ---------------------------------------------------------------------------
# Parameter
# ---------------------------------------------------------------------------

class Parameter:
    """A handle; ``name`` is the structural name (``0.weight``,
    ``features.1.running_mean``).  ``Parameter(name, grad_req, shape,
    ...)`` with the JAX package's arguments makes a free-standing
    parameter (a tensor on a holder module of its own)."""

    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0,
                 wd_mult: float = 1.0, init=None,
                 allow_deferred_init: bool = False,
                 differentiable: bool = True, stype="default",
                 grad_stype="default"):
        holder = nn.Module()
        make_param(holder, "value", shape if shape is not None else (0,),
                   init=init, dtype=dtype,
                   grad_req=grad_req if differentiable else "null",
                   lr_mult=lr_mult, wd_mult=wd_mult,
                   allow_deferred=allow_deferred_init)
        holder._mx_standalone = True
        self.name = name
        self._module = holder
        self._local = "value"

    @classmethod
    def _handle(cls, name: str, module, local: str) -> "Parameter":
        p = cls.__new__(cls)
        p.name = name
        p._module = module
        p._local = local
        return p

    # ---- the tensor --------------------------------------------------------
    @property
    def _tensor(self) -> torch.Tensor:
        return tensor_of(self._module, self._local)

    @property
    def _is_buffer(self) -> bool:
        return self._local in self._module._buffers

    @property
    def shape(self):
        return declared_shape(self._module, self._local)

    @shape.setter
    def shape(self, new_shape):
        set_shape(self._module, self._local, new_shape, self.name)

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
        mod = self._module
        if is_deferred(mod, self._local):
            raise DeferredInitializationError(
                f"Parameter {self.name} has not finished deferred init")
        if unknown(self.shape) or (
                getattr(mod, "_mx_standalone", False)
                and self._local not in getattr(mod, "_mx_initialized", ())):
            raise MXNetError(f"Parameter {self.name} has not been "
                             "initialized. Call .initialize() first")
        t = self._tensor
        if ctx is not None and resolve(ctx) != t.device:
            raise MXNetError(f"Parameter {self.name} was not initialized on "
                             f"context {ctx}; it lives on {t.device}")
        return t

    def _finish_deferred_init(self):
        finish_deferred(self._module, self._local, self.name)

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
        if self.grad_req != "null" and not unknown(self.shape):
            autograd.grad_buffer(self._tensor).zero_()

    def set_data(self, data):
        """Write ``data`` (an NDArray, tensor or array) into the
        parameter, cast to its dtype, on its device.  A deferred
        parameter takes the data's shape and is materialized first."""
        from ..ndarray.ndarray import NDArray

        v = data._data if isinstance(data, NDArray) else data
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        if is_deferred(self._module, self._local):
            self.shape = tuple(v.shape)
            self._finish_deferred_init()
        t = self._tensor
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

    def reset_ctx(self, ctx):
        """Move the parameter (and its gradient buffer, at its next use)
        to ``ctx``; one context, as everywhere in the port."""
        dev = resolve(ctx)
        self._check_ctx(None)
        with torch.no_grad():
            if self._is_buffer:
                self._module._buffers[self._local] = self._tensor.to(dev)
            else:
                t = self._tensor
                t.data = t.data.to(dev)

    def var(self):
        """A symbol variable of this parameter's name, shape and dtype."""
        from ..symbol import var

        return var(self.name, shape=self.shape, dtype=self.dtype)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False, generator=None):
        """Fill the tensor by its block's own initializer (a bias's
        "zeros"), else ``init``, else ``default_init`` (Uniform(0.07))
        by the name rule, then move it to ``ctx`` (default gpu(0); raises
        without CUDA unless cpu() is given).  A parameter that its block
        or an earlier call initialized keeps its value unless
        ``force_reinit``.  An unknown shape defers the fill to the first
        forward (or raises without ``allow_deferred_init``)."""
        dev = resolve(ctx)
        mod = self._module
        if self._local in getattr(mod, "_mx_initialized", set()) \
                and not force_reinit:
            return
        t = self._tensor
        with torch.no_grad():
            if self._is_buffer:
                mod._buffers[self._local] = t.to(dev)
            else:
                t.data = t.data.to(dev)
        gen = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            initialize_one(mod, self._local, self.name,
                           default_init or init_mod.Uniform(0.07), gen, dev,
                           spec=init)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A free-standing constant (``grad_req='null'``) holding ``value``,
    refilled with it by ``initialize``."""

    def __init__(self, name, value):
        value = np.asarray(value, dtype=np.float32) \
            if not isinstance(value, np.ndarray) else value
        holder = nn.Module()
        make_constant(holder, "value", value)
        holder._mx_standalone = True
        self.name = name
        self._module = holder
        self._local = "value"
        self.value = value


def make_param(mod, local, shape, init=None, dtype="float32",
               grad_req="write", lr_mult=1.0, wd_mult=1.0,
               allow_deferred=False) -> nn.Parameter:
    """Register on ``mod`` a parameter of ``shape`` (zeros = unknown; a
    zero-element placeholder until resolved), filled at initialize()
    (which raises for an unknown shape without ``allow_deferred``)."""
    shape = (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)
    dims = tuple(max(s, 0) for s in shape)
    p = nn.Parameter(torch.zeros(dims, dtype=dtype_of(dtype)))
    mod.register_parameter(local, p)
    _state(mod, "_inits")[local] = init
    if allow_deferred:
        mod.__dict__.setdefault("_mx_allow_deferred", set()).add(local)
    if grad_req != "write":
        autograd.set_grad_req(p, grad_req)
    if lr_mult != 1.0:
        p._mx_lr_mult = float(lr_mult)
    if wd_mult != 1.0:
        p._mx_wd_mult = float(wd_mult)
    return p


def make_constant(mod, local, value) -> torch.Tensor:
    """Register on ``mod`` a buffer holding ``value`` (fp32), never
    trained, refilled with it by ``initialize``, cast with the block and
    saved and loaded under its structural name."""
    value = torch.as_tensor(np.asarray(value, np.float32))
    mod.register_buffer(local, value.clone())
    _state(mod, "_inits")[local] = init_mod.Constant(value)
    return mod._buffers[local]


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

    @property
    def prefix(self):
        return ""

    def get(self, name: str, **kwargs) -> Parameter:
        """Retrieve ``name``, or make a free-standing parameter of that
        name with ``kwargs`` (the JAX package's create-or-retrieve); a
        ``shape`` given for an existing one sets its unknown dims."""
        p = self._params.get(name)
        if p is None:
            p = self._params[name] = Parameter(name, **kwargs)
        elif kwargs.get("shape") is not None:
            p.shape = kwargs["shape"]
        return p

    def get_constant(self, name: str, value=None) -> Parameter:
        p = self._params.get(name)
        if p is None:
            if value is None:
                raise MXNetError(f"no constant named {name} and no value "
                                 "given")
            p = self._params[name] = Constant(name, value)
        return p

    def update(self, other: "ParameterDict"):
        for k, v in other.items():
            if k in self._params and self._params[k]._tensor \
                    is not v._tensor:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

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

    def reset_ctx(self, ctx):
        for p in _unique(self._params.values()):
            p.reset_ctx(ctx)

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


class BlockParams(ParameterDict):
    """``block.params``: the block's own parameters, and ``get`` /
    ``get_constant`` that make one on the block (or retrieve it, from
    ``shared`` first: a block built with ``params=other.params`` shares
    its parameters by name).  They return the ``Parameter``, and
    ``self.weight = self.params.get("weight", shape=...)`` registers its
    tensor under the attribute's name."""

    def __init__(self, block, shared: Optional["BlockParams"] = None):
        super().__init__()
        self._block = block
        self._shared = shared

    def _own(self):
        b = self._block
        return OrderedDict(
            (n, handle(b, n)) for n in list(b._parameters) + list(b._buffers)
            if tensor_of(b, n) is not None)

    def _find(self, name):
        """(module, local name) of parameter ``name`` of this block, else
        of the shared one's, else None."""
        b = self._block
        local = b.__dict__.get("_mx_get_names", {}).get(name, name)
        if b._parameters.get(local) is not None \
                or b._buffers.get(local) is not None:
            return b, local
        return self._shared._find(name) if self._shared is not None \
            else None

    def get(self, name: str, shape=None, init=None, dtype="float32",
            grad_req="write", lr_mult=1.0, wd_mult=1.0,
            allow_deferred_init=False, differentiable=True, **kwargs):
        found = self._find(name)
        b = self._block
        if found is None:
            make_param(b, name, shape if shape is not None else (0,),
                       init=init, dtype=dtype,
                       grad_req=grad_req if differentiable else "null",
                       lr_mult=lr_mult, wd_mult=wd_mult,
                       allow_deferred=allow_deferred_init)
            _state(b, "_mx_get_names")[name] = name
            found = (b, name)
        elif found[0] is b:
            if shape is not None:
                set_shape(b, found[1], shape, name)
            if init is not None and b._inits.get(found[1]) is None:
                b._inits[found[1]] = init
        return handle(*found, name=name)

    def get_constant(self, name: str, value=None):
        found = self._find(name)
        if found is None:
            if value is None:
                raise MXNetError(f"no constant named {name} and no value "
                                 "given")
            make_constant(self._block, name, value)
            _state(self._block, "_mx_get_names")[name] = name
            found = (self._block, name)
        return handle(*found, name=name)

    def items(self):
        return self._own().items()

    def keys(self):
        return self._own().keys()

    def values(self):
        return self._own().values()

    def __getitem__(self, key):
        return self._own()[key]

    def __contains__(self, key):
        return key in self._own()

    def __iter__(self):
        return iter(self._own())

    def __len__(self):
        return len(self._own())


def _local_of(mod, t):
    for d in (mod._parameters, mod._buffers):
        for k, v in d.items():
            if v is t:
                return k
    return None
