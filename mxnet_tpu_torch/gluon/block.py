"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``:

  * Children and parameters are registered by attribute name, so
    ``state_dict()`` keys are the structural names that
    ``_collect_params_with_prefix`` gives in the JAX package
    (``features.4.0.body.0.weight``); ``save_parameters`` and
    ``load_parameters`` key on them, and a file written by the JAX
    package's ``save_parameters`` loads here.  BatchNorm running
    statistics are buffers.
  * Custom blocks are written as in MXNet: ``with self.name_scope():
    self.weight = self.params.get("weight", shape=...,
    allow_deferred_init=True)`` (or ``get_constant``), and
    ``hybrid_forward(self, F, x, weight, bias=None)``: each registered
    parameter or buffer of the block that ``hybrid_forward`` names is
    passed to it by keyword (the tensor itself, which is also what a
    trace sees).  A block's attribute of a registered parameter or buffer
    (``net.weight``, ``bn.running_mean``) is its Gluon ``Parameter``, as
    in MXNet (``net.weight.data()``, ``.grad()``, ``.set_data()``); the
    port's own layers read the registered tensor through
    ``self._value("weight")``.  ``name_scope()`` and ``prefix`` give the
    blocks the JAX package's prefixes and names (``dense0_``), which key
    nothing: parameter names are structural.
  * Deferred shapes (``gluon/parameter.py``): a block whose parameters
    are deferred sets their shapes from its first inputs
    (``_infer_param_shapes``, ``infer_shape``) and fills them before its
    forward; a hybridized block first resolves its whole tree by one
    eager inference pass (no running-statistics update, no dropout), so
    no capture ever holds a placeholder.
  * ``hybridize(active, static_alloc, static_shape, **kwargs)`` switches
    on a trace scope (:class:`ActiveTrace`, read through
    :func:`current_trace`) around the forward, with the same ``train``
    flag, so that code gated on a trace (the fused ResNet path) behaves
    as in the JAX package; ``static_alloc``/``static_shape`` change
    nothing (as in the JAX package) and ``mirror`` (default
    ``MXNET_BACKWARD_DO_MIRROR``) turns on gradient mirroring.  The
    outermost hybridized forward is the counterpart of the JAX package's
    ``CachedOp``, captured per signature — the block, the train and
    inference-mode flags, the fused-unit knobs, the inputs' shapes,
    dtypes, strides and device, and the address of every parameter and
    buffer — in ``_graphs``: with grad mode off (inference, the served
    forward, ``net(x)`` on NDArrays outside ``record()``) as one CUDA
    graph replayed per call; under ``autograd.record()`` (grad mode on)
    as a forward graph and a backward graph behind one autograd function
    (``ExecutableCache.run_train``), whose signature adds which inputs
    require a gradient, each parameter's ``grad_req`` and the mirror
    flag.  On CPU tensors the same cache runs the function eagerly.
    Outputs are fresh tensors each call.  Inputs that are not all
    tensors of one device run eagerly in the trace scope; so does a
    thread inside ``_graphs.no_capture()``.
  * Gradient mirroring (``mxnet_tpu/gluon/block.py:614-642``): under a
    mirror trace with grad mode on, each sub-block that owns parameters
    and takes tensors only runs as a ``torch.utils.checkpoint`` segment;
    its recompute reuses the running mean its first pass read and the
    dropout masks it drew (``_graphs.segment_value``) and updates no
    running statistics.
  * The train flag: inside a trace scope, the scope's; inside the
    NDArray entry point, ``autograd.is_training()``; else (tensor
    callers outside any scope) ``module.training``.  Calling a block on
    NDArrays (MXNet's imperative surface) runs its forward on their
    tensors with PyTorch's grad mode on only under
    ``autograd.record()``, in a scope whose train flag is
    ``autograd.is_training()`` — a hybridized block in
    ``ActiveTrace(train=autograd.is_training())``, so kernels 1-2
    engage, as the JAX ``CachedOp`` reads ``ag.is_training()``; a
    non-hybridized one op-granular — and returns NDArrays.  So
    ``net(x)`` outside ``record()`` is inference: BatchNorm uses and
    keeps its running statistics and Dropout is the identity.  Tensor
    callers (``SPMDTrainer``, serving) are unchanged.
  * ``collect_params()`` returns a ``ParameterDict`` of ``Parameter``
    handles keyed on the structural names (the JAX package keys its
    ParameterDict on name-scope names); ``state_dict(keep_vars=True)``
    gives the tensors by the same names.
  * A parameter may be registered straight on a block (BERT's
    ``position_weight``) and may be tied: one ``nn.Parameter`` assigned
    to two blocks (BERT's ``mlm_decoder.embed_weight`` is
    ``word_embed.weight``) is listed under both structural names, as in
    the JAX package; only its owner lists it in ``_inits``, so
    ``initialize`` and ``cast`` touch it once and the names stay one
    tensor.
"""
from __future__ import annotations

import inspect
import re
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import autograd as _autograd
from .. import context as _context
from .. import initializer as init_mod
from .. import ops as _ops
from .. import random as _random
from ..base import MXNetError, dtype_of
from .. import _graphs
from ..util import env as _env
from . import parameter as _param
from .parameter import (BlockParams, DeferredInitializationError, Parameter,
                        ParameterDict)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "ActiveTrace",
           "current_trace", "train_mode", "trace_generator",
           "load_numpy_params", "dtype_of", "cached_op_stats",
           "DeferredInitializationError"]


# ---------------------------------------------------------------------------
# trace scope — active while a hybridized block runs its forward
# ---------------------------------------------------------------------------

class _TraceState(threading.local):
    def __init__(self):
        self.scope: Optional["ActiveTrace"] = None
        # (train, generator) of the NDArray entry point outside a trace
        self.imperative: Optional[tuple] = None


_TRACE = _TraceState()


class ActiveTrace:
    """The scope a hybridized forward runs in (thread-local).  Dropout
    inside it draws from ``generator`` (None: dropout in training
    raises); ``mirror`` makes each sub-block that owns parameters a
    checkpoint segment."""

    def __init__(self, train: bool, generator=None, mirror=False):
        self.train = train
        self.generator = generator
        self.mirror = mirror

    def __enter__(self):
        self._old = _TRACE.scope
        _TRACE.scope = self
        return self

    def __exit__(self, *exc):
        _TRACE.scope = self._old
        return False


def current_trace() -> Optional[ActiveTrace]:
    return _TRACE.scope


def train_mode(block) -> bool:
    """The trace scope's train flag inside one (the JAX package reads
    the trace, block.py:187), else the NDArray entry point's
    (``autograd.is_training()``), else the module's mode."""
    ts = _TRACE.scope
    if ts is not None:
        return ts.train
    imp = _TRACE.imperative
    return imp[0] if imp is not None else block.training


def trace_generator():
    """The dropout generator of the trace scope, else of the NDArray
    entry point (the data's device's); None outside both."""
    ts = _TRACE.scope
    if ts is not None:
        return ts.generator
    imp = _TRACE.imperative
    return imp[1] if imp is not None else None


class _Imperative:
    """The NDArray entry point's scope for a block that is not
    hybridized: the train flag and generator without a trace."""

    def __init__(self, train, generator):
        self._state = (train, generator)

    def __enter__(self):
        self._old = _TRACE.imperative
        _TRACE.imperative = self._state
        return self

    def __exit__(self, *exc):
        _TRACE.imperative = self._old
        return False


def _call_on_ndarrays(block, args, kwargs, method=None):
    """MXNet's imperative call: NDArrays in, the forward (or ``method``,
    one of the block's stages) on their tensors, NDArrays out."""
    from ..ndarray.ndarray import NDArray, wrap_outputs

    nds = [a for a in args if isinstance(a, NDArray)] + \
        [v for v in kwargs.values() if isinstance(v, NDArray)]
    targs = [a._data if isinstance(a, NDArray) else a for a in args]
    tkw = {k: v._data if isinstance(v, NDArray) else v
           for k, v in kwargs.items()}
    train = _autograd.is_training()
    gen = _random.generator(nds[0].ctx)
    if method is not None and getattr(block, "_active", False) \
            and current_trace() is None:
        # a stage of the block runs in its trace scope, not captured
        scope = ActiveTrace(train=train, generator=gen)
    else:
        # a hybridized forward opens its own scope (and its CachedOp)
        scope = _Imperative(train, gen)
    with torch.set_grad_enabled(_autograd.is_recording()), scope:
        out = method(*targs, **tkw) if method is not None \
            else nn.Module.__call__(block, *targs, **tkw)
    return wrap_outputs(out) if isinstance(out, torch.Tensor) \
        else type(out)(wrap_outputs(out))


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class _Scope(threading.local):
    def __init__(self):
        self.current: Optional["_NameManager"] = None
        self.counters: Dict[str, int] = {}


_SCOPE = _Scope()


class _NameManager:
    """A block's name scope (the JAX package's): a child made inside
    ``with parent.name_scope():`` takes the parent's prefix plus its own
    class alias and a count per scope; outside any scope, the count is
    process-wide."""

    def __init__(self, prefix):
        self._prefix = prefix
        self._counters: Dict[str, int] = {}

    @staticmethod
    def create(prefix: Optional[str], hint: str) -> str:
        cur = _SCOPE.current
        counters = _SCOPE.counters if cur is None else cur._counters
        if prefix is None:
            i = counters.get(hint, 0)
            counters[hint] = i + 1
            prefix = f"{hint}{i}_"
        return prefix if cur is None else cur._prefix + prefix

    def __enter__(self):
        self._old = _SCOPE.current
        _SCOPE.current = self
        return self

    def __exit__(self, *exc):
        _SCOPE.current = self._old
        return False


class Block(nn.Module):
    """Base container.  ``prefix`` names the block as in the JAX package
    (parameter names stay structural); ``params``, another block's
    ``params``, shares its parameters by name."""

    def __init__(self, prefix: Optional[str] = None, params=None):
        super().__init__()
        # local parameter/buffer name -> its initializer (None = default)
        self._inits: Dict[str, object] = {}
        self._params = BlockParams(
            self, params if isinstance(params, BlockParams) else None)
        self._prefix = _NameManager.create(prefix,
                                           type(self).__name__.lower())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _NameManager(self._prefix)

    @property
    def params(self) -> BlockParams:
        """This block's own parameters; ``get``/``get_constant`` make one
        (see ``parameter.BlockParams``)."""
        return self._params

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    def name_scope(self):
        """The scope children made in it take their prefixes from."""
        return self._scope

    def _value(self, name) -> Optional[torch.Tensor]:
        """The tensor registered as parameter or buffer ``name`` (what
        the forwards read; ``self.name`` is its ``Parameter``)."""
        return _param.tensor_of(self, name)

    def __getattr__(self, name):
        # a registered parameter or buffer reads as its Gluon Parameter
        # (one handle per name); children and the rest as nn.Module has
        # them
        d = self.__dict__
        if name in d.get("_parameters", ()) or name in d.get("_buffers", ()):
            if _param.tensor_of(self, name) is None:
                return None
            return _param.handle(self, name)
        return super().__getattr__(name)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter) \
                and not getattr(value._module, "_mx_standalone", False):
            # a block's Parameter (params.get's, another block's attribute):
            # its tensor is registered here, a buffer as a buffer
            t = value._tensor
            if value._is_buffer and value._module is not self:
                self.register_buffer(name, t)
                return
            value = t
        # a parameter or constant made by params.get under another name
        # is registered under the attribute's name instead
        gets = self.__dict__.get("_mx_get_names")
        if gets and isinstance(value, torch.Tensor):
            old = _param._local_of(self, value)
            if old is not None and old != name and gets.get(old) == old:
                reg = self._parameters if old in self._parameters \
                    else self._buffers
                del reg[old]
                handles = self.__dict__.get("_mx_handles", {})
                if old in handles:
                    handles[name] = handles.pop(old)
                    handles[name]._local = name
                self._inits[name] = self._inits.pop(old, None)
                deferrable = self.__dict__.get("_mx_allow_deferred", set())
                if old in deferrable:
                    deferrable.discard(old)
                    deferrable.add(name)
                gets[old] = name
                if reg is self._buffers:
                    self.register_buffer(name, value)
                    return
        super().__setattr__(name, value)

    def _param(self, name, shape, init=None, dtype="float32",
               allow_deferred=False):
        """Register a parameter, filled at initialize() (zeros in
        ``shape``: unknown, resolved at the first forward when
        ``allow_deferred``)."""
        return _param.make_param(self, name, shape, init=init, dtype=dtype,
                                 allow_deferred=allow_deferred)

    def _buffer(self, name, shape, init=None, allow_deferred=False):
        self.register_buffer(name, torch.zeros(tuple(max(int(s), 0)
                                                     for s in shape)))
        self._inits[name] = init
        if allow_deferred:
            self.__dict__.setdefault("_mx_allow_deferred", set()).add(name)

    def _constant(self, name, value):
        """A constant (the JAX package's ``params.get_constant``): a
        buffer holding ``value`` (fp32), never trained, refilled with it
        by ``initialize``, cast with the block and saved and loaded
        under its structural name."""
        _param.make_constant(self, name, value)

    def _set_shape(self, name, shape):
        """Set the unknown dims of the parameter or buffer ``name``."""
        _param.set_shape(self, name, shape)

    def __call__(self, *args, **kwargs):
        from ..ndarray.ndarray import NDArray

        if any(isinstance(a, NDArray) for a in args) or any(
                isinstance(v, NDArray) for v in kwargs.values()):
            return _call_on_ndarrays(self, args, kwargs)
        return super().__call__(*args, **kwargs)

    def register_child(self, block, name: Optional[str] = None):
        """Register ``block`` as a child under ``name`` (default: its
        index among the children)."""
        self.add_module(name or str(len(self._modules)), block)

    def summary(self, *inputs):
        """Print one row a block: its class, name and the number of
        values of its own parameters of known shape (the JAX package's
        table; ``inputs`` are not run)."""
        rows = []

        def walk(b, indent):
            n = sum(int(np.prod(p.shape)) for p in b.params.values()
                    if p.shape and all(s > 0 for s in p.shape))
            rows.append(f"{'  ' * indent}{type(b).__name__}"
                        f"({getattr(b, 'name', '')}): {n} params")
            for c in b.children():
                walk(c, indent + 1)

        walk(self, 0)
        print("\n".join(rows))

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """A handle on every parameter and buffer by structural name
        (``select``: a regular expression the names must match)."""
        owner = {}
        for mname, mod in self.named_modules(remove_duplicate=False):
            for local in list(mod._parameters) + list(mod._buffers):
                full = f"{mname}.{local}" if mname else local
                owner.setdefault(full, (mod, local))
        rx = re.compile(select) if select else None
        return ParameterDict(OrderedDict(
            (k, Parameter._handle(k, *owner[k]))
            for k in self.state_dict(keep_vars=True)
            if rx is None or rx.match(k)))

    def initialize(self, init=None, ctx=None, seed: int = 0,
                   verbose=False, force_reinit=False):
        """Fill every parameter and buffer that holds no value yet (every
        one with ``force_reinit``), then move the block to ``ctx``
        (default: gpu(0); raises when there is none — pass cpu(); a list
        of several contexts raises).  When every one holds a value and
        ``force_reinit`` is off, nothing changes, as in the JAX package.

        A parameter's own initializer (e.g. a bias's "zeros") fills it;
        the others take ``init`` (default Uniform(0.07)) by name.  Draws
        come from a CPU ``torch.Generator`` seeded with ``seed``, in the
        block's order, over the parameters being filled; a parameter of
        unknown shape draws from it at its first forward."""
        todo = [(f"{mname}.{local}" if mname else local, mod, local)
                for mname, mod in self.named_modules()
                for local in list(getattr(mod, "_inits", {}))
                if force_reinit
                or local not in getattr(mod, "_mx_initialized", ())]
        # several contexts raise even when nothing is left to fill
        dev = _context.resolve(ctx) if ctx is not None or todo else None
        if not todo:
            return self
        gen = torch.Generator().manual_seed(int(seed))
        default = init_mod.create(init)
        self.to(dev)
        with torch.no_grad():
            for full, mod, local in todo:
                _param.initialize_one(mod, local, full, default, gen)
        for mod in self.modules():
            mod.__dict__.pop("_mx_resolved", None)
        return self

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs):
        for c in self.children():
            if isinstance(c, Block):
                c.hybridize(active, static_alloc=static_alloc,
                            static_shape=static_shape, **kwargs)
        return self

    def cast(self, dtype):
        """Cast parameters (and non-statistics buffers) to ``dtype``."""
        dt = dtype_of(dtype)
        for c in self.children():
            if isinstance(c, Block):
                c.cast(dtype)
        for name in self._inits:
            t = self._value(name)
            t.data = t.data.to(dt)
        return self

    def save_parameters(self, filename: str, deduplicate: bool = False):
        """Save every parameter and buffer under its structural name;
        ``deduplicate`` is accepted and changes nothing, as in the JAX
        package (a tied parameter is saved under each of its names)."""
        from ..serialization import save_ndarrays

        save_ndarrays(filename, {k: v.detach().cpu() for k, v in
                                 self.state_dict(keep_vars=True).items()})

    def load_parameters(self, filename: str, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False, cast_dtype=False,
                        dtype_source="current") -> None:
        """Load a ``.params`` file keyed on structural names (one written
        by the JAX package's ``save_parameters`` included).  A parameter
        the file lacks raises unless ``allow_missing`` (it keeps its
        value); a name the block lacks raises unless ``ignore_extra``.
        ``ctx``, ``cast_dtype`` and ``dtype_source`` are accepted and
        change nothing here: each value keeps its dtype and moves to its
        parameter's device."""
        from ..serialization import load_ndarrays

        loaded = load_ndarrays(filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename}: parameters must be named")
        _load_tensors(self, loaded, what=filename,
                      allow_missing=allow_missing, ignore_extra=ignore_extra)

    # the reference's deprecated names
    def save_params(self, filename: str, deduplicate: bool = False):
        return self.save_parameters(filename, deduplicate)

    def load_params(self, *args, **kwargs):
        return self.load_parameters(*args, **kwargs)


def _to_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: same bits
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _tied_groups(params):
    """Structural names grouped by the tensor they name: a tied
    parameter (BERT's MLM decoder weight is the word embedding) has one
    group of several names."""
    groups: Dict[int, list] = {}
    for name, t in params.items():
        groups.setdefault(id(t), []).append(name)
    return list(groups.values())


def _load_tensors(block, values, what="dict", allow_missing=False,
                  ignore_extra=False):
    """Every parameter, present under at least one of its names (or
    skipped under ``allow_missing``) and of the right shape, or raise
    before any parameter changes; names the block lacks raise unless
    ``ignore_extra``; the names of a tied parameter must agree where
    several are given.  Each value keeps its dtype and moves to the
    parameter's device."""
    params = block.state_dict(keep_vars=True)
    groups = _tied_groups(params)
    missing = [g[0] for g in groups if not any(k in values for k in g)]
    extra = [k for k in values if k not in params]
    if missing and not allow_missing:
        raise MXNetError(f"parameters missing in {what}: {missing[:5]}")
    if extra and not ignore_extra:
        raise MXNetError(f"parameters in {what} do not exist in this "
                         f"block: {extra[:5]}")
    tensors = {k: _to_tensor(v) for k, v in values.items() if k in params}
    homes = _homes_by_name(block)
    for name, t in params.items():
        if name not in tensors:
            continue
        want = _param.declared_shape(*homes[name])
        got = tuple(tensors[name].shape)
        if got != want and not (len(got) == len(want) and all(
                w == 0 or w == g for w, g in zip(want, got))):
            raise MXNetError(f"parameter {name}: shape {got} != {want}")
    chosen = []
    for g in groups:
        given = [k for k in g if k in tensors]
        if not given:
            continue
        first = tensors[given[0]]
        for k in given[1:]:
            if not torch.equal(tensors[k], first):
                raise MXNetError(f"tied parameters {given} are given "
                                 f"different values in {what}")
        chosen.append((params[g[0]], first, g[0]))
    with torch.no_grad():
        for t, value, name in chosen:
            t.data = value.to(device=t.device)
            mod, local = homes[name]
            for attr in ("_mx_deferred", "_mx_shape"):
                mod.__dict__.get(attr, {}).pop(local, None)
            mod._mx_initialized = getattr(mod, "_mx_initialized", set()) \
                | {local}


def _homes_by_name(block):
    """Structural name -> (owning module, local name)."""
    out = {}
    for mname, mod in block.named_modules(remove_duplicate=False):
        for local in list(mod._parameters) + list(mod._buffers):
            out.setdefault(f"{mname}.{local}" if mname else local,
                           (mod, local))
    return out


def load_numpy_params(block: Block, values: Dict[str, np.ndarray]) -> None:
    """Load ``{structural name: array}`` (numpy, ml_dtypes.bfloat16
    included, or tensors) into ``block``, keeping each array's dtype.
    Raises on a missing, extra or mis-shaped name; a tied parameter
    loads through any one of its names."""
    _load_tensors(block, values)


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------

class HybridBlock(Block):
    """``hybrid_forward(F, x, *args, **params)`` with F the ops namespace
    and ``params`` the registered parameters it names."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._flags: Dict[str, object] = {}

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs):
        """As in the JAX package: ``static_alloc``/``static_shape`` are
        accepted and change nothing (a captured graph is statically
        planned by construction); ``mirror`` turns gradient mirroring on
        or off (default ``MXNET_BACKWARD_DO_MIRROR``)."""
        self._active = bool(active)
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        return super().hybridize(active, static_alloc=static_alloc,
                                 static_shape=static_shape, **kwargs)

    def _mirror(self) -> bool:
        m = self._flags.get("mirror")
        return _env.get_bool("MXNET_BACKWARD_DO_MIRROR") if m is None \
            else bool(m)

    def _infer_param_shapes(self, *args):
        """Overridden by the layers whose parameter shapes follow their
        inputs; called with the forward's inputs while a shape is
        unknown."""
        raise MXNetError(
            f"{type(self).__name__} cannot infer parameter shapes; pass "
            "explicit input dims (in_units/in_channels) or initialize with "
            "known shapes")

    def infer_shape(self, *args):
        """Resolve this block's deferred parameter shapes from example
        inputs and fill them."""
        self._infer_param_shapes(*args)
        deferred = self.__dict__.get("_mx_deferred", {})
        for local in list(deferred):
            _param.finish_deferred(self, local)

    def forward(self, x, *args):
        if self._active and current_trace() is None:
            xs = (x,) + args
            _resolve_tree(self, xs)
            train, gen = train_mode(self), trace_generator()
            grad = torch.is_grad_enabled()
            mirror = grad and self._mirror()
            if _graphs.capture_enabled() and _capturable(xs):
                if grad:
                    return _cached_train(self, xs, train, gen, mirror)
                return _cached_forward(self, xs, train, gen)
            with ActiveTrace(train=train, generator=gen, mirror=mirror):
                return self._call_hybrid(x, *args)
        if self.__dict__.get("_mx_deferred"):
            self.infer_shape(x, *args)
        return self._call_hybrid(x, *args)

    def _call_hybrid(self, x, *args):
        """``hybrid_forward`` with the parameters it names; a checkpoint
        segment under a mirror trace (see the module docstring)."""
        names = _param_kwargs(type(self))
        skip = 1 + len(args)
        kw = {n: t for n in names[skip:]
              for t in (self._parameters.get(n, self._buffers.get(n)),)
              if t is not None} if len(names) > skip else {}
        ts = current_trace()
        if ts is not None and ts.mirror and torch.is_grad_enabled() \
                and any(p is not None for p in self._parameters.values()) \
                and all(isinstance(a, torch.Tensor) for a in (x,) + args):
            return _mirror_segment(self, ts, (x,) + args, kw)
        return self.hybrid_forward(_ops, x, *args, **kw)

    def hybrid_forward(self, F, x, *args, **params):
        raise NotImplementedError

    def export(self, path: str, epoch: int = 0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` as the JAX
        package's ``export`` writes them: the JSON holds the block's
        metadata (``framework``, ``block``, each parameter's shape by
        name), not a symbol graph, and the ``.params`` file every
        parameter and buffer by its structural name, which both
        packages' ``load_parameters`` read.  Needs a forward after
        ``hybridize()``, as there."""
        import json

        from ..serialization import save_ndarrays

        if not (self._active and self.__dict__.get("_mx_resolved")):
            raise MXNetError("run at least one forward after hybridize() "
                             "before export()")
        plist = sorted(self.collect_params().items())
        meta = {"framework": "mxnet_tpu_torch", "block": type(self).__name__,
                "params": {n: list(p.shape) for n, p in plist}}
        sym_file = f"{path}-symbol.json"
        params_file = f"{path}-{epoch:04d}.params"
        with open(sym_file, "w") as f:
            json.dump(meta, f, indent=2)
        save_ndarrays(params_file, {n: p._tensor.detach().cpu()
                                    for n, p in plist})
        return sym_file, params_file


_KW_NAMES: Dict[type, tuple] = {}


def _param_kwargs(cls) -> tuple:
    """The names of ``cls.hybrid_forward``'s arguments after ``F``, in
    order: the inputs, then the parameters it takes by name."""
    names = _KW_NAMES.get(cls)
    if names is None:
        sig = inspect.signature(cls.hybrid_forward)
        names = _KW_NAMES[cls] = tuple(
            n for n, p in list(sig.parameters.items())[2:]
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY))
    return names


def _resolve_tree(block, xs) -> None:
    """Before a hybridized forward: when any parameter of the tree is
    deferred, one eager inference pass (no gradient, no running-statistics
    update, no dropout) sets their shapes and fills them, as the JAX
    package's CachedOp retries after an eager pass."""
    if block.__dict__.get("_mx_resolved"):
        return
    if block.__dict__.get("_mx_deferred"):
        block.infer_shape(*xs)
    if any(m.__dict__.get("_mx_deferred") for m in block.modules()):
        with torch.no_grad(), ActiveTrace(train=False):
            block._call_hybrid(*xs)
        block.__dict__.pop("_graph_homes", None)
    block.__dict__["_mx_resolved"] = True


def _mirror_segment(block, ts, xs, kw):
    """The block's forward as a checkpoint segment: its backward
    recomputes it from its inputs, in the trace scope of the forward (the
    recompute may run on autograd's device thread), with the first
    pass's running means and dropout masks."""
    from torch.utils.checkpoint import checkpoint

    seg = _graphs.segment()

    def run(*inputs):
        with seg.run(), ActiveTrace(train=ts.train, generator=ts.generator,
                                    mirror=True):
            return block.hybrid_forward(_ops, *inputs, **kw)
    return checkpoint(run, *xs, use_reentrant=False,
                      preserve_rng_state=False)


# the CachedOp of the port: a hybridized forward captured per signature
_FWD_CACHE = _graphs.ExecutableCache("gluon.cached_op", per_owner_max=16)


def cached_op_stats():
    """Hybridized-forward builds in this process, inference and training
    (the shape of ``optimizer.fused.compile_stats``)."""
    return _FWD_CACHE.stats()


def _capturable(xs) -> bool:
    return all(isinstance(a, torch.Tensor) for a in xs) and \
        len({a.device for a in xs}) == 1


def _homes(block):
    """(dict, name, is parameter) of every parameter and buffer of
    ``block``, looked up on its module at each use (a replaced tensor is
    seen as well as one whose storage moved); found once."""
    homes = block.__dict__.get("_graph_homes")
    if homes is None:
        homes = []
        for mod in block.modules():
            homes.extend((mod._parameters, n, True) for n in mod._parameters)
            homes.extend((mod._buffers, n, False) for n in mod._buffers)
        block.__dict__["_graph_homes"] = homes
    return homes


def param_keys(block) -> tuple:
    """``_graphs.tensor_key`` of every parameter and buffer of
    ``block``."""
    key = _graphs.tensor_key
    return tuple(key(d[n]) for d, n, _ in _homes(block) if d[n] is not None)


def _cached_forward(block, xs, train, gen):
    """The block's forward through its CachedOp (see the module
    docstring)."""
    dev = xs[0].device
    slot = (train, torch.is_inference_mode_enabled(), _env.trace_knobs(),
            tuple((tuple(a.shape), a.dtype, a.stride()) for a in xs),
            str(dev))
    sig = (slot, param_keys(block))
    gens = (gen,) if gen is not None and gen.device.type == "cuda" else ()

    def make_fn():
        def fn(*inputs):
            with ActiveTrace(train=train, generator=gen):
                return block._call_hybrid(*inputs)
        return fn
    return _FWD_CACHE.run(block, slot, sig, make_fn, xs, dev,
                          generators=gens)


def _cached_train(block, xs, train, gen, mirror):
    """The block's forward under ``autograd.record()`` through the
    training-mode entry of its CachedOp: forward and backward graphs on
    the card, the same function eagerly on the CPU."""
    dev = xs[0].device
    seen, params, reqs = set(), [], []
    for d, n, is_param in _homes(block):
        t = d[n]
        if t is None or not is_param or id(t) in seen:
            continue
        seen.add(id(t))
        reqs.append(_autograd.grad_req_of(t))
        if t.requires_grad:
            params.append(t)
    in_req = tuple(bool(a.requires_grad) for a in xs)
    slot = (train, False, _env.trace_knobs(),
            tuple((tuple(a.shape), a.dtype, a.stride()) for a in xs),
            str(dev), "record", in_req, tuple(reqs), mirror)
    sig = (slot, param_keys(block))
    gens = (gen,) if gen is not None and gen.device.type == "cuda" else ()

    def make_fn():
        homes = [(d, n) for d, n, is_param in _homes(block)
                 if is_param and d[n] is not None and d[n].requires_grad]

        def fn(aliases, *inputs):
            # the forward reads each parameter's alias (_graphs._aliases)
            alias = dict(zip(map(id, params), aliases))
            swapped = [(d, n, d[n]) for d, n in homes]
            for d, n, t in swapped:
                d[n] = alias[id(t)]
            try:
                with ActiveTrace(train=train, generator=gen, mirror=mirror):
                    return block._call_hybrid(*inputs)
            finally:
                for d, n, t in swapped:
                    d[n] = t
        return fn
    return _FWD_CACHE.run_train(block, slot, sig, make_fn, params, xs,
                                in_req, dev, generators=gens)


# ---------------------------------------------------------------------------
# SymbolBlock
# ---------------------------------------------------------------------------

def _eval_symbol(outputs, feed, train, gen):
    """Walk a Symbol's graph on tensors through the registered ops, under
    PyTorch's grad mode as it is (so autograd records it), with the
    train flag and the dropout generator given, and BatchNorm's moving
    statistics written into their tensors in place in training (the
    counterpart of ``_eval_symbol_eager``, which runs the ``nd``
    frontends)."""
    from ..ops.registry import get_op
    from ..symbol.symbol import KEYED_OPS, TRAIN_AWARE_OPS, op_attrs

    env = {}
    for node in outputs._topo():
        if node.op is None:
            if node.name not in feed:
                raise MXNetError(
                    f"SymbolBlock: free variable {node.name!r} is neither "
                    f"an input nor a loaded parameter")
            env[(id(node), 0)] = feed[node.name]
            continue
        kw = op_attrs(node)
        if node.op in TRAIN_AWARE_OPS:
            kw["train"] = train
        if node.op in KEYED_OPS:
            kw["generator"] = gen
        out = get_op(node.op).fn(*[env[(id(i), ix)] for i, ix in node.inputs],
                                 **kw)
        if node.op == "BatchNorm" and isinstance(out, tuple) \
                and node.num_outputs == 1:
            out, new_mean, new_var = out
            with torch.no_grad():
                feed[node.inputs[3][0].name].copy_(new_mean)
                feed[node.inputs[4][0].name].copy_(new_var)
        outs = out if isinstance(out, (tuple, list)) else [out]
        for i, o in enumerate(outs):
            env[(id(node), i)] = o
    res = [env[(id(n), i)] for n, i in outputs._heads]
    return res[0] if len(res) == 1 else res


class SymbolBlock(HybridBlock):
    """A Block over a symbol's graph (counterpart of the JAX package's
    ``SymbolBlock``): the arguments that are not inputs are parameters
    and the aux states buffers, registered under their symbol names, and
    the forward walks the graph through the registered ops.  Without
    ``params`` the shapes come from the first call's inputs: the block
    is made and initialized then, with what ``initialize`` was given.
    ``hybridize`` warns and changes nothing, as in the JAX package."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__()
        from ..symbol import Group

        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._sb_outputs = outputs
        self._sb_inputs = [i if isinstance(i, str) else i.name
                           for i in inputs]
        names = set(self._sb_inputs)
        self._sb_args = [n for n in outputs.list_arguments()
                         if n not in names]
        self._sb_aux = list(outputs.list_auxiliary_states())
        self._sb_pending = None
        if params is not None:
            self._sb_register({n: _to_tensor(getattr(v, "_data", v))
                               for n, v in params.items()})

    def _sb_register(self, values):
        for n in self._sb_args + self._sb_aux:
            if n not in values:
                raise MXNetError(f"SymbolBlock: no value for parameter "
                                 f"{n!r}")
            t = values[n].detach().clone()
            if n in self._sb_aux:
                self.register_buffer(n, t)
            else:
                self.register_parameter(n, nn.Parameter(t))
            self._inits[n] = None

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A block of ``prefix-symbol.json`` and, when given, its
        ``.params`` (``arg:``/``aux:`` names or plain ones), on ``ctx``
        (default gpu(0))."""
        from .. import symbol as sym_mod
        from ..serialization import load_ndarrays

        block = SymbolBlock(sym_mod.load(symbol_file), input_names)
        if param_file:
            raw = load_ndarrays(param_file)
            if not isinstance(raw, dict):
                raise MXNetError("SymbolBlock.imports: params file must "
                                 "hold a named dict")
            block._sb_register({k.split(":", 1)[-1]: v
                                for k, v in raw.items()})
            block.to(_context.resolve(ctx))
        return block

    def initialize(self, init=None, ctx=None, seed: int = 0):
        if self._inits or not (self._sb_args or self._sb_aux):
            return super().initialize(init, ctx, seed)
        self._sb_pending = (init, ctx, seed)
        return self

    def hybridize(self, active: bool = True, **kwargs):
        if active:
            import warnings

            warnings.warn("SymbolBlock is already a graph; hybridize() "
                          "has no effect", stacklevel=2)
        return self

    def _sb_deferred_init(self, xs):
        if self._sb_pending is None:
            raise MXNetError("SymbolBlock: call initialize() first")
        shapes = {n: tuple(x.shape) for n, x in zip(self._sb_inputs, xs)}
        arg_shapes, _, aux_shapes = \
            self._sb_outputs.infer_shape_partial(**shapes)
        by_name = dict(zip(self._sb_outputs.list_arguments(), arg_shapes))
        by_name.update(zip(self._sb_aux, aux_shapes))
        unknown = [n for n in self._sb_args + self._sb_aux
                   if by_name.get(n) is None]
        if unknown:
            raise MXNetError(f"SymbolBlock: cannot infer the shapes of "
                             f"{unknown} from input shapes {shapes}")
        self._sb_register({n: torch.zeros(by_name[n])
                           for n in self._sb_args + self._sb_aux})
        super().initialize(*self._sb_pending)
        self._sb_pending = None

    def forward(self, *xs):
        if not self._inits and (self._sb_args or self._sb_aux):
            self._sb_deferred_init(xs)
        feed = dict(zip(self._sb_inputs, xs))
        feed.update(self._parameters)
        feed.update(self._buffers)
        return _eval_symbol(self._sb_outputs, feed, train_mode(self),
                            trace_generator())
