"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/block.py``:

  * Children and parameters are registered by attribute name, so
    ``state_dict()`` keys are the structural names that
    ``_collect_params_with_prefix`` gives in the JAX package
    (``features.4.0.body.0.weight``); ``save_parameters`` and
    ``load_parameters`` key on them, and a file written by the JAX
    package's ``save_parameters`` loads here.  BatchNorm running
    statistics are buffers.
  * ``hybridize()`` switches on a trace scope (:class:`ActiveTrace`,
    read through :func:`current_trace`) around the forward, with the
    same ``train`` flag, so that code gated on a trace (the fused ResNet
    path) behaves as in the JAX package.  The outermost hybridized
    forward is the counterpart of the JAX package's ``CachedOp``: run
    outside autograd recording (PyTorch's grad mode off: inference, the
    served forward, ``net(x)`` on NDArrays outside ``record()``), it is
    captured as a CUDA graph once per signature — the block, the train
    and inference-mode flags, the fused-unit knobs, the inputs' shapes,
    dtypes, strides and device, and the address of every parameter and
    buffer — and replayed per call (``_graphs``; on CPU tensors
    the same cache runs the forward eagerly).  Its outputs are fresh
    tensors each call.  Under ``autograd.record()`` the forward runs
    eagerly in the trace scope, as before (a training-mode CachedOp
    needs separate forward and backward graphs).  Inputs that are not
    all tensors of one device run eagerly; so does a thread inside
    ``_graphs.no_capture()``.
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
  * Parameter shapes are known at construction: deferred shape
    inference (``in_channels=0``) is not ported.
  * A parameter may be registered straight on a block (BERT's
    ``position_weight``) and may be tied: one ``nn.Parameter`` assigned
    to two blocks (BERT's ``mlm_decoder.embed_weight`` is
    ``word_embed.weight``) is listed under both structural names, as in
    the JAX package; only its owner lists it in ``_inits``, so
    ``initialize`` and ``cast`` touch it once and the names stay one
    tensor.
"""
from __future__ import annotations

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
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "ActiveTrace",
           "current_trace", "train_mode", "trace_generator",
           "load_numpy_params", "dtype_of", "cached_op_stats"]


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
    raises)."""

    def __init__(self, train: bool, generator=None):
        self.train = train
        self.generator = generator

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

    def _constant(self, name, value):
        """A constant (the JAX package's ``params.get_constant``): a
        buffer holding ``value`` (fp32), never trained, refilled with it
        by ``initialize``, cast with the block and saved and loaded
        under its structural name."""
        value = torch.as_tensor(np.asarray(value, np.float32))
        self.register_buffer(name, value.clone())
        self._inits[name] = init_mod.Constant(value)

    def __call__(self, *args, **kwargs):
        from ..ndarray.ndarray import NDArray

        if any(isinstance(a, NDArray) for a in args) or any(
                isinstance(v, NDArray) for v in kwargs.values()):
            return _call_on_ndarrays(self, args, kwargs)
        return super().__call__(*args, **kwargs)

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
            (k, Parameter(k, *owner[k]))
            for k in self.state_dict(keep_vars=True)
            if rx is None or rx.match(k)))

    def initialize(self, init=None, ctx=None, seed: int = 0):
        """Fill every parameter and buffer, then move the block to ``ctx``
        (default: gpu(0); raises when there is none — pass cpu(); a list
        of several contexts raises).

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
                mod._mx_initialized = set(inits)
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

        save_ndarrays(filename, {k: v.detach().cpu() for k, v in
                                 self.state_dict(keep_vars=True).items()})

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


def _tied_groups(params):
    """Structural names grouped by the tensor they name: a tied
    parameter (BERT's MLM decoder weight is the word embedding) has one
    group of several names."""
    groups: Dict[int, list] = {}
    for name, t in params.items():
        groups.setdefault(id(t), []).append(name)
    return list(groups.values())


def _load_tensors(block, values, what="dict"):
    """Every parameter, present under at least one of its names and of
    the right shape, or raise before any parameter changes; the names of
    a tied parameter must agree where several are given.  Each value
    keeps its dtype and moves to the parameter's device."""
    params = block.state_dict(keep_vars=True)
    groups = _tied_groups(params)
    missing = [g[0] for g in groups if not any(k in values for k in g)]
    extra = [k for k in values if k not in params]
    if missing:
        raise MXNetError(f"parameters missing in {what}: {missing[:5]}")
    if extra:
        raise MXNetError(f"parameters in {what} do not exist in this "
                         f"block: {extra[:5]}")
    tensors = {k: _to_tensor(v) for k, v in values.items()}
    for name, t in params.items():
        if name in tensors and tuple(tensors[name].shape) != tuple(t.shape):
            raise MXNetError(f"parameter {name}: shape "
                             f"{tuple(tensors[name].shape)} != "
                             f"{tuple(t.shape)}")
    chosen = []
    for g in groups:
        given = [k for k in g if k in tensors]
        first = tensors[given[0]]
        for k in given[1:]:
            if not torch.equal(tensors[k], first):
                raise MXNetError(f"tied parameters {given} are given "
                                 f"different values in {what}")
        chosen.append((params[g[0]], first))
    with torch.no_grad():
        for t, value in chosen:
            t.data = value.to(device=t.device)


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
    """``hybrid_forward(F, x, *args)`` with F the ops namespace."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False

    def hybridize(self, active: bool = True):
        self._active = bool(active)
        return super().hybridize(active)

    def forward(self, x, *args):
        if self._active and current_trace() is None:
            train, gen = train_mode(self), trace_generator()
            xs = (x,) + args
            if not torch.is_grad_enabled() and _graphs.capture_enabled() \
                    and _capturable(xs):
                return _cached_forward(self, xs, train, gen)
            with ActiveTrace(train=train, generator=gen):
                return self.hybrid_forward(_ops, x, *args)
        return self.hybrid_forward(_ops, x, *args)


# the CachedOp of the port: a hybridized forward captured per signature
_FWD_CACHE = _graphs.ExecutableCache("gluon.cached_op", per_owner_max=16)


def cached_op_stats():
    """Hybridized-forward builds in this process (the shape of
    ``optimizer.fused.compile_stats``)."""
    return _FWD_CACHE.stats()


def _capturable(xs) -> bool:
    return all(isinstance(a, torch.Tensor) for a in xs) and \
        len({a.device for a in xs}) == 1


def param_keys(block) -> tuple:
    """``_graphs.tensor_key`` of every parameter and buffer of
    ``block``, each looked up on its module (a replaced tensor is seen as
    well as one whose storage moved); the modules are found once."""
    homes = block.__dict__.get("_graph_homes")
    if homes is None:
        homes = []
        for mod in block.modules():
            homes.extend((mod._parameters, n) for n in mod._parameters)
            homes.extend((mod._buffers, n) for n in mod._buffers)
        block.__dict__["_graph_homes"] = homes
    key = _graphs.tensor_key
    return tuple(key(d[n]) for d, n in homes if d[n] is not None)


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
                return block.hybrid_forward(_ops, *inputs)
        return fn
    return _FWD_CACHE.run(block, slot, sig, make_fn, xs, dev,
                          generators=gens)

    def hybrid_forward(self, F, x, *args):
        raise NotImplementedError


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

    def hybridize(self, active: bool = True):
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
