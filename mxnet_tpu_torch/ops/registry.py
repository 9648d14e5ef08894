"""Operator registry and the imperative invoke path (counterpart of
``mxnet_tpu/ops/registry.py``).

An op is a plain function on tensors, ``fn(*tensors, **attrs)``, as the
port's ops already are.  The registry names it as the JAX package does
(``FullyConnected``, ``broadcast_add``, ``sgd_mom_update``, ...) so that
the generated ``nd`` namespace and NDArray's operators reach it.
:func:`invoke` unwraps NDArrays to their tensors, calls the function
with PyTorch's grad mode on exactly when ``autograd.is_recording()`` (and
the op is differentiable), and wraps the results.  There is no per-op
executable cache and no ``grad_fn``: PyTorch runs eagerly and
``torch.autograd`` records the ops.
"""
from __future__ import annotations

import ast
import inspect
from typing import Any, Callable, Dict, List, Sequence

import torch

from ..base import MXNetError
from ..util import env

__all__ = ["Operator", "register_op", "get_op", "list_ops", "invoke",
           "QUEUED"]


class Operator:
    """A registered op: a function on tensors plus its metadata.
    ``differentiable=False`` ops never record (comparisons, argmax).  An
    op with several outputs returns a tuple; the update ops return the
    new values and the caller writes them back.  ``num_outputs`` is the
    count a symbol node of the op has: a number, or a function of the
    node's attributes (BatchNorm's depends on its train flag)."""

    def __init__(self, name: str, fn: Callable, *, num_outputs=1,
                 differentiable: bool = True):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self._build_descriptor()

    def nout(self, attrs: dict) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def _build_descriptor(self):
        """The typed attribute descriptor from the function's signature:
        parameters with defaults are attributes, the rest array inputs."""
        self.attr_defaults: Dict[str, Any] = {}
        self.input_names: List[str] = []
        self.param_order: List[str] = []
        self.param_default: Dict[str, Any] = {}
        self.allow_any_attr = False
        try:
            sig = inspect.signature(self.fn)
        except (TypeError, ValueError):
            self.allow_any_attr = True
            return
        for p in sig.parameters.values():
            if p.kind == inspect.Parameter.VAR_KEYWORD:
                self.allow_any_attr = True
            elif p.kind == inspect.Parameter.VAR_POSITIONAL:
                self.input_names.append("*" + p.name)
            elif p.default is inspect.Parameter.empty:
                self.input_names.append(p.name)
                self.param_order.append(p.name)
            else:
                self.attr_defaults[p.name] = p.default
                self.param_order.append(p.name)
                self.param_default[p.name] = p.default

    def validate_attrs(self, attrs: dict) -> dict:
        """Reject unknown attributes loudly and coerce reference-style
        string values ("(3, 3)", "64", "True") to the declared type."""
        if self.allow_any_attr:
            return attrs
        out = None
        for k, v in attrs.items():
            if k not in self.attr_defaults:
                if k.startswith("__"):  # scope attrs (__lr_mult__ etc)
                    continue
                raise MXNetError(
                    f"operator {self.name!r} has no attribute {k!r}; "
                    f"valid attributes: {sorted(self.attr_defaults)} "
                    f"(array inputs: {self.input_names})")
            d = self.attr_defaults[k]
            if isinstance(v, str) and d is not None \
                    and not isinstance(d, str):
                try:
                    cv = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    raise MXNetError(
                        f"operator {self.name!r} attribute {k!r}: cannot "
                        f"parse {v!r} as {type(d).__name__}") from None
                if out is None:
                    out = dict(attrs)
                out[k] = cv
        return attrs if out is None else out

    @property
    def param_doc(self) -> str:
        lines = []
        if self.input_names:
            lines.append("Array inputs: " + ", ".join(self.input_names))
        if self.attr_defaults:
            lines.append("Attributes:")
            for k, d in self.attr_defaults.items():
                tname = type(d).__name__ if d is not None else "optional"
                lines.append(f"    {k} : {tname}, default {d!r}")
        return "\n".join(lines)

    def __repr__(self):
        return f"Op({self.name})"


_OPS: Dict[str, Operator] = {}

# MXNET_ENGINE_TYPE=NaiveEngine: every imperative op call synchronises
# its outputs' stream (at bulk-scope exit inside engine.bulk); read once,
# as the JAX package reads it
_NAIVE = env.get_str("MXNET_ENGINE_TYPE") == "NaiveEngine"

# The JAX package's op names the port does not register yet, under the
# ROADMAP queue A item that ports them.
_QUEUED_BY_ITEM = {
    "9": ("Custom",) + tuple(p + n for p in ("", "_contrib_") for n in (
        "AdaptiveAvgPooling2D", "BilinearResize2D", "MultiProposal",
        "PSROIPooling", "Proposal", "ROIAlign", "ROIPooling",
        "boolean_mask", "fft", "ifft")) + ("roi_pooling",)
    + tuple(p + n for p in ("", "_contrib_") for n in (
        "dequantize", "quantize", "quantize_v2", "quantized_conv",
        "quantized_flatten", "quantized_fully_connected",
        "quantized_pooling", "requantize"))
    + ("_contrib_quantized_act", "_contrib_quantized_concat",
       "_contrib_quantized_elemwise_add"),
}
QUEUED: Dict[str, str] = {n: item for item, names in _QUEUED_BY_ITEM.items()
                          for n in names}


def register_op(name: str, *, num_outputs=1, differentiable: bool = True,
                aliases: Sequence[str] = ()):
    """Decorator: register a function on tensors as a framework op."""

    def _wrap(fn: Callable) -> Callable:
        op = Operator(name, fn, num_outputs=num_outputs,
                      differentiable=differentiable)
        for n in (name,) + tuple(aliases):
            if n in _OPS:
                raise MXNetError(f"operator {n!r} already registered")
            _OPS[n] = op
        return fn

    return _wrap


def get_op(name: str) -> Operator:
    op = _OPS.get(name)
    if op is None:
        item = QUEUED.get(name)
        if item is None:
            raise MXNetError(f"operator {name!r} is not ported: neither "
                             "package registers an op of that name")
        raise MXNetError(
            f"operator {name!r} is not ported yet: ROADMAP queue A item "
            f"{item} ports it")
    return op


def list_ops() -> List[str]:
    return sorted(_OPS)


def invoke(op_name: str, *inputs, **attrs):
    """Imperative op call on NDArrays -> NDArray (a list for several
    outputs).  An optional array input passed by keyword (``bias=``)
    becomes positional, as in the JAX package."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray, wrap_outputs

    op = get_op(op_name)
    nd_kw = {k: v for k, v in attrs.items() if isinstance(v, NDArray)}
    if nd_kw:
        order = op.param_order
        unknown = [k for k in nd_kw if k not in order]
        if unknown:
            raise MXNetError(
                f"operator {op.name!r} has no input or attribute "
                f"{unknown[0]!r}; array inputs: {op.input_names}, "
                f"attributes: {sorted(op.attr_defaults)}")
        attrs = dict(attrs)
        last = max(order.index(k) for k in nd_kw)
        extra = []
        for name in order[len(inputs):last + 1]:
            if name in nd_kw:
                attrs.pop(name)
                extra.append(nd_kw[name])
            else:  # a gap: the declared default (e.g. bias=None)
                extra.append(attrs.pop(name, op.param_default.get(name)))
        inputs = tuple(inputs) + tuple(extra)
    tensors = [x._data if isinstance(x, NDArray) else x for x in inputs]
    attrs = op.validate_attrs(attrs)
    with torch.set_grad_enabled(op.differentiable
                                and autograd.is_recording()):
        out = op.fn(*tensors, **attrs)
    if _NAIVE:
        from .. import engine

        outs = out if isinstance(out, (tuple, list)) else (out,)
        if engine.in_bulk():
            engine._track(outs)
        else:
            engine._synchronize({t.device for t in outs
                                 if isinstance(t, torch.Tensor)
                                 and t.is_cuda})
    return wrap_outputs(out)
