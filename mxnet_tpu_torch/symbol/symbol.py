"""Symbol: MXNet's declarative graph (counterpart of
``mxnet_tpu/symbol/symbol.py``).

A Symbol is a list of heads into a DAG of ``_Node``s over the port's op
registry: a variable (op None) or an op applied to earlier nodes'
outputs.  As in the JAX package:

  * parameter variables are made by the op's schema (``SCHEMAS``):
    ``sym.FullyConnected(x, num_hidden=5, name="fc1")`` makes
    ``fc1_weight`` and ``fc1_bias``; BatchNorm's moving statistics are
    auxiliary states;
  * ``infer_shape`` runs both ways: the schema's rules give a
    parameter's shape from its data's, and each node's outputs come from
    running its op on ``meta`` tensors (shapes without data, the
    counterpart of ``jax.eval_shape``);
  * ``tojson`` writes the nnvm layout with the JAX package's text, byte
    for byte (nodes carry op, name, attrs as strings and inputs; the
    attrs in the order they were given), and ``load_json`` reads that
    layout, the legacy ``param``/``attr`` keys and JSON-spelled values,
    re-deriving output counts from the registry and aux-ness from the
    schemas.  Each package loads the other's files.

``bind``/``simple_bind`` make a :class:`~.executor.GraphExecutor`.
"""
from __future__ import annotations

import ast
import inspect
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..ops.registry import get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "SCHEMAS", "TRAIN_AWARE_OPS", "KEYED_OPS"]


class _Node:
    """One graph node: a variable (op None) or an op application."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "is_aux",
                 "shape_hint", "__weakref__")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]], num_outputs: int = 1,
                 is_aux: bool = False, shape_hint=None):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = num_outputs
        self.is_aux = is_aux
        self.shape_hint = tuple(shape_hint) if shape_hint else None


def _next_name(hint: str) -> str:
    from ..name import current

    return current().get(None, hint)


# ---------------------------------------------------------------------------
# op schemas: named inputs, aux inputs, parameter-shape rules
# ---------------------------------------------------------------------------

def _fc_shapes(ins, attrs):
    d = ins.get("data")
    if d is None:
        return {}
    in_dim = math.prod(d[1:]) if attrs.get("flatten", True) else d[-1]
    nh = attrs["num_hidden"]
    return {"weight": (nh, in_dim), "bias": (nh,)}


def _conv_shapes(ins, attrs):
    d = ins.get("data")
    if d is None:
        return {}
    nf = attrs["num_filter"]
    g = attrs.get("num_group", 1)
    return {"weight": (nf, d[1] // g) + tuple(attrs.get("kernel", ())),
            "bias": (nf,)}


def _deconv_shapes(ins, attrs):
    d = ins.get("data")
    if d is None:
        return {}
    nf = attrs["num_filter"]
    g = attrs.get("num_group", 1)
    return {"weight": (d[1], nf // g) + tuple(attrs.get("kernel", ())),
            "bias": (nf,)}


def _chan_shapes(ins, attrs):
    d = ins.get("data")
    if d is None:
        return {}
    c = (d[attrs.get("axis", 1)],)
    return {k: c for k in ("gamma", "beta", "moving_mean", "moving_var")}


def _lastdim_shapes(ins, attrs):
    d = ins.get("data")
    if d is None:
        return {}
    c = (d[attrs.get("axis", -1)],)
    return {"gamma": c, "beta": c}


def _embed_shapes(ins, attrs):
    return {"weight": (attrs["input_dim"], attrs["output_dim"])}


def _label_shapes(ins, attrs):
    d = ins.get("data")
    if d is None:
        return {}
    return {"label": tuple(d[:-1])}


def _rnn_shapes(ins, attrs):
    d = ins.get("data")  # (T, N, I)
    if d is None:
        return {}
    from ..ops.rnn import rnn_param_size

    if not attrs.get("state_size"):
        raise MXNetError("RNN requires a positive state_size attribute")
    return {"parameters": (rnn_param_size(
        attrs.get("mode", "lstm"), d[2], attrs["state_size"],
        attrs.get("num_layers", 1), attrs.get("bidirectional", False)),)}


class _Schema:
    def __init__(self, inputs: Sequence[str], aux: Sequence[str] = (),
                 optional: Sequence[str] = (), param_shapes=None):
        self.inputs = tuple(inputs)          # named graph inputs, in order
        self.aux = frozenset(aux)            # the ones that are aux states
        self.optional = frozenset(optional)  # skipped when absent (no_bias)
        self.param_shapes = param_shapes


# The JAX package's table.
SCHEMAS: Dict[str, _Schema] = {
    "FullyConnected": _Schema(("data", "weight", "bias"), optional=("bias",),
                              param_shapes=_fc_shapes),
    "Convolution": _Schema(("data", "weight", "bias"), optional=("bias",),
                           param_shapes=_conv_shapes),
    "Deconvolution": _Schema(("data", "weight", "bias"), optional=("bias",),
                             param_shapes=_deconv_shapes),
    "BatchNorm": _Schema(("data", "gamma", "beta", "moving_mean",
                          "moving_var"), aux=("moving_mean", "moving_var"),
                         param_shapes=_chan_shapes),
    "LayerNorm": _Schema(("data", "gamma", "beta"),
                         param_shapes=_lastdim_shapes),
    "InstanceNorm": _Schema(("data", "gamma", "beta"),
                            param_shapes=_chan_shapes),
    "GroupNorm": _Schema(("data", "gamma", "beta"),
                         param_shapes=_chan_shapes),
    "RMSNorm": _Schema(("data", "gamma"), param_shapes=_lastdim_shapes),
    "Embedding": _Schema(("data", "weight"), param_shapes=_embed_shapes),
    "Dropout": _Schema(("data",)),  # the generator comes from the executor
    "SoftmaxOutput": _Schema(("data", "label"), param_shapes=_label_shapes),
    "LeakyReLU": _Schema(("data", "gamma"), optional=("gamma",)),
    "RNN": _Schema(("data", "parameters", "state", "state_cell"),
                   optional=("state", "state_cell"),
                   param_shapes=_rnn_shapes),
}

# The JAX package's names for the ops that read the train flag and the
# ops that draw random numbers; the executor gives the port's ops
# ``train=`` and ``generator=`` (the JAX ops take ``_train`` and ``key``).
# The files never hold either.
TRAIN_AWARE_OPS = {"BatchNorm", "Dropout", "RNN"}
KEYED_OPS = {"Dropout", "RNN"}


def _is_sym(x) -> bool:
    return isinstance(x, Symbol)


def _str_attrs(node):
    """The one rule that turns attributes into text (list_attr,
    attr_dict, tojson)."""
    return {k: str(v) for k, v in node.attrs.items()}


def op_attrs(node) -> Dict[str, Any]:
    """The attributes a node passes to its op: without the scope
    attributes (``__key__``) and ``name``."""
    return {k: v for k, v in node.attrs.items()
            if not k.startswith("__") and k != "name"}


class Symbol:
    """An entry (or a group of entries) into the graph."""

    __slots__ = ("_heads",)

    def __init__(self, heads: List[Tuple[_Node, int]]):
        self._heads = heads

    # ---- identity --------------------------------------------------------
    @property
    def name(self) -> str:
        return self._heads[0][0].name if len(self._heads) == 1 else "group"

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __iter__(self):
        for i in range(len(self._heads)):
            yield self[i]

    def __len__(self):
        return len(self._heads)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            for i, nm in enumerate(self.list_outputs()):
                if nm == idx:
                    return Symbol([self._heads[i]])
            raise MXNetError(f"no output named {idx!r}")
        return Symbol([self._heads[idx]])

    def attr(self, key):
        return self._heads[0][0].attrs.get(key)

    def list_attr(self):
        """This node's attributes as strings."""
        return _str_attrs(self._heads[0][0])

    def attr_dict(self):
        """{node name: {attribute: value}} over the whole graph."""
        return {n.name: _str_attrs(n) for n in self._topo() if n.attrs}

    def debug_str(self):
        return "\n".join(
            f"{n.op or 'Variable'} {n.name}("
            + ", ".join(i.name for i, _ in n.inputs) + ")"
            for n in self._topo())

    # ---- traversal -------------------------------------------------------
    def _topo(self) -> List[_Node]:
        """Post-order DFS from the heads, inputs first (nnvm's DFSVisit
        order, which fixes the JSON's node order)."""
        seen = set()
        order: List[_Node] = []
        stack = [(n, False) for n, _ in reversed(self._heads)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            stack.extend((i, False) for i, _ in reversed(node.inputs)
                         if id(i) not in seen)
        return order

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo() if n.op is None and not n.is_aux]

    def list_outputs(self) -> List[str]:
        return [f"{n.name}_output" if n.num_outputs == 1
                else f"{n.name}_output{i}" for n, i in self._heads]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._topo() if n.op is None and n.is_aux]

    def get_internals(self) -> "Symbol":
        return Symbol([(n, i) for n in self._topo()
                       for i in range(n.num_outputs)])

    def get_children(self) -> Optional["Symbol"]:
        node = self._heads[0][0]
        return Symbol(list(node.inputs)) if node.inputs else None

    # ---- operators -------------------------------------------------------
    def _binary(self, scalar_op, elem_op, other, reverse=False):
        if _is_sym(other):
            a, b = (other, self) if reverse else (self, other)
            return _apply(elem_op, [a, b], {})
        return _apply(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binary("_plus_scalar", "broadcast_add", o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self._binary("_minus_scalar", "broadcast_sub", o)

    def __rsub__(self, o):
        if _is_sym(o):
            return self._binary(None, "broadcast_sub", o, reverse=True)
        return _apply("_rminus_scalar", [self], {"scalar": float(o)})

    def __mul__(self, o):
        return self._binary("_mul_scalar", "broadcast_mul", o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._binary("_div_scalar", "broadcast_div", o)

    def __rtruediv__(self, o):
        if _is_sym(o):
            return self._binary(None, "broadcast_div", o, reverse=True)
        return _apply("_rdiv_scalar", [self], {"scalar": float(o)})

    def __pow__(self, o):
        return self._binary("_power_scalar", "broadcast_power", o)

    def __neg__(self):
        return _apply("negative", [self], {})

    def reshape(self, shape):
        return _apply("reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _apply("transpose", [self],
                      {"axes": tuple(axes) if axes else None})

    def flatten(self):
        return _apply("flatten", [self], {})

    def sum(self, axis=None, keepdims=False):
        return _apply("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _apply("mean", [self], {"axis": axis, "keepdims": keepdims})

    def softmax(self, axis=-1):
        return _apply("softmax", [self], {"axis": axis})

    # ---- shapes and types ------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes); raises while an argument
        or an output stays unknown."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for what stays unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {n: tuple(s) for n, s in zip(arg_names, args)
                 if s is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()})
        shapes: Dict[Tuple[int, int], Optional[Tuple[int, ...]]] = {}
        var_shapes: Dict[str, Optional[Tuple[int, ...]]] = {}
        for node in self._topo():
            if node.op is None:
                shp = known.get(node.name) or node.shape_hint
                var_shapes[node.name] = tuple(shp) if shp else None
                shapes[(id(node), 0)] = var_shapes[node.name]
                continue
            schema = SCHEMAS.get(node.op)
            if schema and schema.param_shapes:
                named = {nm: shapes.get((id(i), ix)) for (i, ix), nm
                         in zip(node.inputs, schema.inputs)}
                rules = schema.param_shapes(named, node.attrs)
                for (inp, ix), nm in zip(node.inputs, schema.inputs):
                    if inp.op is None and shapes.get((id(inp), ix)) is None \
                            and nm in rules:
                        var_shapes[inp.name] = tuple(rules[nm])
                        shapes[(id(inp), ix)] = var_shapes[inp.name]
            in_shapes = [shapes.get((id(i), ix)) for i, ix in node.inputs]
            if node.op == "Custom":
                in_shapes, outs = _custom_node_shapes(node, in_shapes)
                for (inp, ix), shp in zip(node.inputs, in_shapes):
                    if inp.op is None and shp is not None \
                            and shapes.get((id(inp), ix)) is None:
                        var_shapes[inp.name] = tuple(shp)
                        shapes[(id(inp), ix)] = var_shapes[inp.name]
            elif any(s is None for s in in_shapes):
                outs = [None] * node.num_outputs
            else:
                outs = _eval_node_shape(node, in_shapes)
            for i in range(node.num_outputs):
                shapes[(id(node), i)] = outs[i]
        arg_shapes = [var_shapes.get(n) for n in arg_names]
        aux_shapes = [var_shapes.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [shapes.get((id(n), i)) for n, i in self._heads]
        if not partial:
            missing = [n for n, s in zip(arg_names, arg_shapes) if s is None]
            if missing or any(s is None for s in out_shapes):
                raise MXNetError(
                    f"infer_shape incomplete; unknown arguments: {missing}. "
                    f"Provide their shapes explicitly.")
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """float32 for every argument, output and aux state, as in the
        JAX package; a ``Custom`` node's outputs take the types its
        prop's ``infer_type`` gives."""
        from ..operator import make_prop

        f32 = np.float32
        types: Dict[Tuple[int, int], Any] = {}
        for node in self._topo():
            if node.op == "Custom":
                _, outs, _ = make_prop(op_attrs(node)).infer_type(
                    [types[(id(i), ix)] for i, ix in node.inputs])
            else:
                outs = [f32] * node.num_outputs
            for i, t in enumerate(outs):
                types[(id(node), i)] = t
        return ([f32] * len(self.list_arguments()),
                [types[(id(n), i)] for n, i in self._heads],
                [f32] * len(self.list_auxiliary_states()))

    # ---- serialization ---------------------------------------------------
    def tojson(self) -> str:
        """The reference's nnvm JSON: nodes carry only op, name, attrs (as
        strings, a variable's shape hint as ``__shape__``) and inputs."""
        topo = self._topo()
        index = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for n in topo:
            attrs = _str_attrs(n)
            if n.op is None and n.shape_hint:
                attrs["__shape__"] = str(tuple(n.shape_hint))
            spec = {"op": "null" if n.op is None else n.op, "name": n.name,
                    "inputs": [[index[id(i)], ix, 0] for i, ix in n.inputs]}
            if attrs:
                spec["attrs"] = attrs
            nodes.append(spec)
        row_ptr = [0]
        for n in topo:
            row_ptr.append(row_ptr[-1] + n.num_outputs)
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(topo) if n.op is None],
            "node_row_ptr": row_ptr,
            "heads": [[index[id(n)], i, 0] for n, i in self._heads],
            "attrs": {"mxnet_version": ["int", 10700]},
        }, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ---- execution -------------------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        from .executor import GraphExecutor

        return GraphExecutor(self, ctx, args, args_grad=args_grad,
                             grad_req=grad_req, aux_states=aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    **shape_kwargs):
        from .executor import GraphExecutor

        return GraphExecutor.simple_bind(self, ctx, grad_req=grad_req,
                                         **shape_kwargs)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` on ``ctx`` (default gpu(0)) and run forward."""
        from ..context import resolve

        return self.bind(resolve(ctx), kwargs).forward()


def _custom_node_shapes(node: _Node, in_shapes):
    """A ``Custom`` node's (input shapes, output shapes) from its prop's
    ``infer_shape``, which may also give the shapes of inputs not known
    yet (a label's from the data's); the user's code never runs on
    ``meta`` tensors.  Unknown stays None."""
    from ..operator import make_prop

    prop = make_prop(op_attrs(node))
    unknown = [None] * node.num_outputs
    if in_shapes and in_shapes[0] is None:
        return in_shapes, unknown
    arg = [None if s is None else list(s) for s in in_shapes]
    if any(s is None for s in in_shapes):
        try:
            ins, outs, _ = prop.infer_shape(arg)
        except (TypeError, IndexError):
            return in_shapes, unknown
    else:
        ins, outs, _ = prop.infer_shape(arg)
    ins = [tuple(s) if s is not None else None for s in ins]
    return ins, [tuple(s) for s in outs]


def _eval_node_shape(node: _Node, in_shapes):
    """The node's output shapes: its op run on fp32 ``meta`` tensors."""
    op = get_op(node.op)
    metas = [torch.empty(s, dtype=torch.float32, device="meta")
             for s in in_shapes]
    with torch.no_grad():
        out = op.fn(*metas, **op_attrs(node))
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [tuple(o.shape) for o in outs]


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def _scope_attrs(user_attr: Optional[Dict[str, str]] = None):
    """The active AttrScope's attributes merged with ``user_attr``, as
    ``__key__`` node attributes."""
    from ..attribute import current

    return {f"__{k}__": v for k, v in current().get(user_attr).items()}


def _heads_of(node: _Node) -> Symbol:
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _apply(op_name: str, input_syms: List[Symbol], attrs: Dict[str, Any],
           name: Optional[str] = None) -> Symbol:
    op = get_op(op_name)
    name = name or _next_name(op_name.lower().lstrip("_"))
    attrs = {**attrs, **_scope_attrs()}
    heads = []
    for s in input_syms:
        if len(s._heads) != 1:
            raise MXNetError(
                f"op {op_name} input must be single-output, got group")
        heads.append(s._heads[0])
    return _heads_of(_Node(op_name, name, attrs, heads,
                           num_outputs=op.nout(attrs)))


def _custom_inputs(node_name, args, kwargs):
    """A ``Custom`` node's inputs and attributes: positional Symbols, then
    Symbols by keyword in the order of the prop's ``list_arguments``; an
    argument not given is made as the variable ``<node>_<argument>``
    (the reference's ``softmax_label``)."""
    from ..operator import make_prop

    for a in args:
        if not _is_sym(a):
            raise TypeError(f"Custom: attributes must be passed by keyword "
                            f"(got positional {a!r})")
    named = {k: kwargs.pop(k) for k in list(kwargs) if _is_sym(kwargs[k])}
    attrs = dict(kwargs)
    arg_names = make_prop(attrs).list_arguments()
    inputs = list(args)
    for nm in arg_names[len(inputs):]:
        inputs.append(named.pop(nm) if nm in named else Symbol(
            [(_Node(None, f"{node_name}_{nm}", {}, []), 0)]))
    if named:
        raise MXNetError(f"Custom {attrs.get('op_type')!r}: no argument "
                         f"{sorted(named)} in {arg_names}")
    return inputs, attrs


def make_symbol_function(op_name: str):
    """The ``sym.<op>`` function of a registered op: Symbols are graph
    inputs (a schema's missing parameters are made as variables named
    ``<node>_<input>``), everything else is an attribute."""
    op = get_op(op_name)
    schema = SCHEMAS.get(op.name)
    try:
        sig_params = list(inspect.signature(op.fn).parameters)
    except (TypeError, ValueError):
        sig_params = []

    def fn(*args, name: Optional[str] = None, attr=None, **kwargs):
        node_name = name or _next_name(op.name.lower().lstrip("_"))
        if op.name == "Custom":
            sym_inputs, attrs = _custom_inputs(node_name, args, kwargs)
        elif schema is not None:
            pos = []
            for a in args:
                if not _is_sym(a):
                    raise TypeError(
                        f"{op.name}: scalar/tuple parameters must be passed "
                        f"by keyword (got positional {a!r})")
                pos.append(a)
            named = dict(zip(schema.inputs, pos))
            for k in list(kwargs):
                if _is_sym(kwargs[k]) and k in schema.inputs:
                    named[k] = kwargs.pop(k)
            attrs = {k: v for k, v in kwargs.items() if not _is_sym(v)}

            def wanted(nm: str) -> bool:
                # an optional input is made only when the op will use it
                if nm not in schema.optional:
                    return True
                if nm == "bias":
                    return not attrs.get("no_bias", False)
                if op.name == "LeakyReLU" and nm == "gamma":
                    return attrs.get("act_type", "leaky") == "prelu"
                return False

            sym_inputs, skipped = [], []
            for nm in schema.inputs:
                if nm in named or wanted(nm):
                    if skipped:
                        # inputs bind by position: a later input after an
                        # omitted optional one would land in its slot
                        raise MXNetError(
                            f"{op.name}: input {nm!r} follows omitted "
                            f"optional input(s) {skipped}; pass them "
                            f"explicitly")
                    sym_inputs.append(named[nm] if nm in named else Symbol(
                        [(_Node(None, f"{node_name}_{nm}", {}, [],
                                is_aux=nm in schema.aux), 0)]))
                else:
                    skipped.append(nm)
        else:
            # positional Symbols are inputs in order; a positional scalar
            # is the attribute of its parameter (sym.expand_dims(x, 1))
            pos, attrs, slot = [], {}, {}
            for i, a in enumerate(args):
                if _is_sym(a):
                    pos.append(a)
                elif i < len(sig_params):
                    attrs[sig_params[i]] = a
                else:
                    raise TypeError(f"{op.name}: too many positional "
                                    f"arguments")
            for k in list(kwargs):
                if _is_sym(kwargs[k]):
                    slot[k] = kwargs.pop(k)
            attrs.update(kwargs)
            sym_inputs = pos + [slot[p] for p in sig_params if p in slot]
        heads = []
        for s in sym_inputs:
            if len(s._heads) != 1:
                raise MXNetError(
                    f"{op.name}: group symbol not allowed as input")
            heads.append(s._heads[0])
        # a mistyped attribute fails when the graph is made, not bound
        attrs = op.validate_attrs(attrs)
        node = _Node(op.name, node_name, attrs, heads,
                     num_outputs=op.nout(attrs))
        node.attrs.update(_scope_attrs(attr))
        return _heads_of(node)

    fn.__name__ = fn.__qualname__ = op_name
    fn.__doc__ = (f"Symbolic wrapper for registered op '{op_name}'.\n\n"
                  f"{op.param_doc}")
    return fn


# ---------------------------------------------------------------------------
# constructors and loading
# ---------------------------------------------------------------------------

def var(name: str, shape=None, init=None, attr=None, dtype=None,
        lr_mult=None, wd_mult=None, stype=None) -> Symbol:
    """A variable; ``init``, ``lr_mult`` and ``wd_mult`` become its
    ``__init__``, ``__lr_mult__`` and ``__wd_mult__`` attributes."""
    attrs = _scope_attrs(attr)
    for key, v in (("__init__", init), ("__lr_mult__", lr_mult),
                   ("__wd_mult__", wd_mult)):
        if v is not None:
            attrs[key] = str(v)
    return Symbol([(_Node(None, name, attrs, [], shape_hint=shape), 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol([h for s in symbols for h in s._heads])


_JSON_LITERALS = {"true": True, "false": False, "null": None}


def _tuplify(x):
    return tuple(_tuplify(i) for i in x) if isinstance(x, list) else x


def _parse_attr_value(v):
    """A reference attribute string ("(3, 3)", "64", "True", "relu") as a
    Python literal, else the string; JSON spellings ("false", "[3, 3]")
    are read too.  Lists become tuples."""
    if not isinstance(v, str):
        return v
    if v in _JSON_LITERALS:
        return _JSON_LITERALS[v]
    try:
        return _tuplify(ast.literal_eval(v))
    except (ValueError, SyntaxError):
        return v


def load_json(json_str: str) -> Symbol:
    """A Symbol from the nnvm JSON layout (``tojson``'s, the reference's,
    and the older one with ``param``/``attr`` keys, 2-long input entries
    and a top-level ``shape_hint``).  An op the port does not register
    still loads, for inspection; binding it fails."""
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for spec in data["nodes"]:
        raw: Dict[str, Any] = {}
        for key in ("param", "attr", "attrs"):
            raw.update(spec.get(key) or {})
        attrs = {k: _parse_attr_value(v) for k, v in raw.items()}
        if spec["op"] == "null":
            hint = attrs.pop("__shape__", None) or spec.get("shape_hint")
            node = _Node(None, spec["name"], attrs, [], shape_hint=hint)
        else:
            inputs = [(nodes[e[0]], e[1]) for e in spec["inputs"]]
            try:
                nout = get_op(spec["op"]).nout(attrs)
            except MXNetError:  # not registered: loads for inspection
                nout = 1
            node = _Node(spec["op"], spec["name"], attrs, inputs,
                         num_outputs=nout)
        nodes.append(node)
    # a variable in a schema's aux slot is an auxiliary state
    for node in nodes:
        schema = SCHEMAS.get(node.op) if node.op else None
        if schema is None or not schema.aux:
            continue
        for (inp, _), nm in zip(node.inputs, schema.inputs):
            if nm in schema.aux and inp.op is None:
                inp.is_aux = True
    return Symbol([(nodes[e[0]], e[1]) for e in data["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())
