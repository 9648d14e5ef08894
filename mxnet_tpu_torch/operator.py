"""User-defined operators: ``CustomOp``, ``CustomOpProp``, ``register``
(counterpart of ``mxnet_tpu/operator.py``; ref: python/mxnet/operator.py).

The user's Python runs as the ``Custom`` op (``ops/custom.py``) with the
reference's contract: ``in_data``, ``out_data``, ``out_grad`` and
``in_grad`` are NDArrays on the op's device, so user code may compute
with ``nd`` ops on the card or read them with ``.asnumpy()`` and
``assign`` a numpy array back.  One operator instance is created for
each forward call, and that call's backward runs on the same instance,
so state stashed on ``self`` in the forward (a mask) reaches its own
backward.  A compiled site (a hybridized block, a bound symbol,
``SPMDTrainer``'s step) whose function runs a ``Custom`` op runs it
eagerly on every call instead of replaying a capture (``_graphs``)::

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + mx.nd.exp(-in_data[0]))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @mx.operator.register("sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    y = mx.nd.Custom(x, op_type="sigmoid")
"""
from __future__ import annotations

from typing import Dict, List, Type

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]


class CustomOp:
    """Base class for the user's forward and backward."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError(
            "this CustomOp does not implement backward")

    @staticmethod
    def assign(dst, req, src):
        """Honour the write/add/null request."""
        if req in ("null", None):
            return
        if req == "add":
            dst += src
        else:  # write / inplace
            dst[:] = src


class CustomOpProp:
    """Shapes, types and the operator factory of a custom op."""

    def __init__(self, need_top_grad: bool = True, **kwargs):
        self.need_top_grad_ = need_top_grad
        self.kwargs = kwargs

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        return list(out_grad) + list(in_data) + list(out_data)

    def create_operator(self, ctx, shapes, dtypes):
        raise NotImplementedError


_PROPS: Dict[str, Type[CustomOpProp]] = {}


def register(op_type: str):
    """Decorator registering a CustomOpProp under ``op_type``."""

    def _wrap(cls: Type[CustomOpProp]) -> Type[CustomOpProp]:
        if not (isinstance(cls, type) and issubclass(cls, CustomOpProp)):
            raise MXNetError(
                f"@operator.register expects a CustomOpProp subclass, "
                f"got {cls!r}")
        _PROPS[op_type] = cls
        return cls

    return _wrap


def get_prop(op_type: str) -> Type[CustomOpProp]:
    if op_type not in _PROPS:
        raise MXNetError(
            f"unknown custom op_type {op_type!r}; registered: "
            f"{sorted(_PROPS)}")
    return _PROPS[op_type]


def make_prop(attrs: dict) -> CustomOpProp:
    """The prop of a ``Custom`` node or call from its attributes
    (``op_type`` and the prop's own keyword arguments)."""
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("nd.Custom requires op_type=")
    kw = {k: v for k, v in attrs.items()
          if k not in ("op_type", "_train") and not k.startswith("__")}
    return get_prop(op_type)(**kw)
