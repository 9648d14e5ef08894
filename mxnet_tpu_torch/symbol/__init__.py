"""mxnet_tpu_torch.symbol (``sym``): the declarative API (counterpart of
``mxnet_tpu/symbol/__init__.py``).  ``sym.<Op>`` is generated from the op
registry on first use (``symbol.make_symbol_function``); ``zeros``,
``ones`` and the binary functions that take a Symbol or a scalar on
either side (``maximum``, ``power``, ...) are written here."""
from __future__ import annotations

import threading as _threading

from .executor import GraphExecutor, executor_stats
from .symbol import Group, Symbol, Variable, load, load_json, var

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "GraphExecutor", "executor_stats", "zeros", "ones", "maximum",
           "minimum", "power", "modulo", "logical_and", "logical_or",
           "logical_xor"]

_CACHE = {}
_CACHE_LOCK = _threading.Lock()


def zeros(shape, dtype="float32", name=None):
    from .symbol import _next_name

    return __getattr__("zeros_like")(var(name or _next_name("zeros"),
                                         shape=shape))


def ones(shape, dtype="float32", name=None):
    from .symbol import _next_name

    return __getattr__("ones_like")(var(name or _next_name("ones"),
                                        shape=shape))


def _scalar_or_elemwise(broadcast_op, scalar_op, rscalar_op=None):
    """A binary function of two Symbols (``broadcast_op``) or a Symbol
    and a scalar (``scalar_op``; ``rscalar_op`` for a scalar on the left
    of a function that does not commute)."""
    def fn(lhs, rhs):
        if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
            return __getattr__(broadcast_op)(lhs, rhs)
        if isinstance(lhs, Symbol):
            return __getattr__(scalar_op)(lhs, scalar=float(rhs))
        if isinstance(rhs, Symbol):
            return __getattr__(rscalar_op or scalar_op)(
                rhs, scalar=float(lhs))
        raise TypeError("at least one operand must be a Symbol")
    return fn


maximum = _scalar_or_elemwise("broadcast_maximum", "_maximum_scalar")
minimum = _scalar_or_elemwise("broadcast_minimum", "_minimum_scalar")
power = _scalar_or_elemwise("broadcast_power", "_power_scalar",
                            "_rpower_scalar")
modulo = _scalar_or_elemwise("broadcast_mod", "_mod_scalar", "_rmod_scalar")
logical_and = _scalar_or_elemwise("broadcast_logical_and",
                                  "_logical_and_scalar")
logical_or = _scalar_or_elemwise("broadcast_logical_or",
                                 "_logical_or_scalar")
logical_xor = _scalar_or_elemwise("broadcast_logical_xor",
                                  "_logical_xor_scalar")


def __getattr__(name):
    from ..base import MXNetError
    from ..ops.registry import get_op
    from .symbol import make_symbol_function

    if name == "contrib":  # sym.contrib is mx.contrib.symbol
        import importlib

        mod = importlib.import_module("..contrib.symbol", __name__)
        globals()["contrib"] = mod
        return mod
    fn = _CACHE.get(name)
    if fn is not None:
        return fn
    try:
        get_op(name)
    except MXNetError:
        raise AttributeError(f"module 'mxnet_tpu_torch.symbol' has no "
                             f"attribute {name!r}") from None
    with _CACHE_LOCK:
        return _CACHE.setdefault(name, make_symbol_function(name))
