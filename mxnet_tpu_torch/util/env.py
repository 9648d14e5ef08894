"""The ``MXNET_*`` environment knobs this slice of the port reads.

Counterpart of ``mxnet_tpu/util/env.py``: the same names, defaults and
semantics, declared once and read through typed accessors.  Reading an
undeclared knob raises.  Only the knobs the port reads are declared.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

from ..base import MXNetError
from ..base import get_env as _raw_get_env

__all__ = ["Knob", "declare", "get_bool", "get_float"]


class Knob(NamedTuple):
    name: str
    typ: type
    default: Any
    doc: str


_KNOBS: Dict[str, Knob] = {}
_UNSET = object()


def declare(name: str, typ: type, default: Any, doc: str) -> Knob:
    if not name.startswith("MXNET_"):
        raise MXNetError(f"env knob {name!r} must use the MXNET_ prefix")
    if name in _KNOBS:
        raise MXNetError(f"env knob {name} already registered")
    _KNOBS[name] = k = Knob(name, typ, default, doc)
    return k


def _get(name: str, typ: type, default: Any) -> Any:
    knob = _KNOBS.get(name)
    if knob is None:
        raise MXNetError(f"unregistered env knob {name!r}; known: "
                         f"{sorted(_KNOBS)}")
    if knob.typ is not typ:
        raise MXNetError(f"env knob {name} is declared as "
                         f"{knob.typ.__name__}, read as {typ.__name__}")
    return _raw_get_env(name, knob.default if default is _UNSET else default,
                        typ)


def get_bool(name: str, default: Any = _UNSET):
    return _get(name, bool, default)


def get_float(name: str, default: Any = _UNSET):
    return _get(name, float, default)


declare("MXNET_BN_EXACT_VAR", bool, False,
        "BatchNorm uses the exact two-pass variance instead of the "
        "single-pass shifted estimator; also disables the fused Conv+BN "
        "path (whose statistics are inherently single-pass).")
declare("MXNET_FUSED_CONVBN", bool, False,
        "Route ResNet V1 residual blocks through the fused Conv+BN+ReLU "
        "CUDA kernel when running hybridized in NHWC layout.")
declare("MXNET_DRAIN_TIMEOUT_MS", float, 30000.0,
        "Hard deadline for InferenceServer.shutdown(drain=True): past "
        "it, still-queued requests fail with ServerClosed instead of "
        "the shutdown hanging forever on a wedged batch.")
