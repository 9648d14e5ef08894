"""Foundations of the port: the framework error type, env parsing and
dtype names.

Counterpart of ``mxnet_tpu/base.py``; the port keeps its own copy so
that it never imports the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["MXNetError", "get_env", "convert_env", "dtype_of", "np_dtype",
           "numeric_types", "integer_types"]

integer_types = (int, np.integer)
numeric_types = (float, int, np.generic)


class MXNetError(RuntimeError):
    """Framework error type (ref: python/mxnet/base.py::MXNetError)."""


_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


def convert_env(name: str, raw: str, typ: type) -> Any:
    """Parse an env-var string: truthy/falsy spellings for bools, any
    integer for a bool as its truth value, ``typ(raw)`` otherwise."""
    if typ is bool:
        low = raw.strip().lower()
        if low in _TRUTHY:
            return True
        if low in _FALSY:
            return False
        try:
            return bool(int(low))
        except ValueError:
            pass
        raise MXNetError(f"env var {name}={raw!r} is not a boolean")
    try:
        return typ(raw)
    except ValueError as e:
        raise MXNetError(f"env var {name}={raw!r} is not a {typ.__name__}") from e


def get_env(name: str, default: Any = None, typ: Optional[type] = None) -> Any:
    """Typed env-var lookup; an empty string means unset."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if typ is None:
        typ = type(default) if default is not None else str
    return convert_env(name, raw, typ)


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
           "int64": torch.int64, "bool": torch.bool}
_NP_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_of(dtype) -> torch.dtype:
    """A dtype name ('bfloat16'), a numpy dtype or type (ml_dtypes'
    bfloat16 included) or a torch.dtype -> torch.dtype; None is
    float32, MXNet's default."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    try:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    except TypeError:
        name = None
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def np_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype: ml_dtypes' bfloat16 for bf16,
    as the JAX package's arrays report it, or the name 'bfloat16' where
    ml_dtypes is not installed."""
    if dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return "bfloat16"
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(_NP_NAMES[dtype])
