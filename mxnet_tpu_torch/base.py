"""Foundations of the port: the framework error type and env parsing.

Counterpart of ``mxnet_tpu/base.py``; the port keeps its own copy so
that it never imports the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Optional

__all__ = ["MXNetError", "get_env", "convert_env"]


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
