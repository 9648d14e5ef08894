"""Scoped symbol attributes (counterpart of ``mxnet_tpu/attribute.py``):
``with AttrScope(ctx_group="dev1"):`` attaches string attributes to the
symbols made inside it, stored on the node as ``__key__``.  Scopes nest
(the inner one's keys win) and are per thread."""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current"]


class AttrScope:
    _state = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = dict(kwargs)
        self._old: Optional["AttrScope"] = None
        self._effective: Optional[Dict[str, str]] = None

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        """This scope's attributes (with the enclosing ones' inside a
        ``with``) updated by ``attr``."""
        ret = dict(self._effective if self._effective is not None
                   else self._attr)
        if attr:
            ret.update(attr)
        return ret

    def __enter__(self):
        self._old = current()
        self._effective = self._old.get(self._attr)
        AttrScope._state.scope = self
        return self

    def __exit__(self, *exc):
        AttrScope._state.scope = self._old
        self._effective = None
        return False


def current() -> AttrScope:
    scope = getattr(AttrScope._state, "scope", None)
    if scope is None:
        scope = AttrScope._state.scope = AttrScope()
    return scope
