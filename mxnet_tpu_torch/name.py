"""Automatic names of symbol nodes (counterpart of ``mxnet_tpu/name.py``):
the active ``NameManager`` names a node ``<hint><n>`` when it has no
name, counting per hint; ``Prefix`` prepends a fixed prefix.  Managers
nest with ``with`` and are per thread."""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    _state = threading.local()

    def __init__(self):
        self._counter: Dict[str, int] = {}
        self._old: Optional["NameManager"] = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old = current()
        NameManager._state.mgr = self
        return self

    def __exit__(self, *exc):
        NameManager._state.mgr = self._old
        return False


class Prefix(NameManager):
    """Prepend ``prefix`` to every automatic name."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current() -> NameManager:
    mgr = getattr(NameManager._state, "mgr", None)
    if mgr is None:
        mgr = NameManager._state.mgr = NameManager()
    return mgr
