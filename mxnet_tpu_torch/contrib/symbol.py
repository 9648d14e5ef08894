"""``mx.contrib.symbol`` and ``mx.sym.contrib`` (counterpart of
``mxnet_tpu/contrib/symbol.py``): symbol functions of the registry's ops
under their contrib names, ``_contrib_X`` tried first, then ``X``."""
from __future__ import annotations

import threading

from ..base import MXNetError
from ..ops.registry import get_op
from ..symbol.symbol import make_symbol_function

_CACHE = {}
_CACHE_LOCK = threading.Lock()  # module attributes resolve from any thread


def __getattr__(name):
    fn = _CACHE.get(name)
    if fn is not None:
        return fn
    for cand in (f"_contrib_{name}", name):
        try:
            get_op(cand)
        except MXNetError:
            continue
        with _CACHE_LOCK:
            return _CACHE.setdefault(name, make_symbol_function(cand))
    raise AttributeError(
        f"no contrib symbol op {name!r} (tried '_contrib_{name}' too)")
