"""``mx.contrib.ndarray`` and ``mx.nd.contrib`` (counterpart of
``mxnet_tpu/contrib/ndarray.py``): the registry's ops under their contrib
names, ``nd.contrib.X`` trying ``_contrib_X`` first and then ``X``, and
the control flow of ``contrib/control_flow.py`` (``cond``, ``foreach``,
``while_loop``)."""
from __future__ import annotations

from ..ndarray import register as _register
from .control_flow import cond, foreach, while_loop

__all__ = ["cond", "foreach", "while_loop"]


def __getattr__(name):
    # the contrib name first, so that a contrib op and a plain op of one
    # name resolve to the contrib one in every contrib namespace
    for cand in (f"_contrib_{name}", name):
        try:
            return _register.lookup(cand)
        except AttributeError:
            continue
    raise AttributeError(
        f"no contrib op {name!r} (tried '_contrib_{name}' too)")
