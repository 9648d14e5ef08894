"""``mx.contrib.ndarray`` and ``mx.nd.contrib`` (counterpart of
``mxnet_tpu/contrib/ndarray.py``): the registry's ops under their contrib
names, ``nd.contrib.X`` trying ``_contrib_X`` first and then ``X``.

``cond``, ``foreach`` and ``while_loop`` (``contrib/control_flow.py`` in
the JAX package) are not ported yet: they raise, naming their ROADMAP
item."""
from __future__ import annotations

from ..base import MXNetError
from ..ndarray import register as _register

__all__ = ["cond", "foreach", "while_loop"]


def _queued(name):
    def fn(*args, **kwargs):
        raise MXNetError(
            f"contrib.{name} is not ported yet: ROADMAP queue A item 9 "
            "(cut (c), contrib/control_flow.py) ports it")

    fn.__name__ = fn.__qualname__ = name
    return fn


cond = _queued("cond")
foreach = _queued("foreach")
while_loop = _queued("while_loop")


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
