"""Control flow: ``foreach``, ``while_loop`` and ``cond`` (counterpart of
``mxnet_tpu/contrib/control_flow.py``; ref: mx.nd.contrib.foreach,
while_loop, cond).

The JAX package lowers each to ``lax.scan``/``lax.while_loop``/
``lax.cond`` outside recording and inside a trace.  In the port each is a
Python loop (or branch) over the body's ops, in every regime:

* under ``autograd.record()`` the body's ops are recorded, so gradients
  flow through the loop;
* inside a compiled site (a hybridized block, a bound symbol,
  ``SPMDTrainer``'s step) ``foreach`` unrolls into the capture: its trip
  count is the data's static length, and a keyed op in the body (Dropout)
  draws from the generator registered with the graph, so each replay
  draws fresh masks;
* ``while_loop`` and ``cond`` decide on the host: a predicate that is an
  NDArray or a tensor is read (one device-to-host copy a decision), which
  a replay cannot repeat, so they say so (``_graphs.note_host_python``)
  and a compiled site that runs them runs eagerly.  A Python bool needs
  no read.

The functions take NDArrays (``nd.contrib``) or tensors (``F.contrib`` in
a ``hybrid_forward``), and each of ``data``, ``states``, ``loop_vars`` and
the outputs may be a list or a single array.  ``while_loop`` needs
``max_iterations``: its outputs are stacked and padded with zeros to that
many rows; when the condition is false on entry, one probe call of
``func`` gives the outputs' shapes (zero-filled) and the loop variables
come back unchanged.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from .. import _graphs
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x) -> Tuple[List, bool]:
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _unlist(xs: List, was_list: bool):
    return list(xs) if was_list else xs[0]


def _row(d, i):
    """Row ``i`` of ``d`` along axis 0 (recorded under ``record()``)."""
    if isinstance(d, NDArray):
        return d.slice_axis(0, i, i + 1).reshape(d.shape[1:])
    return d[i]


def _stack(rows):
    if isinstance(rows[0], NDArray):
        from .. import nd

        return nd.stack(*rows, axis=0)
    return torch.stack(rows, 0)


def _zeros(shape, like):
    """Zeros of ``shape`` with ``like``'s dtype and device (and kind)."""
    t = like._data if isinstance(like, NDArray) else like
    z = torch.zeros(tuple(shape), dtype=t.dtype, device=t.device)
    return NDArray(z) if isinstance(like, NDArray) else z


def _pad_rows(rows, n):
    """``rows`` padded with zero rows to ``n``."""
    pad = _zeros((n - rows.shape[0],) + tuple(rows.shape[1:]), rows)
    if isinstance(rows, NDArray):
        from .. import nd

        return nd.concat(rows, pad, dim=0)
    return torch.cat([rows, pad], 0)


def _truth(p) -> bool:
    """A predicate as a Python bool: an NDArray or a tensor is read on
    the host (a decision a replay cannot repeat)."""
    if isinstance(p, NDArray):
        p = p._data
    if isinstance(p, torch.Tensor):
        _graphs.note_host_python()
        return bool(p.reshape(()))
    return bool(p)


def foreach(body: Callable, data, init_states):
    """Iterate ``body(data_slice, states) -> (outputs, new_states)`` over
    axis 0 of ``data``; returns (stacked outputs, final states)."""
    data_l, data_is_list = _as_list(data)
    states_l, states_is_list = _as_list(init_states)
    if not data_l:
        raise MXNetError("foreach: data must contain at least one array")
    length = data_l[0].shape[0]
    for d in data_l:
        if d.shape[0] != length:
            raise MXNetError("foreach: all data arrays must share axis-0 "
                             f"length (got {d.shape[0]} vs {length})")
    if length == 0:
        # no step runs: one probe of the body gives the outputs' shapes
        probe, _ = body(_unlist([_zeros(d.shape[1:], d) for d in data_l],
                                data_is_list),
                        _unlist(states_l, states_is_list))
        probe_l, o_is_list = _as_list(probe)
        return (_unlist([_zeros((0,) + tuple(p.shape), p) for p in probe_l],
                        o_is_list),
                _unlist(states_l, states_is_list))
    steps: List[List] = []
    states = states_l
    o_is_list = False
    for i in range(length):
        o, states = body(_unlist([_row(d, i) for d in data_l], data_is_list),
                         _unlist(states, states_is_list))
        states, _ = _as_list(states)
        o_l, o_is_list = _as_list(o)
        steps.append(o_l)
    stacked = [_stack([step[j] for step in steps])
               for j in range(len(steps[0]))]
    return _unlist(stacked, o_is_list), _unlist(states, states_is_list)


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int = None):
    """``while cond_fn(*loop_vars): outputs, loop_vars =
    func(*loop_vars)``, at most ``max_iterations`` times.  Returns
    (outputs stacked and padded with zeros to ``max_iterations`` rows,
    final loop_vars)."""
    lv, lv_is_list = _as_list(loop_vars)
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (the outputs "
                         "are padded to that many rows)")
    steps: List[List] = []
    o_is_list = False
    while len(steps) < max_iterations and _truth(cond_fn(*lv)):
        o, new_lv = func(*lv)
        lv, _ = _as_list(new_lv)
        o_l, o_is_list = _as_list(o)
        steps.append(o_l)
    if not steps:
        # false on entry: zero-filled buffers shaped by one probe call
        probe, _ = func(*lv)
        probe_l, o_is_list = _as_list(probe)
        return (_unlist([_zeros((max_iterations,) + tuple(p.shape), p)
                         for p in probe_l], o_is_list),
                _unlist(lv, lv_is_list))
    stacked = []
    for j in range(len(steps[0])):
        rows = _stack([step[j] for step in steps])
        if len(steps) < max_iterations:
            rows = _pad_rows(rows, max_iterations)
        stacked.append(rows)
    return _unlist(stacked, o_is_list), _unlist(lv, lv_is_list)


def cond(pred, then_func: Callable, else_func: Callable):
    """``then_func()`` if ``pred`` else ``else_func()``."""
    return then_func() if _truth(pred) else else_func()
