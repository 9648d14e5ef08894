"""Autograd over ``torch.autograd`` (counterpart of
``mxnet_tpu/autograd.py``).

``record()``/``pause()``/``train_mode()``/``predict_mode()`` set two
thread-local flags, as in the JAX package: *recording* (ops run with
PyTorch's grad mode on and so enter its graph) and *training* (BatchNorm
and Dropout in training behaviour; ``Block.__call__`` on NDArrays reads
it).  There is no tape of its own: the graph is PyTorch's.

A leaf is a tensor that ``attach_grad``/``mark_variables`` marked, or a
block's ``nn.Parameter``.  Its ``grad_req`` and gradient buffer live on
the tensor (``_mx_grad_req``, ``_mx_grad``); a parameter without them
is ``'write'`` while it requires grad.  :func:`backward` walks the graph
from the heads to the leaves it reaches, takes their gradients with
``torch.autograd.grad`` and writes them into the buffers by the JAX
package's rule (``_accumulate_leaf``): ``'write'`` overwrites,
``'add'`` accumulates across passes, ``'null'`` is left alone.  Within
one pass the paths to a leaf are summed, as ``torch.autograd.grad``
sums them.  Nothing relies on ``tensor.grad``.

:class:`Function` is MXNet's custom differentiable function: its
``forward`` and ``backward`` on NDArrays become one
``torch.autograd.Function`` node of the graph.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import torch
from torch import nn

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad",
           "grad_req_of", "grad_buffer", "get_symbol", "Function"]

_REQS = ("write", "add", "null")


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


class _RecordingScope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev
        return False


def record(train_mode: bool = True):  # noqa: F811 — MXNet's argument name
    """Scope in which ops are recorded (and train mode is on)."""
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False):  # noqa: F811
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def grad_req_of(t: torch.Tensor) -> str:
    req = getattr(t, "_mx_grad_req", None)
    if req is not None:
        return req
    return "write" if isinstance(t, nn.Parameter) and t.requires_grad \
        else "null"


def grad_buffer(t: torch.Tensor) -> torch.Tensor:
    """The leaf's gradient buffer, (re)allocated as zeros when it is
    missing or no longer matches the leaf's shape, dtype or device (a
    parameter moved or cast after its last backward)."""
    g = getattr(t, "_mx_grad", None)
    if g is None or g.shape != t.shape or g.dtype != t.dtype \
            or g.device != t.device:
        g = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        t._mx_grad = g
    return g


def set_grad_req(t: torch.Tensor, req: str) -> None:
    """Mark a leaf: 'null' also stops PyTorch from computing its
    gradient."""
    if req not in _REQS:
        raise MXNetError(f"invalid grad_req {req!r}; one of {_REQS}")
    t._mx_grad_req = req
    if t.is_floating_point():
        t.requires_grad_(req != "null")


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray a leaf with ``grad_req``; its gradient buffer
    is the matching entry of ``gradients`` (an NDArray), or zeros where
    that entry is None."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        t = v._data
        if t.grad_fn is not None or t.requires_grad:
            t = t.detach()  # a new leaf with the same storage
        set_grad_req(t, req)
        v._data = v._ag_leaf = t
        if g is not None:
            t._mx_grad = g._data
        elif req != "null":
            grad_buffer(t)


def _leaves(roots: List[torch.Tensor]) -> List[torch.Tensor]:
    """The leaf tensors the graphs of ``roots`` reach, each once."""
    out, seen = [], set()
    stack = []
    for t in roots:
        if t.grad_fn is None:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        else:
            stack.append(t.grad_fn)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)  # AccumulateGrad
        if var is not None:
            out.append(var)
            continue
        for nxt, _ in fn.next_functions:
            if nxt is not None and nxt not in seen:
                stack.append(nxt)
    return out


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None or isinstance(head_grads, NDArray):
        head_grads = [head_grads] * len(heads) if head_grads is None \
            else [head_grads]
    ts, gs = [], []
    for h, g in zip(heads, head_grads):
        # a non-scalar head gets a head gradient of ones
        ts.append(h._data)
        gs.append(torch.ones_like(h._data) if g is None else g._data)
    return list(heads), ts, gs


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):
    """Gradients of ``heads`` with respect to every marked leaf they
    reach, written into the leaves' buffers by their ``grad_req``.
    Without ``retain_graph`` the heads leave the graph, so a second
    backward of the same heads reaches nothing (the JAX package drops
    their tape nodes)."""
    heads, ts, gs = _heads(heads, head_grads)
    keep = [i for i, t in enumerate(ts) if t.requires_grad]
    if not keep:
        return
    ts, gs = [ts[i] for i in keep], [gs[i] for i in keep]
    leaves = [t for t in _leaves(ts) if grad_req_of(t) != "null"]
    if leaves:
        grads = torch.autograd.grad(ts, leaves, grad_outputs=gs,
                                    retain_graph=retain_graph,
                                    allow_unused=True)
        with torch.no_grad():
            for leaf, g in zip(leaves, grads):
                if g is None:
                    continue
                buf = grad_buffer(leaf)
                if grad_req_of(leaf) == "add":
                    buf.add_(g)
                else:
                    buf.copy_(g)
    if not retain_graph:
        for i in keep:
            heads[i]._data = heads[i]._data.detach()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` as new
    NDArrays; no buffer is written."""
    from .ndarray.ndarray import NDArray

    heads, ts, gs = _heads(heads, head_grads)
    if isinstance(variables, NDArray):
        variables = [variables]
    ins = [v._ag_leaf if v._ag_leaf is not None else v._data
           for v in variables]
    if not all(t.requires_grad for t in ins):
        raise MXNetError("one of the variables does not participate in "
                         "the graph of heads")
    keep = bool(retain_graph or create_graph)
    out = torch.autograd.grad(ts, ins, grad_outputs=gs, retain_graph=keep,
                              create_graph=create_graph, allow_unused=True)
    if any(g is None for g in out):
        raise MXNetError("one of the variables does not participate in "
                         "the graph of heads")
    if not keep:
        for h in heads:
            h._data = h._data.detach()
    return [NDArray(g) for g in out]


def get_symbol(x):
    raise MXNetError("autograd.get_symbol: use HybridBlock tracing instead "
                     "(the port records no symbolic tape)")


class _FunctionNode(torch.autograd.Function):
    """A user :class:`Function` as one node of PyTorch's graph."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray

        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors])
        ctx.fn = fn
        single = not isinstance(outs, (list, tuple))
        fn._single = single
        return tuple(o._data for o in ((outs,) if single else outs))

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray

        with pause():
            gs = ctx.fn.backward(*[NDArray(c) for c in cts])
        if not isinstance(gs, (list, tuple)):
            gs = (gs,)
        return (None,) + tuple(
            g._data if g is not None and need else None
            for g, need in zip(gs, ctx.needs_input_grad[1:]))


class Function:
    """A differentiable function with a hand-written backward (MXNet's
    ``autograd.Function``).  Subclass it, write ``forward(self,
    *inputs)`` and ``backward(self, *output_grads)`` on NDArrays (the
    forward may ``save_for_backward``), and call an instance on NDArrays.

    The forward runs outside recording.  Under ``record()`` the call is
    one node of the graph: ``backward`` and ``grad`` reach the inputs
    through the user's ``backward``, which runs outside recording too
    and gets zeros for an output that received no gradient."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause():
                return self.forward(*inputs)
        outs = _FunctionNode.apply(self, *[x._data for x in inputs])
        if self._single:
            return NDArray(outs[0])
        return [NDArray(o) for o in outs]
