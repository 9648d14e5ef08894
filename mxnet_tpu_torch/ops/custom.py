"""The ``Custom`` op: a user's :class:`~mxnet_tpu_torch.operator.CustomOp`
run as one ``torch.autograd.Function`` node (counterpart of the JAX
package's ``Custom`` op, ``mxnet_tpu/operator.py``).

The forward creates one operator instance (``prop.create_operator``),
runs the user's ``forward`` outside recording on NDArrays of the inputs'
device, with ``is_train`` the op's train flag (``autograd.is_training()``
unless a caller gives ``_train``) and ``aux=[]``, and keeps the instance
on the node; the node's backward runs the user's ``backward`` on that
same instance, with the cotangents as ``out_grad`` (zeros for an output
the loss does not use, ones under a symbol executor's loss head).  Two
forwards in flight keep two instances, each reached by its own backward.
The output shapes and types come from the prop's ``infer_shape`` and
``infer_type``.  The op says that it runs the user's Python
(``_graphs.note_host_python``), so a compiled site that calls it runs
eagerly instead of replaying a capture.
"""
from __future__ import annotations

import torch

from .. import _graphs
from ..base import dtype_of, np_dtype
from ..operator import make_prop
from .registry import register_op

__all__ = ["custom", "custom_num_outputs"]


def custom_num_outputs(attrs) -> int:
    return len(make_prop(attrs).list_outputs())


def _out_specs(prop, shapes, dtypes):
    """[(shape, torch dtype)] of the outputs from the prop."""
    _, oshapes, _ = prop.infer_shape([list(s) for s in shapes])
    _, otypes, _ = prop.infer_type(list(dtypes))
    return [(tuple(int(d) for d in s), dtype_of(t))
            for s, t in zip(oshapes, otypes)]


class _CustomFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prop, is_train, *ins):
        from .. import autograd
        from ..context import as_context
        from ..ndarray.ndarray import NDArray

        dev = ins[0].device if ins else torch.device("cpu")
        shapes = [list(t.shape) for t in ins]
        dtypes = [np_dtype(t.dtype) for t in ins]
        op = prop.create_operator(as_context(dev), shapes, dtypes)
        outs = [NDArray(torch.zeros(s, dtype=t, device=dev))
                for s, t in _out_specs(prop, shapes, dtypes)]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train=is_train, req=["write"] * len(outs),
                       in_data=[NDArray(t) for t in ins], out_data=outs,
                       aux=[])
        res = tuple(o._data for o in outs)
        ctx.op = op
        ctx.n_in = len(ins)
        ctx.save_for_backward(*ins, *res)
        return res

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cts):
        from .. import autograd
        from ..ndarray.ndarray import NDArray

        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_grad = [NDArray(torch.zeros_like(x)) for x in ins]
        with autograd.pause():
            ctx.op.backward(req=["write"] * len(ins),
                            out_grad=[NDArray(c) for c in cts],
                            in_data=[NDArray(x) for x in ins],
                            out_data=[NDArray(o) for o in outs],
                            in_grad=in_grad, aux=[])
        return (None, None) + tuple(
            g._data if need else None
            for g, need in zip(in_grad, ctx.needs_input_grad[2:]))


@register_op("Custom", num_outputs=custom_num_outputs)
def custom(*arrays, op_type=None, _train=None, **kwargs):
    """Run the CustomOpProp registered as ``op_type`` on ``arrays``; the
    other keyword arguments go to the prop's constructor."""
    prop = make_prop(dict(kwargs, op_type=op_type))
    if _train is None:
        from .. import autograd

        _train = autograd.is_training()
    _graphs.note_host_python()
    outs = _CustomFn.apply(prop, bool(_train), *arrays)
    return outs if len(outs) > 1 else outs[0]
