"""The generated op namespace of ``mxnet_tpu_torch.nd`` (counterpart of
``mxnet_tpu/ndarray/register.py``): one wrapper per registered op,
made on first access, plus the frontends whose ops read the autograd
state (Dropout's train flag and generator, BatchNorm's train flag and
its in-place update of the moving statistics) and ``Custom``, whose
inputs may come by keyword."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..ops.registry import get_op, invoke


def _make_wrapper(name: str) -> Callable:
    op = get_op(name)

    def fn(*args, out=None, **kwargs):
        res = invoke(name, *args, **kwargs)
        if out is not None:
            src = res[0] if isinstance(res, list) else res
            with torch.no_grad():
                out._data.copy_(src._data)
            return out
        return res

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = (f"Imperative wrapper for registered op '{name}'.\n\n"
                  f"{op.param_doc}")
    return fn


def Dropout(data, p=0.5, mode="training", axes=()):
    """Inverted dropout in training mode (``autograd.is_training()``),
    its mask drawn from the generator of data's device."""
    return invoke("Dropout", data, p=p, mode=mode, axes=tuple(axes),
                  train=autograd.is_training(),
                  generator=_random.generator(data.ctx))


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=False, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False):
    """Batch statistics in training mode, which also update the moving
    statistics in place (outside the graph); the moving ones otherwise."""
    train = autograd.is_training() and not use_global_stats
    res = invoke("BatchNorm", data, gamma, beta, moving_mean, moving_var,
                 eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                 use_global_stats=use_global_stats, axis=axis, train=train)
    if not train:
        return res
    out, new_mean, new_var = res
    with torch.no_grad():
        moving_mean._data.copy_(new_mean._data)
        moving_var._data.copy_(new_var._data)
    return out


def Custom(*args, op_type=None, **kwargs):
    """A registered CustomOpProp on NDArrays: positional inputs, then
    NDArrays by keyword in the order of the prop's ``list_arguments``;
    the other keyword arguments go to the prop."""
    from ..ndarray.ndarray import NDArray
    from ..operator import make_prop

    named = {k: kwargs.pop(k) for k in list(kwargs)
             if isinstance(kwargs[k], NDArray)}
    prop = make_prop(dict(kwargs, op_type=op_type))
    inputs = list(args) + [named.pop(n) for n in
                           prop.list_arguments()[len(args):] if n in named]
    if named:
        raise MXNetError(f"Custom {op_type!r}: no argument "
                         f"{sorted(named)} in {prop.list_arguments()}")
    return invoke("Custom", *inputs, op_type=op_type, **kwargs)


_SPECIAL: Dict[str, Callable] = {"Dropout": Dropout, "dropout": Dropout,
                                 "BatchNorm": BatchNorm,
                                 "batch_norm": BatchNorm, "Custom": Custom}


def lookup(name: str):
    if name in _SPECIAL:
        return _SPECIAL[name]
    try:
        return _make_wrapper(name)
    except MXNetError:
        raise AttributeError(f"no registered op {name!r}") from None
