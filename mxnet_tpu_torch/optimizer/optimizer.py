"""Optimizers of the port (counterpart of
``mxnet_tpu/optimizer/optimizer.py``): the registry, ``create``, the
``Optimizer`` base with its learning-rate bookkeeping, ``SGD`` and
``NAG``.

Here an optimizer holds hyper-parameters only: the update math runs in
``parallel.SPMDTrainer`` through ``parallel.functional_optimizer``, on
the update ops of ``ops/optimizer_ops.py``.  The eager per-parameter
``update`` path, ``Updater`` and the other optimizers wait for a later
slice.
"""
from __future__ import annotations

from typing import Dict

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "NAG", "create", "register"]

_REG: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        key = name.lower()
        if key in _REG:
            raise MXNetError(f"optimizer {name!r} already registered")
        _REG[key] = cls
        return cls
    return deco


def create(name, **kwargs) -> "Optimizer":
    """An optimizer by registered name (case-insensitive), or ``name``
    itself when it is an Optimizer already."""
    if isinstance(name, Optimizer):
        return name
    cls = _REG.get(str(name).lower())
    if cls is None:
        raise MXNetError(f"optimizer {name!r} is not ported; registered: "
                         f"{sorted(_REG)}")
    return cls(**kwargs)


class Optimizer:
    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, begin_num_update=0,
                 multi_precision=False):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.multi_precision = multi_precision

    def _update_count(self, index):
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr


@register("sgd")
class SGD(Optimizer):
    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update


@register("nag")
class NAG(SGD):
    """SGD with Nesterov momentum (``nag_mom_update``)."""
