"""Learning-rate schedules (counterpart of ``mxnet_tpu/lr_scheduler.py``):
``FactorScheduler``, ``MultiFactorScheduler``, ``PolyScheduler`` and
``CosineScheduler``, each with a linear or constant warmup.

A scheduler is called with the optimizer's update count and returns the
learning rate; the optimizer sets ``base_lr`` from its own
``learning_rate`` when it is given one (``optimizer/optimizer.py``).
Pure Python, the same arithmetic as the JAX package's, so both give the
same sequence to the last bit.
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: the warmup from ``warmup_begin_lr`` to ``base_lr`` over
    ``warmup_steps`` updates, linear or constant."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        if warmup_mode not in ("linear", "constant"):
            raise MXNetError(f"bad warmup_mode {warmup_mode}")
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` every ``step`` updates, never
    below ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise MXNetError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0
        self._cur = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self._cur = max(self._cur * self.factor, self.stop_factor_lr)
        return self._cur


class MultiFactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` past each update count of the
    increasing list ``step``."""

    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if any(a >= b for a, b in zip(step, step[1:])):
            raise MXNetError("steps must be increasing")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self._cur = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind < len(self.step) and \
                num_update > self.step[self.cur_step_ind]:
            self._cur *= self.factor
            self.cur_step_ind += 1
        return self._cur


class PolyScheduler(LRScheduler):
    """final_lr + (base_lr - final_lr) * (1 - t)^pwr over ``max_update``
    updates after the warmup, then final_lr."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = 1 - (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                frac ** self.power
        return self.final_lr


class CosineScheduler(LRScheduler):
    """Half a cosine from base_lr to final_lr over ``max_update`` updates
    after the warmup, then final_lr."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            t = (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * t)) / 2
        return self.final_lr
