"""Automatic mixed precision (counterpart of ``mxnet_tpu/contrib/amp.py``).

The half type is bfloat16, as in the JAX package: it keeps float32's
exponent range, so gradients do not underflow as float16 ones do and
loss scaling is a no-op unless asked for.  ``init("float16")`` selects
bfloat16 too.

- ``init(target_dtype)`` selects the half type of later conversions.
- ``convert_hybrid_block(block)`` / ``convert_model(sym, arg, aux)``
  cast parameters to the half type and keep those whose name holds
  gamma, beta, mean, var, moving or running (normalisation parameters
  and statistics) in float32.
- ``init_trainer`` / ``scale_loss`` / ``unscale``: the dynamic loss
  scaler protocol (an overflow check by ``multi_all_finite``, backoff on
  overflow and growth every ``scale_window`` clean steps), active only
  from an ``init_scale`` above 1; at scale 1 nothing is scaled or
  checked.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from ..base import MXNetError

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block", "LossScaler"]

_FP32_PARAM_HINTS = ("gamma", "beta", "mean", "var", "moving", "running")

_TARGET = {"dtype": None}


def _half(target_dtype: Optional[str]) -> str:
    dt = target_dtype or _TARGET["dtype"] or "bfloat16"
    return "bfloat16" if dt in ("float16", "fp16") else dt


def init(target_dtype: str = "bfloat16"):
    """Select the half type; float16 selects bfloat16."""
    if target_dtype in ("float16", "fp16"):
        target_dtype = "bfloat16"
    if target_dtype not in ("bfloat16",):
        raise MXNetError(f"amp.init: unsupported target {target_dtype!r} "
                         "(bfloat16 is the half type)")
    _TARGET["dtype"] = target_dtype


def _keep_fp32(name: str) -> bool:
    return any(h in name for h in _FP32_PARAM_HINTS)


def convert_hybrid_block(block, target_dtype: str = None):
    """Cast the block's parameters to the half type in place, but the
    normalisation ones; returns the block."""
    dt = _half(target_dtype)
    for name, p in block.collect_params().items():
        if not _keep_fp32(name):
            p.cast(dt)
    return block


def convert_model(sym, arg_params, aux_params, target_dtype: str = None):
    """(sym, arg_params cast to the half type but the normalisation ones,
    aux_params as they are)."""
    dt = _half(target_dtype)
    new_args = {k: (v if _keep_fp32(k) else v.astype(dt))
                for k, v in arg_params.items()}
    return sym, new_args, dict(aux_params)


class LossScaler:
    """Dynamic loss scaler.  At ``init_scale`` 1 (the default) it stays
    off: the schedule runs only from a scale above 1."""

    def __init__(self, init_scale: float = 1.0, scale_factor: float = 2.0,
                 scale_window: int = 2000):
        self.loss_scale = float(init_scale)
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0
        self._dynamic = self.loss_scale > 1.0

    def has_overflow(self, params) -> bool:
        """True if any gradient holds an inf or a NaN."""
        from .. import nd

        grads = [p.grad() for p in params if p.grad_req != "null"]
        if not grads:
            return False
        ok = nd.multi_all_finite(*grads, num_arrays=len(grads))
        return float(ok.asnumpy()[0]) == 0.0

    def update_scale(self, overflow: bool):
        if not self._dynamic:
            return
        if overflow:
            self.loss_scale = max(self.loss_scale / self._factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0


def init_trainer(trainer, init_scale: float = 1.0):
    """Attach a LossScaler to a Trainer."""
    trainer._amp_loss_scaler = LossScaler(init_scale=init_scale)


@contextmanager
def scale_loss(loss, trainer):
    """The loss times the trainer's loss scale::

        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        amp.unscale(trainer)          # before trainer.step
    """
    scaler: Optional[LossScaler] = getattr(trainer, "_amp_loss_scaler",
                                           None)
    if scaler is None or scaler.loss_scale == 1.0:
        yield loss
        return
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the gradients by the loss scale in place and advance the
    schedule (nothing at scale 1)."""
    scaler: Optional[LossScaler] = getattr(trainer, "_amp_loss_scaler",
                                           None)
    if scaler is None:
        return
    params = list(trainer._params)
    overflow = scaler.has_overflow(params) if scaler.loss_scale != 1.0 \
        else False
    if scaler.loss_scale != 1.0:
        inv = 1.0 / scaler.loss_scale
        for p in params:
            if p.grad_req != "null":
                p.grad()._data.mul_(inv)
    scaler.update_scale(overflow)
