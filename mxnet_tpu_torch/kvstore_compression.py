"""2-bit gradient compression of the KVStore (counterpart of
``mxnet_tpu/kvstore_compression.py``; ref:
src/kvstore/gradient_compression.cc).

Each element is sent as one of {0, +threshold, -threshold}, four to a
byte (code 1 is +threshold, 2 is -threshold, the first element in the
lowest bits), and what was not sent stays in a residual per key that is
added to the next gradient.  The codes and residuals are computed on the
gradient's device in fp32, with the JAX package's numpy arithmetic, so
they are the same bits.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .base import MXNetError

__all__ = ["TwoBitCompressor", "create"]

_CODE_POS = 1
_CODE_NEG = 2


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


class TwoBitCompressor:
    """2-bit quantizer with a residual per key."""

    def __init__(self, threshold: float = 0.5):
        t = float(threshold)
        if t <= 0:
            raise MXNetError("2bit compression threshold must be > 0")
        self.threshold = t
        self._residual: Dict[object, torch.Tensor] = {}

    def compress(self, key, grad) -> Tuple[torch.Tensor, tuple]:
        """grad (+ the key's residual) -> (packed uint8 codes, shape);
        the residual keeps what was not sent."""
        g = _tensor(grad)
        shape = tuple(g.shape)
        g = g.detach().reshape(-1).to(torch.float32)
        r = self._residual.get(key)
        if r is None or r.shape != g.shape or r.device != g.device:
            r = torch.zeros_like(g)
        acc = g + r
        t = self.threshold
        codes = torch.zeros(g.shape, dtype=torch.uint8, device=g.device)
        codes[acc >= t] = _CODE_POS
        codes[acc <= -t] = _CODE_NEG
        self._residual[key] = acc - self._values(codes)
        pad = (-codes.numel()) % 4
        if pad:
            codes = torch.cat([codes, codes.new_zeros(pad)])
        q = codes.reshape(-1, 4)
        packed = q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
        return packed, shape

    def _values(self, codes: torch.Tensor) -> torch.Tensor:
        t = self.threshold
        zero = torch.zeros((), dtype=torch.float32, device=codes.device)
        return torch.where(codes == _CODE_POS, zero + t,
                           torch.where(codes == _CODE_NEG, zero - t, zero))

    def decompress(self, packed, shape: tuple) -> torch.Tensor:
        """The fp32 values the codes stand for, in ``shape``."""
        p = _tensor(packed).to(torch.uint8).reshape(-1)
        n = int(np.prod(shape)) if shape else 1
        codes = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3,
                             (p >> 6) & 3], dim=1).reshape(-1)[:n]
        return self._values(codes).reshape(shape)


def create(params: dict):
    """A compressor from ``set_gradient_compression``'s parameters;
    unknown types raise."""
    p = dict(params)
    ctype = p.pop("type", None)
    if ctype in ("2bit", "2-bit"):
        return TwoBitCompressor(threshold=float(p.pop("threshold", 0.5)))
    if ctype in ("1bit", "signum"):
        raise MXNetError(
            "gradient compression type '1bit' is not implemented; "
            "supported: '2bit'")
    raise MXNetError(
        f"unknown gradient compression type {ctype!r}; supported: '2bit'")
