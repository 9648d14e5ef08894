"""Quantized gradient collectives behind ``MXNET_COMM_QUANT`` (counterpart
of ``mxnet_tpu/optimizer/comm.py``).

``SpmdUpdater`` (``optimizer/spmd.py``) moves two large payloads a step:
the gradient reduce and the weight gather.  Quantized, each element
crosses the wire as one byte, with one fp32 scale per 512-element block;
the quantization error is carried in a residual that re-enters the next
step's payload before encoding:

    acc      = payload + residual
    codes    = encode(acc)
    residual = acc - decode(codes)

``int8`` is symmetric linear (``round(x / scale)`` into [-127, 127],
``scale = max|x| / 127`` over the block); ``fp8`` casts ``x / scale``
clipped to ±448 to ``torch.float8_e4m3fn``, ``scale = max|x| / 448``.
The arithmetic is the JAX package's, op for op, so the codes, scales and
residuals are the same bits.  The residuals are optimizer state: they
ride ``get_states``/``set_states`` under :data:`RESIDUAL_KEY` in the
canonical, mesh-free form of :func:`canonical_residuals`.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..util import env as _env

__all__ = ["ENCODINGS", "RESIDUAL_KEY", "BLOCK", "QuantConfig", "config",
           "encode", "decode", "wire_nbytes", "canonical_residuals"]

ENCODINGS = ("none", "int8", "fp8")

# the reserved key of the residuals in an Updater's states payload (every
# other key is a parameter index); the per-replica Updater keeps it as it
# is, so the residuals survive a hand-off between the paths
RESIDUAL_KEY = "__comm_residuals__"

_QMAX = {"int8": 127.0, "fp8": 448.0}
_WIRE_ITEMSIZE = {"int8": 1, "fp8": 1}
_CODE_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

# elements per scale block
BLOCK = 512


class QuantConfig(NamedTuple):
    mode: str        # "none" | "int8" | "fp8"
    min_size: int    # buckets under this many elements stay full precision
    ef: bool = True  # error-feedback residuals

    @property
    def active(self) -> bool:
        return self.mode != "none"

    def applies(self, total: int) -> bool:
        """Whether a bucket of ``total`` padded elements quantizes."""
        return self.active and total >= self.min_size


def config() -> QuantConfig:
    mode = (_env.get_str("MXNET_COMM_QUANT") or "none").strip().lower()
    if mode not in ENCODINGS:
        from ..base import MXNetError

        raise MXNetError(
            f"MXNET_COMM_QUANT={mode!r}: expected one of {ENCODINGS}")
    return QuantConfig(mode,
                       _env.get_int("MXNET_COMM_QUANT_MIN_SIZE") or 0,
                       bool(_env.get_bool("MXNET_COMM_QUANT_EF")))


def _nblocks(n: int) -> int:
    return max(1, -(-n // BLOCK))


def encode(x: torch.Tensor, mode: str):
    """Block-wise quantize a float ``(rows, n)`` tensor: ``(codes,
    scale)``, codes one byte an element ``(rows, n)`` (int8 or
    float8_e4m3fn), scale fp32 ``(rows, ceil(n / BLOCK))``.  Zero
    padding encodes to zero codes."""
    x = x.to(torch.float32)
    rows, n = x.shape
    nb = _nblocks(n)
    qmax = _QMAX[mode]
    xb = torch.nn.functional.pad(x, (0, nb * BLOCK - n)).reshape(
        rows, nb, BLOCK)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / torch.tensor(
        qmax, dtype=torch.float32, device=x.device)
    y = xb / scale
    if mode == "int8":
        codes = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        codes = torch.clamp(y, -qmax, qmax).to(torch.float8_e4m3fn)
    return (codes.reshape(rows, nb * BLOCK)[:, :n].contiguous(),
            scale.reshape(rows, nb))


def decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode`: fp32 ``(rows, n)``."""
    rows, n = codes.shape
    nb = scale.shape[-1]
    cb = torch.nn.functional.pad(codes.to(torch.float32),
                                 (0, nb * BLOCK - n)).reshape(rows, nb, BLOCK)
    return (cb * scale[..., None]).reshape(rows, nb * BLOCK)[:, :n]


def wire_nbytes(total: int, rows: int, mode: str) -> int:
    """Bytes one quantized leg of ``total`` padded elements in ``rows``
    rows puts on the wire: the codes and one fp32 scale per block."""
    return total * _WIRE_ITEMSIZE[mode] \
        + 4 * max(rows, -(-total // BLOCK))


def canonical_residuals(gres_sum: Dict[int, np.ndarray],
                        wres_flat: Dict[int, np.ndarray],
                        mode: str) -> Dict[str, Any]:
    """The serialized residuals: full-shape arrays per parameter index,
    the gradient side summed over the shards (what is still owed to the
    wire), the weight side as it is."""
    return {"grads": gres_sum, "weights": wres_flat, "encoding": mode}
