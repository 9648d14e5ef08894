"""Tensor binary serialization — the reference ``.params`` format.

Counterpart of ``mxnet_tpu/serialization.py``, byte for byte for dense
arrays (little-endian):

  file:   u64 list_magic (0x112), u64 reserved (0)
          u64 n_arrays, n_arrays * ndarray_record
          u64 n_names,  n_names  * (u64 len, utf-8 bytes)
  record: u32 NDARRAY_V2_MAGIC (0xF993FAC9), u32 stype (0 = dense)
          u32 ndim, ndim * i64 dims, i32 dev_type, i32 dev_id
          i32 type_flag (MXNet dtype code), raw data bytes (C order)

bfloat16 (type flag 12) is stored as raw 16-bit words and read back
through ``torch.frombuffer(...).view(torch.bfloat16)``: no ml_dtypes.
Sparse records are not ported.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import torch

from .base import MXNetError

__all__ = ["save_ndarrays", "load_ndarrays", "LIST_MAGIC", "NDARRAY_V2_MAGIC"]

LIST_MAGIC = 0x112
NDARRAY_V2_MAGIC = 0xF993FAC9

# MXNet type_flag codes (ref: include/mxnet/base.h mshadow type enum)
_TYPE_FLAG = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
              torch.bool: 7, torch.bfloat16: 12}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}


def _write_one(f, t: torch.Tensor) -> None:
    flag = _TYPE_FLAG.get(t.dtype)
    if flag is None:
        raise MXNetError(f"cannot serialize dtype {t.dtype}")
    a = t.detach().to("cpu").contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    f.write(struct.pack("<II", NDARRAY_V2_MAGIC, 0))
    f.write(struct.pack("<I", a.dim()))
    f.write(struct.pack(f"<{a.dim()}q", *a.shape))
    f.write(struct.pack("<ii", 1, 0))  # saved ctx: cpu(0), like reference
    f.write(struct.pack("<i", flag))
    f.write(a.numpy().tobytes())


def _read_one(f) -> torch.Tensor:
    magic, stype = struct.unpack("<II", f.read(8))
    if magic != NDARRAY_V2_MAGIC:
        raise MXNetError(f"bad ndarray magic {magic:#x}")
    if stype != 0:
        raise MXNetError(f"sparse records (stype {stype}) are not ported")
    (ndim,) = struct.unpack("<I", f.read(4))
    shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim else ()
    f.read(8)  # saved ctx
    (flag,) = struct.unpack("<i", f.read(4))
    dtype = _FLAG_TYPE.get(flag)
    if dtype is None:
        raise MXNetError(f"unknown type flag {flag}")
    n = 1
    for s in shape:
        n *= s
    item = torch.empty((), dtype=dtype).element_size()
    buf = bytearray(f.read(n * item))
    if len(buf) != n * item:
        raise MXNetError("truncated .params file")
    if n == 0:
        return torch.empty(shape, dtype=dtype)
    if dtype == torch.bfloat16:
        t = torch.frombuffer(buf, dtype=torch.int16).view(torch.bfloat16)
    else:
        t = torch.frombuffer(buf, dtype=dtype)
    return t.reshape(shape)


def save_ndarrays(fname: str, data) -> None:
    """mx.nd.save: a tensor, a list of tensors, or a dict name->tensor."""
    if isinstance(data, torch.Tensor):
        arrays, names = [data], []
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        arrays, names = list(data), []
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_one(f, a)
        f.write(struct.pack("<Q", len(names)))
        for nm in names:
            b = nm.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load_ndarrays(fname: str) -> Union[List[torch.Tensor],
                                       Dict[str, torch.Tensor]]:
    """mx.nd.load: CPU tensors, as a dict when the file names them."""
    with open(fname, "rb") as f:
        magic, _ = struct.unpack("<QQ", f.read(16))
        if magic != LIST_MAGIC:
            raise MXNetError(f"invalid NDArray file {fname}: magic "
                             f"{magic:#x}")
        (n,) = struct.unpack("<Q", f.read(8))
        arrays = [_read_one(f) for _ in range(n)]
        (nn,) = struct.unpack("<Q", f.read(8))
        names = []
        for _ in range(nn):
            (ln,) = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode("utf-8"))
    if names:
        return dict(zip(names, arrays))
    return arrays
