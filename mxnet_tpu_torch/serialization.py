"""Tensor binary serialization — the reference ``.params`` format.

Counterpart of ``mxnet_tpu/serialization.py``, byte for byte for dense
arrays (little-endian):

  file:   u64 list_magic (0x112), u64 reserved (0)
          u64 n_arrays, n_arrays * ndarray_record
          u64 n_names,  n_names  * (u64 len, utf-8 bytes)
  record: u32 NDARRAY_V2_MAGIC (0xF993FAC9), u32 stype (0 = dense)
          u32 ndim, ndim * i64 dims, i32 dev_type, i32 dev_id
          i32 type_flag (MXNet dtype code), raw data bytes (C order)

  sparse: u32 NDARRAY_V2_MAGIC, u32 stype (1 = row_sparse, 2 = csr)
          u32 ndim, ndim * i64 full dims, i32 dev_type, i32 dev_id
          i32 type_flag, u32 n_aux, n_aux * (u32 ndim, i64 dims, int64
          data) (csr: [indptr, indices]; row_sparse: [indices]),
          u32 ndim, i64 dims of the stored values, their raw bytes

bfloat16 (type flag 12) is stored as raw 16-bit words and read back
through ``torch.frombuffer(...).view(torch.bfloat16)``: no ml_dtypes.
A sparse array travels as a :class:`SparseRecord` (its stype, full
shape, stored values and aux arrays); ``nd.save``/``nd.load`` turn
sparse NDArrays into records and back.
"""
from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Tuple, Union

import torch

from .base import MXNetError

__all__ = ["save_ndarrays", "load_ndarrays", "SparseRecord", "LIST_MAGIC",
           "NDARRAY_V2_MAGIC"]

LIST_MAGIC = 0x112
NDARRAY_V2_MAGIC = 0xF993FAC9

# MXNet type_flag codes (ref: include/mxnet/base.h mshadow type enum)
_TYPE_FLAG = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
              torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
              torch.bool: 7, torch.bfloat16: 12}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}


class SparseRecord(NamedTuple):
    """A sparse array as the file holds it: ``stype`` ('row_sparse' or
    'csr'), the full ``shape``, the stored ``values`` and the int64
    ``aux`` arrays (csr: ``(indptr, indices)``; row_sparse:
    ``(indices,)``), all CPU tensors."""
    stype: str
    shape: Tuple[int, ...]
    values: torch.Tensor
    aux: Tuple[torch.Tensor, ...]


_STYPE_ID = {"row_sparse": 1, "csr": 2}
_ID_STYPE = {v: k for k, v in _STYPE_ID.items()}


def _flag(t: torch.Tensor) -> int:
    flag = _TYPE_FLAG.get(t.dtype)
    if flag is None:
        raise MXNetError(f"cannot serialize dtype {t.dtype}")
    return flag


def _host_bytes(t: torch.Tensor) -> bytes:
    a = t.detach().to("cpu").contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return a.numpy().tobytes()


def _write_shape(f, shape) -> None:
    f.write(struct.pack("<I", len(shape)))
    f.write(struct.pack(f"<{len(shape)}q", *shape))


def _write_one(f, t) -> None:
    if isinstance(t, SparseRecord):
        f.write(struct.pack("<II", NDARRAY_V2_MAGIC, _STYPE_ID[t.stype]))
        _write_shape(f, t.shape)
        f.write(struct.pack("<ii", 1, 0))
        f.write(struct.pack("<i", _flag(t.values)))
        f.write(struct.pack("<I", len(t.aux)))
        for aux in t.aux:
            _write_shape(f, tuple(aux.shape))
            f.write(_host_bytes(aux.to(torch.int64)))
        _write_shape(f, tuple(t.values.shape))
        f.write(_host_bytes(t.values))
        return
    flag = _flag(t)
    f.write(struct.pack("<II", NDARRAY_V2_MAGIC, 0))
    _write_shape(f, tuple(t.shape))
    f.write(struct.pack("<ii", 1, 0))  # saved ctx: cpu(0), like reference
    f.write(struct.pack("<i", flag))
    f.write(_host_bytes(t))


def _read_shape(f) -> Tuple[int, ...]:
    (ndim,) = struct.unpack("<I", f.read(4))
    return struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim else ()


def _read_raw(f, shape, dtype) -> torch.Tensor:
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


def _read_one(f):
    magic, stype = struct.unpack("<II", f.read(8))
    if magic != NDARRAY_V2_MAGIC:
        raise MXNetError(f"bad ndarray magic {magic:#x}")
    if stype != 0 and stype not in _ID_STYPE:
        raise MXNetError(f"unknown storage type id {stype}")
    shape = _read_shape(f)
    f.read(8)  # saved ctx
    (flag,) = struct.unpack("<i", f.read(4))
    dtype = _FLAG_TYPE.get(flag)
    if dtype is None:
        raise MXNetError(f"unknown type flag {flag}")
    if stype == 0:
        return _read_raw(f, shape, dtype)
    (num_aux,) = struct.unpack("<I", f.read(4))
    aux = tuple(_read_raw(f, _read_shape(f), torch.int64)
                for _ in range(num_aux))
    values = _read_raw(f, _read_shape(f), dtype)
    return SparseRecord(_ID_STYPE[stype], tuple(shape), values, aux)


def save_ndarrays(fname: str, data) -> None:
    """mx.nd.save: a tensor (or :class:`SparseRecord`), a list of them,
    or a dict name->tensor."""
    if isinstance(data, (torch.Tensor, SparseRecord)):
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
    """mx.nd.load: CPU tensors (a :class:`SparseRecord` for each sparse
    record), as a dict when the file names them."""
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
