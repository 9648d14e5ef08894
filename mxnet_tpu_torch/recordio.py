"""RecordIO, the record-packed dataset format (counterpart of
``mxnet_tpu/recordio.py``; the reference's ``python/mxnet/recordio.py``
over dmlc-core's RecordIO streams).

The bytes on disk are the JAX package's, so each package reads the
other's files.  Little-endian:

  a record: u32 magic 0x3ed7230a, u32 lrecord, the data, zero padding to
    4 bytes; lrecord = (cflag << 29) | length, cflag 0 for a whole
    record, 1/2/3 for the first/middle/last chunk of a record longer
    than the 29-bit length field;
  IRHeader, before an image record's payload: u32 flag, f32 label,
    u64 id, u64 id2; flag > 0 means ``flag`` float32 labels follow the
    header and ``label`` is 0.

The ``.idx`` sidecar of :class:`MXIndexedRecordIO` holds one
``key\\toffset`` line a record.  The native pipeline
(``native/image_pipeline.cc``) reads the same files.
"""
from __future__ import annotations

import numbers
import os
import struct
import threading
from collections import namedtuple
from typing import Optional

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0x3ED7230A
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1


def _pad4(n):
    return (4 - n % 4) % 4


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``).  It
    pickles (a reader reopens at the start), so a dataset over it can be
    sent to a spawned DataLoader worker."""

    # records longer than this are written as a chain of chunks; a
    # smaller value lets a test exercise the chain without 512 MiB
    _max_chunk = _LEN_MASK

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag not in ("r", "w"):
            raise MXNetError("flag must be 'r' or 'w'")
        self.record = open(self.uri, "rb" if self.flag == "r" else "wb")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        d["is_open"] = False
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.record.tell()

    def write(self, buf: bytes):
        if self.flag != "w":
            raise MXNetError("not opened for writing")
        if len(buf) <= self._max_chunk:
            self._write_chunk(buf, 0)
            return
        off = 0
        while off < len(buf):
            n = min(len(buf) - off, self._max_chunk)
            cflag = 1 if off == 0 else (3 if off + n == len(buf) else 2)
            self._write_chunk(buf[off:off + n], cflag)
            off += n

    def _write_chunk(self, chunk: bytes, cflag: int):
        self.record.write(struct.pack("<II", _MAGIC,
                                      (cflag << _CFLAG_BITS) | len(chunk)))
        self.record.write(chunk)
        self.record.write(b"\x00" * _pad4(len(chunk)))

    def read(self) -> Optional[bytes]:
        """The next record (its chunks joined), or None at the end."""
        if self.flag != "r":
            raise MXNetError("not opened for reading")
        parts = []
        while True:
            header = self.record.read(8)
            if len(header) < 8:
                if parts:  # the file ends inside a chain of chunks
                    raise MXNetError(
                        f"truncated chunked record at EOF in {self.uri}")
                return None
            magic, lrecord = struct.unpack("<II", header)
            if magic != _MAGIC:
                raise MXNetError(
                    f"invalid record magic {magic:#x} in {self.uri}")
            cflag = lrecord >> _CFLAG_BITS
            length = lrecord & _LEN_MASK
            data = self.record.read(length)
            if len(data) != length:
                raise MXNetError(
                    f"truncated record payload in {self.uri} "
                    f"(expected {length} bytes, got {len(data)})")
            self.record.read(_pad4(length))
            parts.append(data)
            if cflag in (0, 3):  # a whole record or the last chunk
                return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random access through the ``.idx`` sidecar.  ``read_idx`` seeks
    and reads under a lock, so DataLoader worker threads may share one
    reader."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self._lock = threading.Lock()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if getattr(self, "fidx", None) is not None and not self.fidx.closed:
            self.fidx.close()
        super().close()

    def seek(self, idx):
        self.record.seek(self.idx[idx])

    def read_idx(self, idx) -> bytes:
        with self._lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{idx}\t{pos}\n")
        self.idx[idx] = pos
        self.keys.append(idx)


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """IRHeader + payload; a label that is not a number is stored as
    ``flag`` float32 values after the header."""
    label = header.label
    if isinstance(label, numbers.Number):
        header = header._replace(flag=0)
        payload = b""
    else:
        label = np.asarray(label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        payload = label.tobytes()
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + payload + s


def unpack(s: bytes):
    """-> (IRHeader, payload); ``label`` is a float32 array when the
    record carries ``flag`` labels."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header: IRHeader, img: np.ndarray, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """IRHeader + the image (HWC RGB uint8) encoded by ``image.imencode``."""
    from .image import imencode

    return pack(header, imencode(img, quality=quality, fmt=img_fmt))


def unpack_img(s: bytes, iscolor: int = 1):
    """-> (IRHeader, HWC uint8 numpy image, RGB when ``iscolor``)."""
    from .image import imdecode_np

    header, raw = unpack(s)
    return header, imdecode_np(raw, iscolor)
