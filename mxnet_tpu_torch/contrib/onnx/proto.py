"""A minimal ONNX protobuf reader and writer in pure Python (the port's
own copy of ``mxnet_tpu/contrib/onnx/proto.py``, byte for byte the same
encoding, so that both packages write the same file for the same graph).

The reference's interop layer (python/mxnet/contrib/onnx/) rides the
``onnx`` pip package; this one implements the small stable subset of
onnx.proto3 that model files use directly over the protobuf wire format
(varint and length-delimited fields).  Field numbers follow onnx.proto3
(IR version 3 and later, stable since 2017); the files it writes pass
``torch._C._check_onnx_proto``.

Only the messages needed for model interchange exist: ModelProto,
GraphProto, NodeProto, AttributeProto, TensorProto, ValueInfoProto,
TypeProto/TensorShapeProto, OperatorSetIdProto.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---- ONNX TensorProto.DataType enum ---------------------------------------
DT_FLOAT = 1
DT_UINT8 = 2
DT_INT8 = 3
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9
DT_FLOAT16 = 10
DT_DOUBLE = 11
DT_BFLOAT16 = 16

NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT, np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.int8): DT_INT8, np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64, np.dtype(np.bool_): DT_BOOL,
    np.dtype(np.float16): DT_FLOAT16, np.dtype(np.float64): DT_DOUBLE,
}
DT_TO_NP = {v: k for k, v in NP_TO_DT.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR = 1, 2, 3, 4
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


# ---- wire-format primitives -----------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _svarint(n: int) -> bytes:  # plain (non-zigzag) signed int64 field
    return _varint(n if n >= 0 else n + (1 << 64))


def _tag(fieldno: int, wire: int) -> bytes:
    return _varint((fieldno << 3) | wire)


def _ld(fieldno: int, payload: bytes) -> bytes:
    return _tag(fieldno, 2) + _varint(len(payload)) + payload


def _int_field(fieldno: int, v: int) -> bytes:
    return _tag(fieldno, 0) + _svarint(int(v))


def _str_field(fieldno: int, s) -> bytes:
    if isinstance(s, str):
        s = s.encode()
    return _ld(fieldno, s)


def _float_field(fieldno: int, v: float) -> bytes:
    return _tag(fieldno, 5) + struct.pack("<f", v)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def varint(self) -> int:
        shift = n = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    def signed(self) -> int:
        n = self.varint()
        return n - (1 << 64) if n >= (1 << 63) else n

    def tag(self) -> Tuple[int, int]:
        t = self.varint()
        return t >> 3, t & 7

    def bytes_(self) -> bytes:
        ln = self.varint()
        out = self.buf[self.pos:self.pos + ln]
        self.pos += ln
        return out

    def skip(self, wire: int):
        if wire == 0:
            self.varint()
        elif wire == 1:
            self.pos += 8
        elif wire == 2:
            self.bytes_()
        elif wire == 5:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.buf, self.pos)[0]
        self.pos += 4
        return v


def _packed_or_repeated_ints(r: _Reader, wire: int) -> List[int]:
    if wire == 2:  # packed
        sub = _Reader(r.bytes_())
        out = []
        while not sub.eof():
            out.append(sub.signed())
        return out
    return [r.signed()]


def _packed_or_repeated_floats(r: _Reader, wire: int) -> List[float]:
    if wire == 2:
        raw = r.bytes_()
        return list(struct.unpack(f"<{len(raw) // 4}f", raw))
    return [r.f32()]


# ---- message dataclasses ---------------------------------------------------

@dataclass
class Tensor:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = DT_FLOAT
    raw: bytes = b""

    @classmethod
    def from_numpy(cls, name: str, arr: np.ndarray) -> "Tensor":
        arr = np.asarray(arr)
        if arr.dtype not in NP_TO_DT:
            arr = arr.astype(np.float32)
        return cls(name=name, dims=list(arr.shape),
                   data_type=NP_TO_DT[arr.dtype],
                   raw=np.ascontiguousarray(arr).tobytes())

    def to_numpy(self) -> np.ndarray:
        dt = DT_TO_NP.get(self.data_type)
        if dt is None:
            raise ValueError(f"unsupported tensor data_type "
                             f"{self.data_type}")
        return np.frombuffer(self.raw, dt).reshape(self.dims).copy()

    def encode(self) -> bytes:
        out = bytearray()
        for d in self.dims:
            out += _int_field(1, d)
        out += _int_field(2, self.data_type)
        if self.name:
            out += _str_field(8, self.name)
        out += _ld(9, self.raw)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Tensor":
        t = cls()
        r = _Reader(buf)
        floats: List[float] = []
        ints: List[int] = []
        while not r.eof():
            f, w = r.tag()
            if f == 1:
                t.dims += _packed_or_repeated_ints(r, w)
            elif f == 2:
                t.data_type = r.varint()
            elif f == 8:
                t.name = r.bytes_().decode()
            elif f == 9:
                t.raw = r.bytes_()
            elif f == 4:  # float_data fallback encoding
                floats += _packed_or_repeated_floats(r, w)
            elif f == 7:  # int64_data fallback encoding
                ints += _packed_or_repeated_ints(r, w)
            else:
                r.skip(w)
        if not t.raw and floats:
            t.raw = np.asarray(floats, np.float32).tobytes()
        if not t.raw and ints:
            t.raw = np.asarray(
                ints, DT_TO_NP.get(t.data_type, np.int64)).tobytes()
        return t


@dataclass
class Attribute:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[Tensor] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    @classmethod
    def make(cls, name: str, value) -> "Attribute":
        a = cls(name=name)
        if isinstance(value, bool):
            a.type, a.i = AT_INT, int(value)
        elif isinstance(value, int):
            a.type, a.i = AT_INT, value
        elif isinstance(value, float):
            a.type, a.f = AT_FLOAT, value
        elif isinstance(value, str):
            a.type, a.s = AT_STRING, value.encode()
        elif isinstance(value, np.ndarray):
            a.type, a.t = AT_TENSOR, Tensor.from_numpy(name, value)
        elif isinstance(value, (list, tuple)):
            if all(isinstance(v, (int, np.integer)) for v in value):
                a.type, a.ints = AT_INTS, [int(v) for v in value]
            elif all(isinstance(v, str) for v in value):
                a.type, a.strings = AT_STRINGS, [v.encode() for v in value]
            else:
                a.type = AT_FLOATS
                a.floats = [float(v) for v in value]
        else:
            raise ValueError(f"cannot onnx-encode attribute {name}={value!r}")
        return a

    def value(self):
        if self.type == AT_FLOAT:
            return self.f
        if self.type == AT_INT:
            return self.i
        if self.type == AT_STRING:
            return self.s.decode()
        if self.type == AT_TENSOR:
            return self.t.to_numpy()
        if self.type == AT_FLOATS:
            return list(self.floats)
        if self.type == AT_INTS:
            return list(self.ints)
        if self.type == AT_STRINGS:
            return [s.decode() for s in self.strings]
        raise ValueError(f"unsupported attribute type {self.type}")

    def encode(self) -> bytes:
        out = bytearray(_str_field(1, self.name))
        if self.type == AT_FLOAT:
            out += _float_field(2, self.f)
        elif self.type == AT_INT:
            out += _int_field(3, self.i)
        elif self.type == AT_STRING:
            out += _ld(4, self.s)
        elif self.type == AT_TENSOR:
            out += _ld(5, self.t.encode())
        elif self.type == AT_FLOATS:
            for v in self.floats:
                out += _float_field(7, v)
        elif self.type == AT_INTS:
            for v in self.ints:
                out += _int_field(8, v)
        elif self.type == AT_STRINGS:
            for v in self.strings:
                out += _ld(9, v)
        out += _int_field(20, self.type)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Attribute":
        a = cls()
        r = _Reader(buf)
        while not r.eof():
            f, w = r.tag()
            if f == 1:
                a.name = r.bytes_().decode()
            elif f == 2:
                a.f = r.f32()
                a.type = a.type or AT_FLOAT
            elif f == 3:
                a.i = r.signed()
                a.type = a.type or AT_INT
            elif f == 4:
                a.s = r.bytes_()
                a.type = a.type or AT_STRING
            elif f == 5:
                a.t = Tensor.decode(r.bytes_())
                a.type = a.type or AT_TENSOR
            elif f == 7:
                a.floats += _packed_or_repeated_floats(r, w)
                a.type = AT_FLOATS
            elif f == 8:
                a.ints += _packed_or_repeated_ints(r, w)
                a.type = AT_INTS
            elif f == 9:
                a.strings.append(r.bytes_())
                a.type = AT_STRINGS
            elif f == 20:
                a.type = r.varint()
            else:
                r.skip(w)
        return a


@dataclass
class Node:
    op_type: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)
    domain: str = ""

    def encode(self) -> bytes:
        out = bytearray()
        for s in self.inputs:
            out += _str_field(1, s)
        for s in self.outputs:
            out += _str_field(2, s)
        if self.name:
            out += _str_field(3, self.name)
        out += _str_field(4, self.op_type)
        for k in sorted(self.attrs):
            out += _ld(5, Attribute.make(k, self.attrs[k]).encode())
        if self.domain:
            out += _str_field(7, self.domain)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Node":
        n = cls()
        r = _Reader(buf)
        while not r.eof():
            f, w = r.tag()
            if f == 1:
                n.inputs.append(r.bytes_().decode())
            elif f == 2:
                n.outputs.append(r.bytes_().decode())
            elif f == 3:
                n.name = r.bytes_().decode()
            elif f == 4:
                n.op_type = r.bytes_().decode()
            elif f == 5:
                a = Attribute.decode(r.bytes_())
                n.attrs[a.name] = a.value()
            elif f == 7:
                n.domain = r.bytes_().decode()
            else:
                r.skip(w)
        return n


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = DT_FLOAT
    shape: List[Optional[int]] = field(default_factory=list)

    def encode(self) -> bytes:
        dims = bytearray()
        for d in self.shape:
            if d is None or (isinstance(d, int) and d < 0):
                dims += _ld(1, _str_field(2, "N"))
            else:
                dims += _ld(1, _int_field(1, d))
        tensor_type = (_int_field(1, self.elem_type) +
                       _ld(2, bytes(dims)))
        return _str_field(1, self.name) + _ld(2, _ld(1, tensor_type))

    @classmethod
    def decode(cls, buf: bytes) -> "ValueInfo":
        vi = cls()
        r = _Reader(buf)
        while not r.eof():
            f, w = r.tag()
            if f == 1:
                vi.name = r.bytes_().decode()
            elif f == 2:  # TypeProto
                tr = _Reader(r.bytes_())
                while not tr.eof():
                    tf, tw = tr.tag()
                    if tf == 1:  # tensor_type
                        ttr = _Reader(tr.bytes_())
                        while not ttr.eof():
                            ttf, ttw = ttr.tag()
                            if ttf == 1:
                                vi.elem_type = ttr.varint()
                            elif ttf == 2:  # shape
                                sr = _Reader(ttr.bytes_())
                                while not sr.eof():
                                    sf, sw = sr.tag()
                                    if sf == 1:  # dim
                                        dr = _Reader(sr.bytes_())
                                        dim: Optional[int] = None
                                        while not dr.eof():
                                            df, dw = dr.tag()
                                            if df == 1:
                                                dim = dr.signed()
                                            else:
                                                dr.skip(dw)
                                        vi.shape.append(dim)
                                    else:
                                        sr.skip(sw)
                            else:
                                ttr.skip(ttw)
                    else:
                        tr.skip(tw)
            else:
                r.skip(w)
        return vi


@dataclass
class Graph:
    name: str = "mxnet_tpu"
    nodes: List[Node] = field(default_factory=list)
    initializers: List[Tensor] = field(default_factory=list)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)

    def encode(self) -> bytes:
        out = bytearray()
        for n in self.nodes:
            out += _ld(1, n.encode())
        out += _str_field(2, self.name)
        for t in self.initializers:
            out += _ld(5, t.encode())
        for vi in self.inputs:
            out += _ld(11, vi.encode())
        for vi in self.outputs:
            out += _ld(12, vi.encode())
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Graph":
        g = cls()
        r = _Reader(buf)
        while not r.eof():
            f, w = r.tag()
            if f == 1:
                g.nodes.append(Node.decode(r.bytes_()))
            elif f == 2:
                g.name = r.bytes_().decode()
            elif f == 5:
                g.initializers.append(Tensor.decode(r.bytes_()))
            elif f == 11:
                g.inputs.append(ValueInfo.decode(r.bytes_()))
            elif f == 12:
                g.outputs.append(ValueInfo.decode(r.bytes_()))
            else:
                r.skip(w)
        return g


@dataclass
class Model:
    graph: Graph = field(default_factory=Graph)
    ir_version: int = 8
    opset: int = 13
    # the JAX package's producer name: both packages write the same bytes
    producer_name: str = "mxnet_tpu"

    def encode(self) -> bytes:
        out = bytearray(_int_field(1, self.ir_version))
        out += _str_field(2, self.producer_name)
        out += _ld(7, self.graph.encode())
        opset = _str_field(1, "") + _int_field(2, self.opset)
        out += _ld(8, opset)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Model":
        m = cls()
        r = _Reader(buf)
        while not r.eof():
            f, w = r.tag()
            if f == 1:
                m.ir_version = r.varint()
            elif f == 2:
                m.producer_name = r.bytes_().decode()
            elif f == 7:
                m.graph = Graph.decode(r.bytes_())
            elif f == 8:
                sr = _Reader(r.bytes_())
                while not sr.eof():
                    sf, sw = sr.tag()
                    if sf == 2:
                        m.opset = sr.signed()
                    else:
                        sr.skip(sw)
            else:
                r.skip(w)
        return m


def save(model: Model, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.encode())


def load(path: str) -> Model:
    with open(path, "rb") as f:
        return Model.decode(f.read())
