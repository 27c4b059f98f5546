"""Minimal pure-Python ONNX protobuf codec (the port's own copy of
``flexflow_tpu/utils/onnx_proto.py``; no ``onnx`` package needed).

ONNX files are plain protobuf: this module implements just enough of the
wire format (varints, length-delimited fields, packed repeated scalars) and
of the onnx.proto schema (field numbers below are from the public
github.com/onnx/onnx/blob/main/onnx/onnx.proto) to load/save the model
graphs the frontend consumes: ModelProto / GraphProto / NodeProto /
AttributeProto / TensorProto / ValueInfoProto and friends.

The decoded objects duck-type the ``onnx`` package's API surface used by
``flexflow_tpu_torch.onnx_frontend`` (``model.graph.node[i].op_type``,
``attribute[j].ints``, ``tensor_type.shape.dim[k].dim_value``, ...), and
``tensor_to_array``/``array_to_tensor`` replace ``onnx.numpy_helper``.
The encoder gives the JAX package's bytes for the same message.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64  # two's complement int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# field kinds: "int" (varint), "string", "bytes", "float" (fixed32),
# ("msg", Cls). Repeated-ness is declared separately.


class Message:
    """Tiny declarative protobuf message: FIELDS = {num: (name, kind, repeated)}."""

    FIELDS: Dict[int, Tuple[str, Any, bool]] = {}

    def __init__(self, **kw):
        for num, (name, kind, rep) in self.FIELDS.items():
            if rep:
                setattr(self, name, [])
            elif kind == "int":
                setattr(self, name, 0)
            elif kind == "float":
                setattr(self, name, 0.0)
            elif kind == "string":
                setattr(self, name, "")
            elif kind == "bytes":
                setattr(self, name, b"")
            else:  # message
                setattr(self, name, None)
        for k, v in kw.items():
            setattr(self, k, v)

    # -- decode --
    @classmethod
    def parse(cls, buf: bytes):
        self = cls()
        i, n = 0, len(buf)
        while i < n:
            tag, i = _read_varint(buf, i)
            num, wt = tag >> 3, tag & 7
            field = cls.FIELDS.get(num)
            if field is None:  # skip unknown field
                if wt == 0:
                    _, i = _read_varint(buf, i)
                elif wt == 1:
                    i += 8
                elif wt == 2:
                    ln, i = _read_varint(buf, i)
                    i += ln
                elif wt == 5:
                    i += 4
                else:
                    raise ValueError(f"wire type {wt}")
                continue
            name, kind, rep = field
            if kind == "int":
                if wt == 2:  # packed
                    ln, i = _read_varint(buf, i)
                    end = i + ln
                    vals = []
                    while i < end:
                        v, i = _read_varint(buf, i)
                        vals.append(_signed64(v))
                    getattr(self, name).extend(vals)
                else:
                    v, i = _read_varint(buf, i)
                    v = _signed64(v)
                    if rep:
                        getattr(self, name).append(v)
                    else:
                        setattr(self, name, v)
            elif kind == "float":
                if wt == 2:  # packed
                    ln, i = _read_varint(buf, i)
                    vals = struct.unpack(f"<{ln // 4}f", buf[i:i + ln])
                    i += ln
                    getattr(self, name).extend(vals)
                else:
                    (v,) = struct.unpack("<f", buf[i:i + 4])
                    i += 4
                    if rep:
                        getattr(self, name).append(v)
                    else:
                        setattr(self, name, v)
            elif kind in ("string", "bytes"):
                ln, i = _read_varint(buf, i)
                raw = buf[i:i + ln]
                i += ln
                v = raw.decode("utf-8") if kind == "string" else raw
                if rep:
                    getattr(self, name).append(v)
                else:
                    setattr(self, name, v)
            else:  # nested message
                ln, i = _read_varint(buf, i)
                sub = kind.parse(buf[i:i + ln])
                i += ln
                if rep:
                    getattr(self, name).append(sub)
                else:
                    setattr(self, name, sub)
        return self

    # -- encode --
    def serialize(self) -> bytes:
        out = bytearray()
        for num, (name, kind, rep) in sorted(self.FIELDS.items()):
            vals = getattr(self, name)
            if not rep:
                if vals is None:
                    continue
                if kind == "int" and vals == 0:
                    continue
                if kind == "string" and vals == "":
                    continue
                if kind == "bytes" and vals == b"":
                    continue
                vals = [vals]
            for v in vals:
                if kind == "int":
                    _write_varint(out, (num << 3) | 0)
                    _write_varint(out, int(v))
                elif kind == "float":
                    _write_varint(out, (num << 3) | 5)
                    out += struct.pack("<f", float(v))
                elif kind == "string":
                    raw = v.encode("utf-8")
                    _write_varint(out, (num << 3) | 2)
                    _write_varint(out, len(raw))
                    out += raw
                elif kind == "bytes":
                    _write_varint(out, (num << 3) | 2)
                    _write_varint(out, len(v))
                    out += v
                else:
                    raw = v.serialize()
                    _write_varint(out, (num << 3) | 2)
                    _write_varint(out, len(raw))
                    out += raw
        return bytes(out)


# ---------------------------------------------------------------------------
# onnx.proto subset (field numbers from the public schema)
# ---------------------------------------------------------------------------


class TensorProto(Message):
    # data_type codes
    FLOAT, INT32, INT64, DOUBLE = 1, 6, 7, 11
    FIELDS = {
        1: ("dims", "int", True),
        2: ("data_type", "int", False),
        4: ("float_data", "float", True),
        7: ("int64_data", "int", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
    }


class Dimension(Message):
    FIELDS = {1: ("dim_value", "int", False), 2: ("dim_param", "string", False)}


class TensorShapeProto(Message):
    FIELDS = {1: ("dim", Dimension, True)}


class TensorTypeProto(Message):
    FIELDS = {1: ("elem_type", "int", False), 2: ("shape", TensorShapeProto, False)}


class TypeProto(Message):
    FIELDS = {1: ("tensor_type", TensorTypeProto, False)}


class ValueInfoProto(Message):
    FIELDS = {1: ("name", "string", False), 2: ("type", TypeProto, False)}


class AttributeProto(Message):
    # AttributeType codes (frontend dispatches on these)
    FLOAT, INT, STRING, TENSOR, GRAPH, FLOATS, INTS, STRINGS = range(1, 9)
    FIELDS = {
        1: ("name", "string", False),
        2: ("f", "float", False),
        3: ("i", "int", False),
        4: ("s", "bytes", False),
        5: ("t", TensorProto, False),
        7: ("floats", "float", True),
        8: ("ints", "int", True),
        9: ("strings", "bytes", True),
        20: ("type", "int", False),
    }


class NodeProto(Message):
    FIELDS = {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", AttributeProto, True),
        7: ("domain", "string", False),
    }


class GraphProto(Message):
    FIELDS = {
        1: ("node", NodeProto, True),
        2: ("name", "string", False),
        5: ("initializer", TensorProto, True),
        11: ("input", ValueInfoProto, True),
        12: ("output", ValueInfoProto, True),
    }


class OperatorSetIdProto(Message):
    FIELDS = {1: ("domain", "string", False), 2: ("version", "int", False)}


class ModelProto(Message):
    FIELDS = {
        1: ("ir_version", "int", False),
        2: ("producer_name", "string", False),
        7: ("graph", GraphProto, False),
        8: ("opset_import", OperatorSetIdProto, True),
    }


# ---------------------------------------------------------------------------
# numpy_helper equivalents + file IO
# ---------------------------------------------------------------------------

_DTYPES = {
    TensorProto.FLOAT: np.float32,
    TensorProto.INT32: np.int32,
    TensorProto.INT64: np.int64,
    TensorProto.DOUBLE: np.float64,
}


def tensor_to_array(t: TensorProto) -> np.ndarray:
    dt = _DTYPES.get(t.data_type)
    if dt is None:
        raise NotImplementedError(f"onnx tensor data_type {t.data_type}")
    shape = tuple(t.dims)
    if t.raw_data:
        return np.frombuffer(t.raw_data, dtype=dt).reshape(shape).copy()
    if t.data_type == TensorProto.FLOAT and t.float_data:
        return np.asarray(t.float_data, np.float32).reshape(shape)
    if t.data_type == TensorProto.INT64 and t.int64_data:
        return np.asarray(t.int64_data, np.int64).reshape(shape)
    return np.zeros(shape, dt)


def array_to_tensor(a: np.ndarray, name: str = "") -> TensorProto:
    codes = {np.dtype(np.float32): TensorProto.FLOAT,
             np.dtype(np.int64): TensorProto.INT64,
             np.dtype(np.int32): TensorProto.INT32,
             np.dtype(np.float64): TensorProto.DOUBLE}
    a = np.ascontiguousarray(a)
    return TensorProto(dims=list(a.shape), data_type=codes[a.dtype],
                       raw_data=a.tobytes(), name=name)


def tensor_value_info(name: str, elem_type: int, shape) -> ValueInfoProto:
    dims = [Dimension(dim_value=int(d)) if isinstance(d, (int, np.integer))
            else Dimension(dim_param=str(d)) for d in shape]
    return ValueInfoProto(
        name=name,
        type=TypeProto(tensor_type=TensorTypeProto(
            elem_type=elem_type, shape=TensorShapeProto(dim=dims))))


def load(path: str) -> ModelProto:
    with open(path, "rb") as f:
        return ModelProto.parse(f.read())


def save(model: ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.serialize())
