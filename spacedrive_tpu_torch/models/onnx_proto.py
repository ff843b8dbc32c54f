"""Minimal ONNX protobuf codec, with no `onnx` dependency.

Owned copy of `spacedrive_tpu/models/onnx_proto.py` (pure `struct` and
numpy). The reference runs its image labeler from a downloaded YOLOv8
`.onnx` file through ONNX Runtime (ref:crates/ai/src/image_labeler/
model/yolov8.rs:37-88). This module decodes the ONNX protobuf wire
format (the public, frozen `onnx.proto` schema; the field numbers below
are copied from that spec) into plain dicts that `onnx_runtime.py`
executes with torch. The encoder builds genuine ONNX bytes for the
tests and for export.

Only the message subset a vision model needs is implemented: Model,
Graph, Node, Attribute, Tensor, ValueInfo and friends.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# --- protobuf wire primitives ---------------------------------------------

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2
_WIRE_FIXED32 = 5


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement 64-bit, per proto spec
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


# --- schema-driven decode/encode ------------------------------------------
#
# A schema is {field_no: (name, kind)} where kind is one of
#   "int"    varint int64
#   "float"  fixed32 float
#   "bytes"  length-delimited bytes
#   "str"    length-delimited utf-8
#   "ints"   repeated varint (packed or not)
#   "floats" repeated fixed32 (packed or not)
#   "bytes*" repeated bytes
#   "str*"   repeated string
#   ("msg", schema)   embedded message
#   ("msg*", schema)  repeated embedded message
# Schemas may be mutated after definition to close recursive loops
# (Attribute ↔ Graph).

Schema = dict[int, tuple[str, Any]]


def decode_message(buf: bytes, schema: Schema) -> dict[str, Any]:
    msg: dict[str, Any] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field_no, wire = key >> 3, key & 7
        spec = schema.get(field_no)
        # read the raw payload first so unknown fields skip cleanly
        if wire == _WIRE_VARINT:
            raw, pos = _read_varint(buf, pos)
        elif wire == _WIRE_FIXED64:
            raw = buf[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            raw = buf[pos:pos + n]
            pos += n
        elif wire == _WIRE_FIXED32:
            raw = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if spec is None:
            continue
        name, kind = spec
        if kind == "int":
            msg[name] = _signed64(raw) if isinstance(raw, int) else raw
        elif kind == "float":
            msg[name] = struct.unpack("<f", raw)[0]
        elif kind == "bytes":
            msg[name] = bytes(raw)
        elif kind == "str":
            msg[name] = raw.decode("utf-8")
        elif kind == "ints":
            lst = msg.setdefault(name, [])
            if wire == _WIRE_VARINT:
                lst.append(_signed64(raw))
            else:  # packed
                p = 0
                while p < len(raw):
                    v, p = _read_varint(raw, p)
                    lst.append(_signed64(v))
        elif kind == "floats":
            lst = msg.setdefault(name, [])
            if wire == _WIRE_FIXED32:
                lst.append(struct.unpack("<f", raw)[0])
            else:  # packed
                lst.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
        elif kind == "bytes*":
            msg.setdefault(name, []).append(bytes(raw))
        elif kind == "str*":
            msg.setdefault(name, []).append(raw.decode("utf-8"))
        elif isinstance(kind, tuple) and kind[0] == "msg":
            msg[name] = decode_message(raw, kind[1])
        elif isinstance(kind, tuple) and kind[0] == "msg*":
            msg.setdefault(name, []).append(decode_message(raw, kind[1]))
        else:
            raise ValueError(f"bad schema kind {kind!r}")
    return msg


def encode_message(msg: dict[str, Any], schema: Schema) -> bytes:
    out = bytearray()
    by_name = {spec[0]: (no, spec[1]) for no, spec in schema.items()}
    for name, value in msg.items():
        if value is None:
            continue
        field_no, kind = by_name[name]
        if kind == "int":
            _write_varint(out, field_no << 3 | _WIRE_VARINT)
            _write_varint(out, int(value))
        elif kind == "float":
            _write_varint(out, field_no << 3 | _WIRE_FIXED32)
            out += struct.pack("<f", float(value))
        elif kind in ("bytes", "str"):
            data = value.encode("utf-8") if isinstance(value, str) else bytes(value)
            _write_varint(out, field_no << 3 | _WIRE_LEN)
            _write_varint(out, len(data))
            out += data
        elif kind == "ints":
            for v in value:  # unpacked: simplest, always valid
                _write_varint(out, field_no << 3 | _WIRE_VARINT)
                _write_varint(out, int(v))
        elif kind == "floats":
            for v in value:
                _write_varint(out, field_no << 3 | _WIRE_FIXED32)
                out += struct.pack("<f", float(v))
        elif kind in ("bytes*", "str*"):
            for v in value:
                data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                _write_varint(out, field_no << 3 | _WIRE_LEN)
                _write_varint(out, len(data))
                out += data
        elif isinstance(kind, tuple) and kind[0] == "msg":
            data = encode_message(value, kind[1])
            _write_varint(out, field_no << 3 | _WIRE_LEN)
            _write_varint(out, len(data))
            out += data
        elif isinstance(kind, tuple) and kind[0] == "msg*":
            for v in value:
                data = encode_message(v, kind[1])
                _write_varint(out, field_no << 3 | _WIRE_LEN)
                _write_varint(out, len(data))
                out += data
        else:
            raise ValueError(f"bad schema kind {kind!r}")
    return bytes(out)


# --- ONNX message schemas (field numbers from the public onnx.proto) ------

TENSOR_SCHEMA: Schema = {
    1: ("dims", "ints"),
    2: ("data_type", "int"),
    4: ("float_data", "floats"),
    5: ("int32_data", "ints"),
    6: ("string_data", "bytes*"),
    7: ("int64_data", "ints"),
    8: ("name", "str"),
    9: ("raw_data", "bytes"),
}

_DIM_SCHEMA: Schema = {
    1: ("dim_value", "int"),
    2: ("dim_param", "str"),
}

_SHAPE_SCHEMA: Schema = {
    1: ("dim", ("msg*", _DIM_SCHEMA)),
}

_TENSOR_TYPE_SCHEMA: Schema = {
    1: ("elem_type", "int"),
    2: ("shape", ("msg", _SHAPE_SCHEMA)),
}

_TYPE_SCHEMA: Schema = {
    1: ("tensor_type", ("msg", _TENSOR_TYPE_SCHEMA)),
}

VALUE_INFO_SCHEMA: Schema = {
    1: ("name", "str"),
    2: ("type", ("msg", _TYPE_SCHEMA)),
}

# Attribute and Graph are mutually recursive; close the loop below.
ATTRIBUTE_SCHEMA: Schema = {
    1: ("name", "str"),
    2: ("f", "float"),
    3: ("i", "int"),
    4: ("s", "bytes"),
    5: ("t", ("msg", TENSOR_SCHEMA)),
    7: ("floats", "floats"),
    8: ("ints", "ints"),
    9: ("strings", "bytes*"),
    10: ("tensors", ("msg*", TENSOR_SCHEMA)),
    20: ("type", "int"),
}

NODE_SCHEMA: Schema = {
    1: ("input", "str*"),
    2: ("output", "str*"),
    3: ("name", "str"),
    4: ("op_type", "str"),
    5: ("attribute", ("msg*", ATTRIBUTE_SCHEMA)),
    7: ("domain", "str"),
}

GRAPH_SCHEMA: Schema = {
    1: ("node", ("msg*", NODE_SCHEMA)),
    2: ("name", "str"),
    5: ("initializer", ("msg*", TENSOR_SCHEMA)),
    11: ("input", ("msg*", VALUE_INFO_SCHEMA)),
    12: ("output", ("msg*", VALUE_INFO_SCHEMA)),
    13: ("value_info", ("msg*", VALUE_INFO_SCHEMA)),
}

ATTRIBUTE_SCHEMA[6] = ("g", ("msg", GRAPH_SCHEMA))
ATTRIBUTE_SCHEMA[11] = ("graphs", ("msg*", GRAPH_SCHEMA))

_OPSET_SCHEMA: Schema = {
    1: ("domain", "str"),
    2: ("version", "int"),
}

MODEL_SCHEMA: Schema = {
    1: ("ir_version", "int"),
    2: ("producer_name", "str"),
    3: ("producer_version", "str"),
    5: ("model_version", "int"),
    7: ("graph", ("msg", GRAPH_SCHEMA)),
    8: ("opset_import", ("msg*", _OPSET_SCHEMA)),
}

# TensorProto.DataType values (public onnx.proto enum)
_DTYPES: dict[int, np.dtype] = {
    1: np.dtype(np.float32),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int8),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int16),
    6: np.dtype(np.int32),
    7: np.dtype(np.int64),
    9: np.dtype(np.bool_),
    10: np.dtype(np.float16),
    11: np.dtype(np.float64),
    12: np.dtype(np.uint32),
    13: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def tensor_to_array(tensor: dict[str, Any]) -> np.ndarray:
    """TensorProto dict → numpy array."""
    code = tensor.get("data_type", 1)
    if code == 16:  # BFLOAT16: raw 16-bit payloads; upcast to float32
        raw = np.frombuffer(tensor.get("raw_data", b""), "<u2")
        out = (raw.astype(np.uint32) << 16).view(np.float32)
        return out.reshape(tensor.get("dims", []))
    dtype = _DTYPES.get(code)
    if dtype is None:
        raise ValueError(f"unsupported tensor data_type {code}")
    dims = tensor.get("dims", [])
    if "raw_data" in tensor and tensor["raw_data"] != b"":
        arr = np.frombuffer(tensor["raw_data"], dtype.newbyteorder("<"))
    elif code == 1 and "float_data" in tensor:
        arr = np.asarray(tensor["float_data"], np.float32)
    elif code == 7 and "int64_data" in tensor:
        arr = np.asarray(tensor["int64_data"], np.int64)
    elif code in (2, 3, 4, 5, 6, 9, 10) and "int32_data" in tensor:
        arr = np.asarray(tensor["int32_data"], np.int32).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return arr.reshape(dims).astype(dtype, copy=False)


def array_to_tensor(name: str, arr: np.ndarray) -> dict[str, Any]:
    """numpy array → TensorProto dict (raw_data encoding)."""
    arr = np.asarray(arr)  # NOT ascontiguousarray: it promotes 0-d to (1,)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported numpy dtype {arr.dtype}")
    return {
        "name": name,
        "dims": list(arr.shape),
        "data_type": code,
        "raw_data": arr.astype(arr.dtype.newbyteorder("<")).tobytes(),
    }


# --- graph construction API (tests + export) ------------------------------


def make_attribute(name: str, value: Any) -> dict[str, Any]:
    if isinstance(value, bool):
        return {"name": name, "type": 2, "i": int(value)}
    if isinstance(value, int):
        return {"name": name, "type": 2, "i": value}
    if isinstance(value, float):
        return {"name": name, "type": 1, "f": value}
    if isinstance(value, str):
        return {"name": name, "type": 3, "s": value.encode()}
    if isinstance(value, bytes):
        return {"name": name, "type": 3, "s": value}
    if isinstance(value, np.ndarray):
        return {"name": name, "type": 4, "t": array_to_tensor(name, value)}
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            return {"name": name, "type": 7, "ints": list(value)}
        if all(isinstance(v, (int, float)) for v in value):
            return {"name": name, "type": 6, "floats": [float(v) for v in value]}
        if all(isinstance(v, str) for v in value):
            return {"name": name, "type": 8, "strings": [v.encode() for v in value]}
    raise ValueError(f"cannot infer attribute type for {name}={value!r}")


def make_node(op_type: str, inputs: list[str], outputs: list[str],
              name: str = "", **attrs: Any) -> dict[str, Any]:
    return {
        "op_type": op_type,
        "input": list(inputs),
        "output": list(outputs),
        "name": name or f"{op_type}_{outputs[0]}",
        "attribute": [make_attribute(k, v) for k, v in attrs.items()],
    }


def make_value_info(name: str, shape: tuple[int, ...],
                    elem_type: int = 1) -> dict[str, Any]:
    return {
        "name": name,
        "type": {"tensor_type": {
            "elem_type": elem_type,
            "shape": {"dim": [{"dim_value": int(d)} for d in shape]},
        }},
    }


def make_model(nodes: list[dict], inputs: list[dict], outputs: list[dict],
               initializers: dict[str, np.ndarray] | None = None,
               opset: int = 17, name: str = "graph") -> dict[str, Any]:
    return {
        "ir_version": 8,
        "producer_name": "spacedrive_tpu",
        "opset_import": [{"domain": "", "version": opset}],
        "graph": {
            "name": name,
            "node": nodes,
            "input": inputs,
            "output": outputs,
            "initializer": [
                array_to_tensor(k, v) for k, v in (initializers or {}).items()
            ],
        },
    }


def encode_model(model: dict[str, Any]) -> bytes:
    return encode_message(model, MODEL_SCHEMA)


def decode_model(buf: bytes) -> dict[str, Any]:
    return decode_message(buf, MODEL_SCHEMA)
