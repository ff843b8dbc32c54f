"""A small MessagePack codec: the subset the library stores.

Job state, journal payloads, CRDT op data, record ids and indexer-rule
blobs are MessagePack bytes in the library DB. This codec covers the
types those values use (nil, bool, int, float, str, bin, array, map)
and writes the same bytes as `msgpack.packb(obj)` with its defaults
(`use_bin_type=True`, double floats, the smallest int form), so a
library written by either side reads on the other. Ext types and
timestamps are not supported.
"""

from __future__ import annotations

import struct
from typing import Any

_pack_d = struct.Struct(">d").pack


class MsgpackError(ValueError):
    pass


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix_base: int | None, fix_max: int, codes: tuple, out: bytearray) -> None:
    """Header of a str/bin/array/map of length n: the fix form when it
    fits, else the 8/16/32-bit length form in `codes` (None = absent)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 0x100:
        out += bytes((codes[0], n))
    elif n < 0x10000:
        out.append(codes[1])
        out += n.to_bytes(2, "big")
    elif n < 0x100000000:
        out.append(codes[2])
        out += n.to_bytes(4, "big")
    else:
        raise MsgpackError(f"length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _pack_d(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, -1, (0xC4, 0xC5, 0xC6), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise MsgpackError(f"cannot serialize {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n <= 0x7F:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if n < 1 << (8 * width):
                out.append(code)
                out += n.to_bytes(width, "big")
                return
        raise MsgpackError(f"int {n} too large")
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if n >= -(1 << (8 * width - 1)):
                out.append(code)
                out += n.to_bytes(width, "big", signed=True)
                return
        raise MsgpackError(f"int {n} too small")


def unpackb(data: bytes) -> Any:
    """Decode one object; trailing bytes or a truncated input raise
    MsgpackError. Strings decode as UTF-8, arrays as lists."""
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise MsgpackError("extra bytes after the object")
    return obj


def _take(data: bytes, pos: int, n: int) -> tuple[bytes, int]:
    end = pos + n
    if end > len(data):
        raise MsgpackError("truncated input")
    return data[pos:end], end


def _uint(data: bytes, pos: int, n: int) -> tuple[int, int]:
    raw, pos = _take(data, pos, n)
    return int.from_bytes(raw, "big"), pos


def _unpack(data: bytes, pos: int) -> tuple[Any, int]:
    if pos >= len(data):
        raise MsgpackError("truncated input")
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _str(data, pos, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(data, pos, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(data, pos, b & 0x0F)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in (0xCC, 0xCD, 0xCE, 0xCF):
        return _uint(data, pos, 1 << (b - 0xCC))
    if b in (0xD0, 0xD1, 0xD2, 0xD3):
        raw, pos = _take(data, pos, 1 << (b - 0xD0))
        return int.from_bytes(raw, "big", signed=True), pos
    if b == 0xCA:
        raw, pos = _take(data, pos, 4)
        return struct.unpack(">f", raw)[0], pos
    if b == 0xCB:
        raw, pos = _take(data, pos, 8)
        return struct.unpack(">d", raw)[0], pos
    if b in (0xD9, 0xDA, 0xDB):
        n, pos = _uint(data, pos, 1 << (b - 0xD9))
        return _str(data, pos, n)
    if b in (0xC4, 0xC5, 0xC6):
        n, pos = _uint(data, pos, 1 << (b - 0xC4))
        return _take(data, pos, n)
    if b in (0xDC, 0xDD):
        n, pos = _uint(data, pos, 2 << (b - 0xDC))
        return _array(data, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _uint(data, pos, 2 << (b - 0xDE))
        return _map(data, pos, n)
    raise MsgpackError(f"unsupported type byte 0x{b:02x}")


def _str(data: bytes, pos: int, n: int) -> tuple[str, int]:
    raw, pos = _take(data, pos, n)
    try:
        return raw.decode("utf-8"), pos
    except UnicodeDecodeError as e:
        raise MsgpackError(str(e)) from e


def _array(data: bytes, pos: int, n: int) -> tuple[list, int]:
    items = []
    for _ in range(n):
        item, pos = _unpack(data, pos)
        items.append(item)
    return items, pos


def _map(data: bytes, pos: int, n: int) -> tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        try:
            out[k] = v
        except TypeError as e:  # an unhashable key (a list or map)
            raise MsgpackError(str(e)) from e
    return out, pos
