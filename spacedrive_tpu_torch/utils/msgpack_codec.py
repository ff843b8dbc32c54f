"""A small MessagePack codec: the subset the library stores.

Job state, journal payloads, CRDT op data, record ids and indexer-rule
blobs are MessagePack bytes in the library DB. This codec covers the
types those values use (nil, bool, int, float, str, bin, array, map)
and writes the same bytes as `msgpack.packb(obj)` with its defaults
(`use_bin_type=True`, double floats, the smallest int form), so a
library written by either side reads on the other. Ext types and
timestamps are not supported.

Nesting is bounded where `msgpack` 1.1 bounds it: packing refuses an
object nested deeper than 511 containers (`msgpack.packb`'s recursion
limit), unpacking a container nested 1,024 deep (its `StackError`); both
raise MsgpackError, a ValueError. The decoder keeps its own stack, so no
input, however deep, raises RecursionError.
"""

from __future__ import annotations

import struct
from typing import Any

_pack_d = struct.Struct(">d").pack


#: the deepest level an object may sit at when packed (`msgpack.packb`'s
#: default recursion limit: 511 containers around a scalar pack, 512 do not)
MAX_PACK_DEPTH = 511
#: containers nested this deep or deeper do not unpack (`msgpack`'s
#: unpacker stack: 1,024 containers read, 1,025 raise StackError)
MAX_UNPACK_DEPTH = 1024

_DONE = object()


class MsgpackError(ValueError):
    pass


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out, MAX_PACK_DEPTH)
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


def _pack(obj: Any, out: bytearray, limit: int) -> None:
    """Write `obj`; `limit` is how many more levels of containers may
    open around it (the recursion stays within MAX_PACK_DEPTH frames)."""
    if limit < 0:
        raise MsgpackError("recursion limit exceeded")
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
            _pack(item, out, limit - 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out, limit - 1)
            _pack(v, out, limit - 1)
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


def unpackb(data: bytes, strict_map_key: bool = False) -> Any:
    """Decode one object; trailing bytes or a truncated input raise
    MsgpackError. Strings decode as UTF-8, arrays as lists. With
    `strict_map_key`, a map key that is not a str or bytes raises, as
    `msgpack.unpackb`'s default does; without it any hashable key reads,
    as with `strict_map_key=False`."""
    data = bytes(data)
    # each open container: [items, count left, is a map, pending key]
    stack: list[list] = []
    pos = 0
    while True:
        obj, pos, n = _unpack(data, pos)
        if n is not None:  # a container's header: obj is its empty body
            if len(stack) >= MAX_UNPACK_DEPTH:
                raise MsgpackError("stack limit exceeded")
            if n:
                stack.append([obj, n, isinstance(obj, dict), _DONE])
                continue
        while stack:
            top = stack[-1]
            if not top[2]:
                top[0].append(obj)
            elif top[3] is _DONE:
                if strict_map_key and type(obj) not in (str, bytes):
                    raise MsgpackError(
                        f"{type(obj).__name__} is not allowed for map key")
                top[3] = obj
                break
            else:
                try:
                    top[0][top[3]] = obj
                except TypeError as e:  # an unhashable key (a list or map)
                    raise MsgpackError(str(e)) from e
                top[3] = _DONE
            top[1] -= 1
            if top[1]:
                break
            obj = stack.pop()[0]
        else:
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


def _unpack(data: bytes, pos: int) -> tuple[Any, int, int | None]:
    """One value at `pos`: `(value, next pos, None)` for a scalar, or
    `(empty list or dict, next pos, element count)` for a container's
    header."""
    if pos >= len(data):
        raise MsgpackError("truncated input")
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos, None
    if b >= 0xE0:
        return b - 0x100, pos, None
    if 0xA0 <= b <= 0xBF:
        return (*_str(data, pos, b & 0x1F), None)
    if 0x90 <= b <= 0x9F:
        return [], pos, b & 0x0F
    if 0x80 <= b <= 0x8F:
        return {}, pos, b & 0x0F
    if b == 0xC0:
        return None, pos, None
    if b == 0xC2:
        return False, pos, None
    if b == 0xC3:
        return True, pos, None
    if b in (0xCC, 0xCD, 0xCE, 0xCF):
        return (*_uint(data, pos, 1 << (b - 0xCC)), None)
    if b in (0xD0, 0xD1, 0xD2, 0xD3):
        raw, pos = _take(data, pos, 1 << (b - 0xD0))
        return int.from_bytes(raw, "big", signed=True), pos, None
    if b == 0xCA:
        raw, pos = _take(data, pos, 4)
        return struct.unpack(">f", raw)[0], pos, None
    if b == 0xCB:
        raw, pos = _take(data, pos, 8)
        return struct.unpack(">d", raw)[0], pos, None
    if b in (0xD9, 0xDA, 0xDB):
        n, pos = _uint(data, pos, 1 << (b - 0xD9))
        return (*_str(data, pos, n), None)
    if b in (0xC4, 0xC5, 0xC6):
        n, pos = _uint(data, pos, 1 << (b - 0xC4))
        return (*_take(data, pos, n), None)
    if b in (0xDC, 0xDD):
        n, pos = _uint(data, pos, 2 << (b - 0xDC))
        return [], pos, n
    if b in (0xDE, 0xDF):
        n, pos = _uint(data, pos, 2 << (b - 0xDE))
        return {}, pos, n
    raise MsgpackError(f"unsupported type byte 0x{b:02x}")


def _str(data: bytes, pos: int, n: int) -> tuple[str, int]:
    raw, pos = _take(data, pos, n)
    try:
        return raw.decode("utf-8"), pos
    except UnicodeDecodeError as e:
        raise MsgpackError(str(e)) from e
