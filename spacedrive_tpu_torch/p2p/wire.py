"""Async wire encode/decode helpers.

Parity: ref:crates/p2p-proto/src/lib.rs — tiny primitives (uuid, buf,
string) layered on an async stream, plus msgpack frames for structured
payloads (the reference's rmp-serde). All integers big-endian like the
reference's `AsyncWriteExt` usage.

Counterpart of `spacedrive_tpu/p2p/wire.py`: the same frames, byte for
byte. MessagePack payloads go through the port's own codec
(`utils/msgpack_codec`), which writes `msgpack.packb(obj,
use_bin_type=True)`'s bytes.
"""

from __future__ import annotations

import struct
import uuid
from typing import Any

from ..utils.msgpack_codec import packb, unpackb

MAX_FRAME = 64 * 1024 * 1024  # defensive bound on one framed payload


class Writer:
    """Buffers little writes; flush once per logical message."""

    def __init__(self, stream: Any):
        self._stream = stream
        self._buf = bytearray()

    def u8(self, v: int) -> "Writer":
        self._buf.append(v)
        return self

    def u32(self, v: int) -> "Writer":
        self._buf += struct.pack(">I", v)
        return self

    def u64(self, v: int) -> "Writer":
        self._buf += struct.pack(">Q", v)
        return self

    def uuid(self, v: uuid.UUID) -> "Writer":
        self._buf += v.bytes
        return self

    def string(self, s: str) -> "Writer":
        raw = s.encode()
        return self.u32(len(raw)).raw(raw)

    def buf(self, b: bytes) -> "Writer":
        return self.u32(len(b)).raw(b)

    def raw(self, b: bytes) -> "Writer":
        self._buf += b
        return self

    def msgpack(self, obj: Any) -> "Writer":
        return self.buf(packb(obj))

    async def flush(self) -> None:
        await self._stream.write(bytes(self._buf))
        self._buf.clear()


class Reader:
    def __init__(self, stream: Any):
        self._stream = stream

    async def exact(self, n: int) -> bytes:
        return await self._stream.read_exact(n)

    async def u8(self) -> int:
        return (await self.exact(1))[0]

    async def u32(self) -> int:
        return struct.unpack(">I", await self.exact(4))[0]

    async def u64(self) -> int:
        return struct.unpack(">Q", await self.exact(8))[0]

    async def uuid(self) -> uuid.UUID:
        return uuid.UUID(bytes=await self.exact(16))

    async def string(self) -> str:
        return (await self.buf()).decode()

    async def buf(self) -> bytes:
        n = await self.u32()
        if n > MAX_FRAME:
            raise ValueError(f"frame too large: {n}")
        return await self.exact(n)

    async def msgpack(self) -> Any:
        return unpackb(await self.buf())
