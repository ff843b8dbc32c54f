"""Spaceblock — block-based file transfer with progress and cancel.

Parity: ref:crates/p2p-block — a protocol "modelled after SyncThing's
BEP" (src/lib.rs:4-6): `BlockSize` adaptive to file size
(block_size.rs), `SpaceblockRequest{name, size, range}` +
`SpaceblockRequests{id, block_size, requests}` for multi-file sends
(sb_request.rs), and a `Transfer` engine with a progress callback and
cooperative cancellation checked at block boundaries (lib.rs:75-91).
Wire layout per file: blocks in order, each `u64 offset ‖ u32 len ‖
data`, receiver acks each block with one byte (0 = continue,
1 = cancel) — the back-channel the reference gets from QUIC flow
control.

Counterpart of `spacedrive_tpu/p2p/block.py`: the same request and
block frames, byte for byte.
"""

from __future__ import annotations

import asyncio
import os
import uuid
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Callable

from .wire import Reader, Writer

KIB = 1024
MIB = 1024 * KIB


@dataclass(frozen=True)
class BlockSize:
    """ref:block_size.rs — clamped power-of-two block size derived from
    file size (small files ship in one block; huge files use 1MiB)."""

    size: int

    MIN = 16 * KIB
    MAX = 1 * MIB

    @classmethod
    def from_file_size(cls, file_size: int) -> "BlockSize":
        size = cls.MIN
        while size < cls.MAX and size * 256 < file_size:
            size *= 2
        return cls(size)

    @classmethod
    def dangerously_new(cls, size: int) -> "BlockSize":
        # ref:block_size.rs `dangerously_new` — trusts the peer's value
        if size <= 0 or size > cls.MAX:
            raise ValueError(f"invalid block size {size}")
        return cls(size)


@dataclass
class Range:
    """ref:sb_request.rs `Range::{Full, Partial(start..end)}`."""

    start: int = 0
    end: int | None = None  # None = to EOF (Full when start == 0)

    @property
    def is_full(self) -> bool:
        return self.start == 0 and self.end is None

    def to_wire(self) -> Any:
        return None if self.is_full else [self.start, self.end]

    @classmethod
    def from_wire(cls, obj: Any) -> "Range":
        if obj is None:
            return cls()
        return cls(start=int(obj[0]), end=None if obj[1] is None else int(obj[1]))


@dataclass
class SpaceblockRequest:
    name: str
    size: int
    range: Range = field(default_factory=Range)

    def to_wire(self) -> dict[str, Any]:
        return {"name": self.name, "size": self.size, "range": self.range.to_wire()}

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "SpaceblockRequest":
        return cls(
            name=obj["name"], size=int(obj["size"]), range=Range.from_wire(obj["range"])
        )


@dataclass
class SpaceblockRequests:
    id: uuid.UUID
    block_size: BlockSize
    requests: list[SpaceblockRequest]

    @property
    def total_size(self) -> int:
        return sum(r.size for r in self.requests)

    def to_wire(self) -> dict[str, Any]:
        return {
            "id": self.id.bytes,
            "block_size": self.block_size.size,
            "requests": [r.to_wire() for r in self.requests],
        }

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "SpaceblockRequests":
        return cls(
            id=uuid.UUID(bytes=obj["id"]),
            block_size=BlockSize.dangerously_new(int(obj["block_size"])),
            requests=[SpaceblockRequest.from_wire(r) for r in obj["requests"]],
        )


class TransferCancelled(Exception):
    pass


class Transfer:
    """One directional transfer session over an established stream
    (ref:lib.rs:75-91 `Transfer::new(...).send/receive`)."""

    def __init__(
        self,
        requests: SpaceblockRequests,
        on_progress: Callable[[int], None] | None = None,
        cancelled: asyncio.Event | None = None,
    ):
        self.requests = requests
        self.on_progress = on_progress or (lambda _pct: None)
        self.cancelled = cancelled or asyncio.Event()
        self.transferred = 0

    def _progress(self) -> None:
        total = self.requests.total_size or 1
        self.on_progress(min(100, self.transferred * 100 // total))

    def _file_span(self, req: SpaceblockRequest) -> tuple[int, int]:
        start = req.range.start
        end = req.size if req.range.end is None else min(req.range.end, req.size)
        return start, max(end - start, 0)

    async def send(self, stream: Any, files: list[BinaryIO]) -> None:
        """Stream every requested range; abort on receiver cancel byte."""
        if len(files) != len(self.requests.requests):
            raise ValueError("files/requests length mismatch")
        w, r = Writer(stream), Reader(stream)
        bs = self.requests.block_size.size
        for req, fh in zip(self.requests.requests, files):
            start, remaining = self._file_span(req)
            fh.seek(start)
            offset = start
            while remaining > 0:
                if self.cancelled.is_set():
                    raise TransferCancelled()
                # disk reads off the loop: a cold 1MiB block from a slow
                # volume would otherwise stall every other stream
                data = await asyncio.to_thread(fh.read, min(bs, remaining))
                if not data:
                    raise EOFError(f"file {req.name} shorter than advertised")
                w.u64(offset).u32(len(data)).raw(data)
                await w.flush()
                ack = await r.u8()
                if ack == 1:
                    raise TransferCancelled()
                offset += len(data)
                remaining -= len(data)
                self.transferred += len(data)
                self._progress()

    async def receive(self, stream: Any, sinks: list[BinaryIO]) -> None:
        """Receive every requested range, acking each block."""
        if len(sinks) != len(self.requests.requests):
            raise ValueError("sinks/requests length mismatch")
        w, r = Writer(stream), Reader(stream)
        bs = self.requests.block_size.size
        for req, out in zip(self.requests.requests, sinks):
            _start, remaining = self._file_span(req)
            while remaining > 0:
                _offset = await r.u64()
                length = await r.u32()
                # don't trust the sender: a block must be non-empty, within
                # the negotiated block size, and within the advertised span
                if length == 0 or length > bs or length > remaining:
                    w.u8(1)
                    await w.flush()
                    raise ValueError(
                        f"peer sent invalid block length {length} "
                        f"(block_size={bs}, remaining={remaining})"
                    )
                data = await r.exact(length)
                if self.cancelled.is_set():
                    w.u8(1)
                    await w.flush()
                    raise TransferCancelled()
                await asyncio.to_thread(out.write, data)
                w.u8(0)
                await w.flush()
                remaining -= length
                self.transferred += length
                self._progress()
