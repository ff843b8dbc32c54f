"""Application wire protocol — stream headers.

Parity: ref:core/src/p2p/protocol.rs:18-60 — every unicast stream opens
with a one-byte `Header` discriminant: Ping, Spacedrop(SpaceblockRequests),
Sync(library_id), File{library_id, file_path_id, range}, Http. We add
SyncRequest (the pull half the reference routes through the same Sync
stream) and Rspc (remote API, ref:core/src/p2p/operations/rspc.rs).
Round-trip unit tests mirror protocol.rs's own `#[test]`s (§4).

Counterpart of `spacedrive_tpu/p2p/protocol.py`: the same ten header
types and the same header bytes, trace and telemetry fields included.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass
from typing import Any

from .block import Range, SpaceblockRequests
from .wire import Reader, Writer


class HeaderType(enum.IntEnum):
    PING = 0
    SPACEDROP = 1
    SYNC = 2  # originator announces new ops for a library
    SYNC_REQUEST = 3  # responder pulls ops with watermarks
    FILE = 4
    HTTP = 5
    RSPC = 6
    PAIRING = 7  # library join request (ref: the reference's pairing flow)
    TELEMETRY = 8  # pull the peer's compact telemetry snapshot (federation)
    WORK = 9  # work-stealing shard exchange for a library (p2p/work.py)


@dataclass
class FileRequest:
    """ref:protocol.rs `Header::File` (operations/request_file.rs:29)."""

    library_id: uuid.UUID
    file_path_pub_id: uuid.UUID
    range: Range


@dataclass
class Header:
    type: HeaderType
    library_id: uuid.UUID | None = None  # SYNC / SYNC_REQUEST
    spacedrop: SpaceblockRequests | None = None  # SPACEDROP
    file: FileRequest | None = None  # FILE
    # distributed-trace context (telemetry.trace wire dict) riding the
    # sync and spacedrop openers, so the remote node's spans join the
    # initiator's trace; {} on the wire means "no context". NOTE: this
    # protocol has no version negotiation (SYNC_REQUEST/RSPC/PAIRING
    # were likewise added flag-day) — every peer in a mesh must run the
    # same wire revision; a cross-revision handshake would have to land
    # before any rolling-upgrade story.
    trace: dict | None = None
    # TELEMETRY sub-operation ({} = the default snapshot pull):
    # {"op": "trace_pull", "trace_id": "<hex>"} asks the responder for
    # its completed spans of one distributed trace (critical-path
    # attribution, telemetry/attrib.py) — same flag-day discipline as
    # `trace` above
    telemetry_op: dict | None = None

    async def write(self, stream: Any) -> None:
        w = Writer(stream)
        w.u8(int(self.type))
        if self.type in (HeaderType.SYNC, HeaderType.SYNC_REQUEST,
                         HeaderType.WORK):
            assert self.library_id is not None
            w.uuid(self.library_id)
            w.msgpack(self.trace or {})
        elif self.type == HeaderType.SPACEDROP:
            assert self.spacedrop is not None
            w.msgpack(self.spacedrop.to_wire())
            w.msgpack(self.trace or {})
        elif self.type == HeaderType.FILE:
            assert self.file is not None
            w.uuid(self.file.library_id)
            w.uuid(self.file.file_path_pub_id)
            w.msgpack(self.file.range.to_wire())
        elif self.type == HeaderType.TELEMETRY:
            w.msgpack(self.trace or {})
            w.msgpack(self.telemetry_op or {})
        await w.flush()

    @classmethod
    async def read(cls, stream: Any) -> "Header":
        r = Reader(stream)
        t = HeaderType(await r.u8())
        if t in (HeaderType.SYNC, HeaderType.SYNC_REQUEST, HeaderType.WORK):
            lib_id = await r.uuid()
            return cls(t, library_id=lib_id, trace=(await r.msgpack()) or None)
        if t == HeaderType.SPACEDROP:
            sd = SpaceblockRequests.from_wire(await r.msgpack())
            return cls(t, spacedrop=sd, trace=(await r.msgpack()) or None)
        if t == HeaderType.FILE:
            return cls(
                t,
                file=FileRequest(
                    library_id=await r.uuid(),
                    file_path_pub_id=await r.uuid(),
                    range=Range.from_wire(await r.msgpack()),
                ),
            )
        if t == HeaderType.TELEMETRY:
            return cls(
                t,
                trace=(await r.msgpack()) or None,
                telemetry_op=(await r.msgpack()) or None,
            )
        return cls(t)
