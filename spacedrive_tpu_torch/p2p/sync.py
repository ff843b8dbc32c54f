"""Device-to-device sync exchange over P2P streams.

Parity: ref:core/src/p2p/sync/mod.rs:22-70 — after any local
`write_ops`, the originator opens a stream per library peer with
`Header::Sync(library_id)` as a *new-ops alert*; the responder then
notifies its ingest actor, whose `request_ops` pulls with its
per-instance watermarks (`Vec<(instance, NTP64)>`) and receives an op
batch + has_more flag (the reference's `GetOpsArgs`/`Operations`
messages, msgpack-encoded like its rmp payloads).

Counterpart of `spacedrive_tpu/p2p/sync.py` over the port's `sync/`:
the same alert, pull and serve halves, byte for byte on the wire.
"""

from __future__ import annotations

import uuid
from typing import Any

from ..sync.crdt import CRDTOperation
from ..sync.hlc import NTP64
from ..sync.manager import SyncManager
from ..telemetry import trace as _trace
from .identity import RemoteIdentity
from .protocol import Header, HeaderType
from .wire import Reader, Writer


async def alert_new_ops(p2p: Any, identity: RemoteIdentity, library_id: uuid.UUID) -> None:
    """Originator half (ref:p2p/sync/mod.rs originator): fire-and-forget
    notification that this library has new ops."""
    stream = await p2p.new_stream(identity)
    try:
        await Header(
            HeaderType.SYNC, library_id=library_id,
            trace=_trace.wire_current(),
        ).write(stream)
        await Reader(stream).u8()  # 1-byte ack so the write isn't racing close
    finally:
        await stream.close()


async def request_ops_from_peer(
    p2p: Any,
    identity: RemoteIdentity,
    library_id: uuid.UUID,
    timestamps: list[tuple[uuid.UUID, NTP64]],
    count: int,
) -> tuple[list[CRDTOperation], bool]:
    """Responder's pull (the ingest actor's `request_ops` transport):
    send watermarks, receive one op page + has_more."""
    stream = await p2p.new_stream(identity)
    try:
        await Header(
            HeaderType.SYNC_REQUEST, library_id=library_id,
            trace=_trace.wire_current(),
        ).write(stream)
        w = Writer(stream)
        w.msgpack(
            {
                "clocks": [[inst.bytes, int(ts)] for inst, ts in timestamps],
                "count": count,
            }
        )
        await w.flush()
        resp = await Reader(stream).msgpack()
        ops = [CRDTOperation.unpack(raw) for raw in resp["ops"]]
        return ops, bool(resp["has_more"])
    finally:
        await stream.close()


async def respond_sync_request(stream: Any, sync: SyncManager) -> None:
    """Server half of the pull (ref:p2p/sync/mod.rs responder)."""
    req = await Reader(stream).msgpack()
    clocks = [
        (uuid.UUID(bytes=inst), NTP64(ts)) for inst, ts in req.get("clocks", [])
    ]
    count = int(req.get("count", 1000))
    ops = sync.get_ops(count=count, clocks=clocks)
    w = Writer(stream)
    w.msgpack({"ops": [op.pack() for op in ops], "has_more": len(ops) == count})
    await w.flush()
