"""P2P operations — ping, Spacedrop, request_file.

Parity: ref:core/src/p2p/operations/{ping.rs,spacedrop.rs,request_file.rs}.
Spacedrop keeps the reference's flow (spacedrop.rs:28-203): sender
opens a stream, writes `Header::Spacedrop(requests)`, then blocks on a
single accept(1)/reject(0) byte driven by the remote user's dialog
(frontend subscribes via the event bus and resolves through
`accept_spacedrop`/`reject_spacedrop`); on accept the Spaceblock
transfer runs. `request_file` streams one file range out of a library
by `file_path` pub_id (request_file.rs:29-102).

Counterpart of `spacedrive_tpu/p2p/operations.py`: ping, Spacedrop
(send, progress, cancel, the inbound offer, accept, reject), the
telemetry, trace and profile pulls and their responders, and
`request_file` / `respond_file`, with the same bytes on the wire.
"""

from __future__ import annotations

import asyncio
import io
import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

from ..telemetry import trace as _trace
from ..utils.resilience import FAIL, PASS, ResiliencePolicy, RetryPolicy
from .block import BlockSize, Range, SpaceblockRequest, SpaceblockRequests, Transfer
from .identity import RemoteIdentity
from .protocol import FileRequest, Header, HeaderType
from .wire import Reader, Writer

SPACEDROP_TIMEOUT = 60.0  # ref:spacedrop.rs user-decision timeout

# Connection-establishment leg only: once the remote user's dialog is
# in play, retrying would re-prompt them — the transfer itself stays
# single-shot. The breaker keeps repeated sends to a gone peer cheap.
SPACEDROP_POLICY = ResiliencePolicy(
    "spacedrop",
    RetryPolicy(max_attempts=3, base_delay=0.1, max_delay=1.0,
                attempt_timeout=15.0),
    failure_threshold=3,
    reset_timeout=15.0,
)

def _file_classify(exc: BaseException) -> str:
    """A peer that ANSWERED — file not found, refusal — is healthy;
    only transport failures may feed the breaker (otherwise three
    honest not-founds would block files the peer DOES have)."""
    if isinstance(exc, (FileNotFoundError, PermissionError, ValueError)):
        return PASS
    return FAIL  # single-shot policy: count it, never re-run the body


# Remote-file streaming stays SINGLE-shot (a retry mid-transfer would
# duplicate bytes already written into the caller's sink) and UNBOUNDED
# in duration (a 10 GB pull over a slow link is legitimate; the old
# direct call had no deadline either) — the policy contributes only the
# per-peer breaker, so an explorer browse against a gone peer
# fast-fails once instead of paying a dial timeout per row.
FILE_POLICY = ResiliencePolicy(
    "p2p_file",
    RetryPolicy(max_attempts=1, base_delay=0.05, max_delay=0.1,
                attempt_timeout=None),
    failure_threshold=3,
    reset_timeout=15.0,
    classify=_file_classify,
)


async def ping(p2p: Any, identity: RemoteIdentity) -> float:
    """Round-trip a Ping header (ref:operations/ping.rs)."""
    import time

    stream = await p2p.new_stream(identity)
    try:
        t0 = time.monotonic()
        await Header(HeaderType.PING).write(stream)
        pong = await Reader(stream).u8()
        if pong != 0xAA:
            raise ValueError("bad pong")
        return time.monotonic() - t0
    finally:
        await stream.close()


@dataclass
class SpacedropRequest:
    """An inbound offer pending user decision (ref:spacedrop.rs:160-203)."""

    id: uuid.UUID
    peer: RemoteIdentity
    files: list[str]
    total_size: int
    _decision: asyncio.Future = field(repr=False, default=None)  # type: ignore[assignment]


class SpacedropManager:
    """Hangs off P2PManager: outbound sends + inbound accept/reject map
    keyed by request id (ref:spacedrop.rs `spacedrop_pairing_reqs`)."""

    def __init__(self, p2p: Any, event_bus: Any = None, save_dir: str | None = None):
        self.p2p = p2p
        self.event_bus = event_bus
        self.save_dir = save_dir or os.path.expanduser("~/Downloads")
        self.pending: dict[uuid.UUID, SpacedropRequest] = {}
        self.progress: dict[uuid.UUID, int] = {}
        self._cancel: dict[uuid.UUID, asyncio.Event] = {}

    # --- outbound (ref:spacedrop.rs:28-110) ---

    async def send(self, identity: RemoteIdentity, paths: list[str]) -> uuid.UUID:
        sizes = [os.path.getsize(p) for p in paths]
        requests = SpaceblockRequests(
            id=uuid.uuid4(),
            block_size=BlockSize.from_file_size(max(sizes, default=0)),
            requests=[
                SpaceblockRequest(name=os.path.basename(p), size=s)
                for p, s in zip(paths, sizes)
            ],
        )
        stream = await SPACEDROP_POLICY.call(
            str(identity), lambda: self.p2p.new_stream(identity)
        )
        cancel = asyncio.Event()
        self._cancel[requests.id] = cancel
        try:
            await Header(
                HeaderType.SPACEDROP, spacedrop=requests,
                trace=_trace.wire_current(),
            ).write(stream)
            decision = await asyncio.wait_for(
                Reader(stream).u8(), SPACEDROP_TIMEOUT
            )
            if decision != 1:
                raise PermissionError("spacedrop rejected by peer")
            transfer = Transfer(
                requests,
                on_progress=lambda pct: self._on_progress(requests.id, pct),
                cancelled=cancel,
            )
            files: list = []
            try:
                # opened inside the try: a failing open midway must not
                # leak the handles already opened
                for p in paths:
                    files.append(await asyncio.to_thread(open, p, "rb"))
                await transfer.send(stream, files)
            finally:
                for f in files:
                    f.close()
            return requests.id
        finally:
            self._cancel.pop(requests.id, None)
            await stream.close()

    def _on_progress(self, drop_id: uuid.UUID, pct: int) -> None:
        self.progress[drop_id] = pct
        if self.event_bus is not None:
            self.event_bus.emit(("SpacedropProgress", drop_id, pct))

    def cancel(self, drop_id: uuid.UUID) -> None:
        ev = self._cancel.get(drop_id)
        if ev is not None:
            ev.set()

    # --- inbound (ref:spacedrop.rs:160-203 `receiver`) ---

    async def handle_inbound(self, stream: Any, requests: SpaceblockRequests) -> None:
        loop = asyncio.get_running_loop()
        req = SpacedropRequest(
            id=requests.id,
            peer=stream.remote_identity,
            files=[r.name for r in requests.requests],
            total_size=requests.total_size,
            _decision=loop.create_future(),
        )
        self.pending[req.id] = req
        if self.event_bus is not None:
            self.event_bus.emit(("SpacedropRequest", req))
        w = Writer(stream)
        try:
            dest = await asyncio.wait_for(req._decision, SPACEDROP_TIMEOUT)
        except asyncio.TimeoutError:
            dest = None
        finally:
            self.pending.pop(req.id, None)
        if dest is None:
            w.u8(0)
            await w.flush()
            return
        w.u8(1)
        await w.flush()
        os.makedirs(dest, exist_ok=True)
        cancel = asyncio.Event()
        self._cancel[req.id] = cancel
        transfer = Transfer(
            requests,
            on_progress=lambda pct: self._on_progress(req.id, pct),
            cancelled=cancel,
        )
        sinks: list = []
        try:
            # opened inside the try: a failing open midway must not leak
            # the handles already opened
            for r in requests.requests:
                sinks.append(await asyncio.to_thread(
                    open, os.path.join(dest, os.path.basename(r.name)), "wb"
                ))
            await transfer.receive(stream, sinks)
        finally:
            self._cancel.pop(req.id, None)
            for s in sinks:
                s.close()

    def accept(self, drop_id: uuid.UUID, dest_dir: str | None = None) -> bool:
        """rspc `p2p.acceptSpacedrop` with a target dir (ref:spacedrop.rs)."""
        req = self.pending.get(drop_id)
        if req is None or req._decision.done():
            return False
        req._decision.set_result(dest_dir or self.save_dir)
        return True

    def reject(self, drop_id: uuid.UUID) -> bool:
        req = self.pending.get(drop_id)
        if req is None or req._decision.done():
            return False
        req._decision.set_result(None)
        return True


TELEMETRY_TIMEOUT = 10.0


async def request_telemetry(p2p: Any, identity: RemoteIdentity) -> dict:
    """Pull a peer's compact telemetry snapshot (the federation wire
    request; see telemetry/federation.py). The responder builds the
    snapshot on its side — nothing secret rides it — and this side
    validates the version before trusting the shape."""
    from ..telemetry.federation import snapshot_compatible
    from ..utils.compat import timeout

    stream = await p2p.new_stream(identity)
    try:
        async with timeout(TELEMETRY_TIMEOUT):
            await Header(
                HeaderType.TELEMETRY, trace=_trace.wire_current()
            ).write(stream)
            snap = await Reader(stream).msgpack()
    finally:
        await stream.close()
    if isinstance(snap, dict) and "v" not in snap and snap.get("error"):
        # the responder refused (e.g. we are not a library member there)
        raise PermissionError(str(snap["error"]))
    if not snapshot_compatible(snap):
        raise ValueError(
            f"peer served an incompatible telemetry snapshot "
            f"(v={snap.get('v') if isinstance(snap, dict) else '?'})"
        )
    return snap


async def respond_telemetry(stream: Any, node: Any) -> None:
    """Server half: serve this node's snapshot. The snapshot is built
    by the owning node (metrics values, health verdicts, ring digests
    — no ring payloads), so nothing needing redaction crosses here."""
    from ..telemetry.federation import local_snapshot

    w = Writer(stream)
    w.msgpack(_wireable_snapshot(local_snapshot(node)))
    await w.flush()


#: spans shipped per trace_pull response — a full trace ring is 4096
#: records; one pass's share is far smaller, and the cap bounds what a
#: member can make us serialize per exchange
TRACE_PULL_MAX_SPANS = 2048


async def request_trace(p2p: Any, identity: RemoteIdentity,
                        trace_id: str) -> list[dict]:
    """Pull a peer's completed spans for one distributed trace (the
    ``trace_pull`` TELEMETRY op — critical-path attribution assembly,
    telemetry/attrib.py). Raises ``PermissionError`` on a membership
    refusal, ``ValueError`` on a malformed response — both PASS through
    the caller's resilience policy without feeding the breaker."""
    from ..utils.compat import timeout

    stream = await p2p.new_stream(identity)
    try:
        async with timeout(TELEMETRY_TIMEOUT):
            await Header(
                HeaderType.TELEMETRY, trace=_trace.wire_current(),
                telemetry_op={"op": "trace_pull", "trace_id": str(trace_id)},
            ).write(stream)
            resp = await Reader(stream).msgpack()
    finally:
        await stream.close()
    if isinstance(resp, dict) and resp.get("error"):
        raise PermissionError(str(resp["error"]))
    if not isinstance(resp, dict) or not isinstance(resp.get("spans"), list):
        raise ValueError("peer served a malformed trace_pull response")
    return [s for s in resp["spans"] if isinstance(s, dict)]


async def respond_trace(stream: Any, trace_id: Any) -> None:
    """Server half of ``trace_pull``: this node's span records for one
    trace id, straight off the trace ring (bounded). Span records carry
    stages, ids, and timings — no payloads, paths, or secrets — so
    nothing needing redaction crosses here."""
    from ..telemetry import trace as _trace_mod

    w = Writer(stream)
    if not isinstance(trace_id, str) or not trace_id:
        w.msgpack({"error": "trace_pull requires a trace_id"})
        await w.flush()
        return
    spans = _trace_mod.recent(trace_id)[-TRACE_PULL_MAX_SPANS:]
    w.msgpack({"spans": _wireable_snapshot(spans)})
    await w.flush()


async def request_profile(p2p: Any, identity: RemoteIdentity) -> dict:
    """Pull a peer's host-profile document + folded collapsed-stack
    text (the ``profile_pull`` TELEMETRY op — ``sdx profile --peer``
    and the mesh-profile view). Raises ``PermissionError`` on a
    membership refusal, ``ValueError`` on a malformed response — both
    PASS through the caller's resilience policy without feeding the
    breaker."""
    from ..utils.compat import timeout

    stream = await p2p.new_stream(identity)
    try:
        async with timeout(TELEMETRY_TIMEOUT):
            await Header(
                HeaderType.TELEMETRY, trace=_trace.wire_current(),
                telemetry_op={"op": "profile_pull"},
            ).write(stream)
            resp = await Reader(stream).msgpack()
    finally:
        await stream.close()
    if isinstance(resp, dict) and resp.get("error"):
        raise PermissionError(str(resp["error"]))
    if not isinstance(resp, dict) or not isinstance(resp.get("profile"),
                                                    dict):
        raise ValueError("peer served a malformed profile_pull response")
    return resp


async def respond_profile(stream: Any) -> None:
    """Server half of ``profile_pull``: this node's profile document
    and bounded folded text. Frame names are ``module:function`` only
    (sampler.fold_stack strips paths), so nothing needing redaction
    crosses here — the same contract trace_pull makes for spans."""
    from ..telemetry import sampler as _sampler

    w = Writer(stream)
    w.msgpack(_wireable_snapshot({
        "profile": _sampler.SAMPLER.profile(),
        "folded": _sampler.SAMPLER.folded(max_bytes=128 * 1024),
    }))
    await w.flush()


def _wireable_snapshot(obj: Any) -> Any:
    """msgpack-encodable projection (floats/str/ints pass, odd leaves
    stringify) — snapshots must never fail to serialize."""
    if isinstance(obj, dict):
        return {str(k): _wireable_snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_wireable_snapshot(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


async def request_file(
    p2p: Any,
    identity: RemoteIdentity,
    library_id: uuid.UUID,
    file_path_pub_id: uuid.UUID,
    sink: io.RawIOBase | Any,
    range: Range | None = None,
) -> int:
    """Pull one file (range) from a remote library
    (ref:operations/request_file.rs:29-102)."""
    rng = range or Range()
    stream = await p2p.new_stream(identity)
    try:
        await Header(
            HeaderType.FILE,
            file=FileRequest(library_id, file_path_pub_id, rng),
        ).write(stream)
        r = Reader(stream)
        ok = await r.u8()
        if ok != 1:
            err = await r.string()
            raise FileNotFoundError(err)
        size = await r.u64()
        block_size = BlockSize.dangerously_new(await r.u32())
        requests = SpaceblockRequests(
            id=uuid.uuid4(),
            block_size=block_size,
            requests=[SpaceblockRequest(name="file", size=size, range=rng)],
        )
        await Transfer(requests).receive(stream, [sink])
        return size
    finally:
        await stream.close()


async def respond_file(stream: Any, req: FileRequest, libraries: Any) -> None:
    """Server half of `request_file` (ref:request_file.rs receiver)."""
    w = Writer(stream)
    lib = libraries.get(req.library_id)
    row = None
    if lib is not None:
        row = lib.db.find_one("file_path", pub_id=req.file_path_pub_id.bytes)
    path = None
    if row is not None:
        from ..files.isolated_path import full_path_from_db_row

        loc = lib.db.find_one("location", id=row["location_id"])
        if loc is not None:
            path = full_path_from_db_row(loc["path"], row)
    if path is None or not os.path.isfile(path):
        w.u8(0).string("file not found")
        await w.flush()
        return
    size = os.path.getsize(path)
    bs = BlockSize.from_file_size(size)
    w.u8(1).u64(size).u32(bs.size)
    await w.flush()
    requests = SpaceblockRequests(
        id=uuid.uuid4(),
        block_size=bs,
        requests=[SpaceblockRequest(name="file", size=size, range=req.range)],
    )
    fh = await asyncio.to_thread(open, path, "rb")
    try:
        await Transfer(requests).send(stream, [fh])
    finally:
        fh.close()
