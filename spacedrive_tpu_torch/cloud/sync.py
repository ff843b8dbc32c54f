"""Cloud sync actors — Sender / Receiver / Ingester per library.

Counterpart of `spacedrive_tpu/cloud/sync.py`
(ref:core/src/cloud/sync/{mod.rs,send.rs,receive.rs,ingest.rs}): three
actors declared per library when the CloudSync feature is on
(mod.rs:14-68): the **Sender** pushes this instance's ops past its
cloud watermark as packed collections (send.rs:13); the **Receiver**
polls the relay for other instances' collections and caches them into
the `cloud_crdt_operation` table (receive.rs:24-207), registering
unknown instances; the **Ingester** drains that cache through the
normal `receive_crdt_operation` path, `OPS_PER_REQUEST = 1000` per tick
(ingest.rs:8-21), deleting rows as they apply.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any

from ..db.database import now_iso
from ..sync.crdt import CompressedCRDTOperations
from ..sync.hlc import NTP64
from ..sync.ingest import receive_crdt_operation
from ..sync.manager import SyncManager, _record_id_blob
from ..telemetry import span as _span
from ..utils.resilience import BreakerOpen
from .api import CloudApiError, CloudClient

logger = logging.getLogger(__name__)

OPS_PER_REQUEST = 1000  # ref:core/src/cloud/sync/ingest.rs:21
POLL_INTERVAL = 1.0


class CloudSync:
    """The per-library actor trio (ref:cloud/sync/mod.rs declare_actors)."""

    def __init__(
        self,
        library: Any,
        client: CloudClient,
        *,
        poll_interval: float = POLL_INTERVAL,
    ):
        self.library = library
        self.sync: SyncManager = library.sync
        self.client = client
        self.poll_interval = poll_interval
        self._tasks: list[asyncio.Task] = []
        self._stopped = False
        self._notify = asyncio.Event()
        # watermarks
        self._sent_timestamp = NTP64(0)  # sender: last pushed local ts
        self._cursors: dict[str, int] = {}  # receiver: per-instance col id
        self.sent_ops = 0
        self.received_collections = 0
        self.ingested_ops = 0

    # --- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        """Register library+instance with the relay, then run the trio."""
        lib_id = str(self.library.id)
        await self.client.create_library(lib_id, self.library.name)
        await self.client.add_instance(
            lib_id, str(self.sync.instance)
        )
        # resume the sender watermark: everything already pushed is
        # whatever the relay has seen; simplest correct resume is to
        # re-push from 0 — receivers dedupe via is_operation_old
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._sender(), name="cloud-send"),
            loop.create_task(self._receiver(), name="cloud-receive"),
            loop.create_task(self._ingester(), name="cloud-ingest"),
        ]
        self._unsub = self.library.event_bus.on(self._on_event)

    def _on_event(self, event: Any) -> None:
        if event == ("SyncMessage", "Created"):
            self._notify.set()

    async def shutdown(self) -> None:
        self._stopped = True
        if hasattr(self, "_unsub"):
            self._unsub()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

    # --- sender (ref:send.rs) ------------------------------------------

    async def _sender(self) -> None:
        while not self._stopped:
            try:
                await self._send_tick()
            except (CloudApiError, BreakerOpen, asyncio.TimeoutError) as e:
                # expected while the relay is down / breaker-gated: the
                # next tick (or the breaker's half-open probe) retries
                logger.debug("cloud send failed: %s", e)
            except Exception:
                logger.exception("cloud sender crashed; continuing")
            try:
                await asyncio.wait_for(self._notify.wait(), self.poll_interval)
            except asyncio.TimeoutError:
                pass
            self._notify.clear()

    async def _send_tick(self) -> None:
        me = self.sync.instance
        while True:
            # only THIS instance's ops: mask every other instance out of
            # the page with a max watermark (send.rs pushes own ops only)
            clocks: list[tuple[uuid.UUID, NTP64]] = [(me, self._sent_timestamp)]
            for row in self.library.db.query("SELECT pub_id FROM instance"):
                other = uuid.UUID(bytes=row["pub_id"])
                if other != me:
                    clocks.append((other, NTP64((1 << 63) - 1)))
            ops = [
                op
                for op in self.sync.get_ops(
                    count=OPS_PER_REQUEST, clocks=clocks
                )
                if op.instance == me
            ]
            if not ops:
                return
            packed = CompressedCRDTOperations.compress(ops).pack()
            # the span installs a trace context, so the push carries it
            # to the relay (X-SD-Trace) and relay.push joins this trace
            async with _span("cloud.send", nbytes=len(packed)):
                await self.client.push_ops(
                    str(self.library.id), str(me), packed
                )
            self._sent_timestamp = ops[-1].timestamp
            self.sent_ops += len(ops)
            if len(ops) < OPS_PER_REQUEST:
                return

    # --- receiver (ref:receive.rs) -------------------------------------

    async def _receiver(self) -> None:
        while not self._stopped:
            try:
                await self._receive_tick()
            except (CloudApiError, BreakerOpen, asyncio.TimeoutError) as e:
                logger.debug("cloud receive failed: %s", e)
            except Exception:
                logger.exception("cloud receiver crashed; continuing")
            await asyncio.sleep(self.poll_interval)

    async def _receive_tick(self) -> None:
        collections = await self.client.pull_ops(
            str(self.library.id),
            str(self.sync.instance),
            dict(self._cursors),
        )
        for col in collections:
            ops = CompressedCRDTOperations.unpack(col["contents"]).expand()
            self._store_cloud_ops(ops)
            self._cursors[col["instance_uuid"]] = col["id"]
            self.received_collections += 1

    def _store_cloud_ops(self, ops: list[Any]) -> None:
        """Cache into cloud_crdt_operation (ref:receive.rs:24-207),
        creating instance rows for unseen instances."""
        db = self.library.db
        for op in ops:
            inst = db.find_one("instance", pub_id=op.instance.bytes)
            if inst is None:
                now = now_iso()
                iid = db.insert(
                    "instance",
                    pub_id=op.instance.bytes,
                    identity=b"",
                    node_id=b"",
                    node_name="",
                    node_platform=0,
                    last_seen=now,
                    date_created=now,
                )
            else:
                iid = inst["id"]
            db.execute(
                "INSERT OR IGNORE INTO cloud_crdt_operation "
                "(id, timestamp, model, record_id, kind, data, instance_id) "
                "VALUES (?, ?, ?, ?, ?, ?, ?)",
                (
                    op.id.bytes,
                    int(op.timestamp),
                    op.model,
                    _record_id_blob(op.record_id),
                    op.kind(),
                    op.pack(),
                    iid,
                ),
            )

    # --- ingester (ref:ingest.rs) --------------------------------------

    async def _ingester(self) -> None:
        while not self._stopped:
            try:
                applied = await asyncio.to_thread(self._ingest_tick)
                if applied:
                    continue  # drain the cache without sleeping
            except Exception:
                logger.exception("cloud ingester crashed; continuing")
            await asyncio.sleep(self.poll_interval)

    def _ingest_tick(self) -> int:
        rows = self.sync.get_cloud_ops(count=OPS_PER_REQUEST)
        applied = 0
        for op_id, op in rows:
            receive_crdt_operation(self.sync, op)
            self.library.db.delete("cloud_crdt_operation", id=op_id)
            applied += 1
        if applied:
            self.ingested_ops += applied
            self.library.event_bus.emit(("SyncMessage", "Ingested"))
        return applied
