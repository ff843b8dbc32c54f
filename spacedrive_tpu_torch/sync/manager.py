"""Sync manager — the write/read sides of library replication.

Parity: ref:core/crates/sync/src/manager.rs — `write_ops` persists
domain rows and their crdt_operation rows in ONE transaction (:70-93);
`get_ops` pages ops after per-instance watermarks (:115-172); the
manager owns the library's HLC and instance identity and emits
SyncMessage events for the P2P layer.

Counterpart of `spacedrive_tpu/sync/manager.py`: the per-instance ingest
watermarks are loaded from the op log at start, and the replication
watermarks and lag (`sd_sync_lag_seconds`, `sd_sync_watermark_seconds`)
read them for the health and federation planes; ingest (sync/ingest.py)
advances them, and `get_ops` pages the op log after a peer's.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Callable, Iterable

from ..db.database import LibraryDb
from ..telemetry import metrics as _tm
from ..telemetry.peers import peer_label
from ..utils.events import EventBus
from ..utils.msgpack_codec import packb
from .crdt import CRDTOperation
from .factory import OperationFactory
from .hlc import NTP64, HybridLogicalClock

logger = logging.getLogger(__name__)


class SyncManager(OperationFactory):
    """One per library. Also the OperationFactory for local writes."""

    def __init__(
        self,
        db: LibraryDb,
        instance: uuid.UUID,
        event_bus: EventBus | None = None,
        emit_messages: bool = True,
    ):
        super().__init__(HybridLogicalClock(instance), instance)
        self.db = db
        self.event_bus = event_bus or EventBus()
        self.emit_messages = emit_messages
        # per-instance ingest watermarks (ref:manager.rs:29 `timestamps`)
        self.timestamps: dict[uuid.UUID, NTP64] = {}
        self._load_timestamps()

    # --- startup ---

    def _load_timestamps(self) -> None:
        rows = self.db.query(
            "SELECT i.pub_id, MAX(c.timestamp) AS ts FROM crdt_operation c "
            "JOIN instance i ON i.id = c.instance_id GROUP BY c.instance_id"
        )
        for row in rows:
            self.timestamps[uuid.UUID(bytes=row["pub_id"])] = NTP64(row["ts"])

    # --- replication observability ---

    def replication_watermarks(self) -> dict[str, float]:
        """Per-remote-instance latest applied HLC timestamp (unix
        seconds), keyed by the capped ``peer_label`` short-hash — the
        raw pub_id never reaches a metric label or a wire snapshot."""
        return {
            peer_label(inst): ts.as_unix()
            for inst, ts in self.timestamps.items()
            if inst != self.instance
        }

    def observe_replication_lag(self) -> dict[str, float]:
        """Refresh ``sd_sync_lag_seconds{peer}`` /
        ``sd_sync_watermark_seconds{peer}`` from the in-memory
        watermarks and return the lag map: wall-clock now minus the
        latest applied HLC timestamp from each peer. Called by the
        health and federation read paths so the gauges stay honest
        when no ops are flowing."""
        now = time.time()
        lags: dict[str, float] = {}
        for inst, ts in self.timestamps.items():
            if inst == self.instance:
                continue
            label = peer_label(inst)
            watermark = ts.as_unix()
            lag = max(0.0, now - watermark)
            lags[label] = lag
            _tm.SYNC_LAG.set(lag, peer=label)
            _tm.SYNC_WATERMARK.set(watermark, peer=label)
        return lags

    def _instance_db_id(self, instance: uuid.UUID) -> int:
        row = self.db.find_one("instance", pub_id=instance.bytes)
        if row is None:
            raise ValueError(f"unknown instance {instance}")
        return row["id"]

    # --- write side (ref:manager.rs:70-93) ---

    def write_ops(
        self,
        ops: list[CRDTOperation],
        db_writes: Callable[[Any], None] | None = None,
    ) -> None:
        """Atomically apply `db_writes(conn)` (domain rows) and persist
        `ops`; then notify subscribers (SyncMessage::Created)."""
        if not ops and db_writes is None:
            return
        instance_ids: dict[uuid.UUID, int] = {}
        with self.db.transaction() as conn:
            if db_writes is not None:
                db_writes(conn)
            for op in ops:
                iid = instance_ids.get(op.instance)
                if iid is None:
                    iid = self._instance_db_id(op.instance)
                    instance_ids[op.instance] = iid
                conn.execute(
                    "INSERT OR REPLACE INTO crdt_operation "
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
        if ops and self.emit_messages:
            self.event_bus.emit(("SyncMessage", "Created"))

    # --- read side (ref:manager.rs:115-172) ---

    def get_ops(
        self,
        count: int = 1000,
        clocks: Iterable[tuple[uuid.UUID, NTP64]] = (),
    ) -> list[CRDTOperation]:
        """Ops strictly after each instance's watermark, oldest first.
        `clocks` are the requesting peer's per-instance watermarks;
        instances not listed start from 0. Each instance's first `count`
        ops come off the (instance_id, timestamp) index and are merged,
        so a page costs O(page), not O(op log): JAX's single query
        (the instances' ranges OR'ed, then ordered) sorts every op past
        the watermarks on every page, which made a joiner's pull of a
        ~400k-op log quadratic. The same ops, in the same order."""
        clock_map = {inst: int(ts) for inst, ts in clocks}
        parts, params = [], []
        for row in self.db.query("SELECT id, pub_id FROM instance"):
            watermark = clock_map.get(uuid.UUID(bytes=row["pub_id"]), -1)
            parts.append("SELECT * FROM (SELECT timestamp, data FROM crdt_operation "
                         "WHERE instance_id = ? AND timestamp > ? ORDER BY timestamp LIMIT ?)")
            params.extend([row["id"], watermark, count])
        if not parts:
            return []
        rows = self.db.query(
            " UNION ALL ".join(parts) + " ORDER BY timestamp ASC LIMIT ?",
            (*params, count),
        )
        return [CRDTOperation.unpack(r["data"]) for r in rows]

    def get_cloud_ops(self, count: int = 1000) -> list[tuple[bytes, CRDTOperation]]:
        """Pending rows from the cloud receive cache
        (ref:core/src/cloud/sync/ingest.rs)."""
        rows = self.db.query(
            "SELECT id, data FROM cloud_crdt_operation ORDER BY timestamp ASC LIMIT ?",
            (count,),
        )
        return [(r["id"], CRDTOperation.unpack(r["data"])) for r in rows]


def _record_id_blob(record_id: Any) -> bytes:
    return packb(record_id)
