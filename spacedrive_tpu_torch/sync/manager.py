"""Sync manager — the write/read sides of library replication.

Parity: ref:core/crates/sync/src/manager.rs — `write_ops` persists
domain rows and their crdt_operation rows in ONE transaction (:70-93);
`get_ops` pages ops after per-instance watermarks (:115-172); the
manager owns the library's HLC and instance identity and emits
SyncMessage events for the P2P layer.

Counterpart of `spacedrive_tpu/sync/manager.py`, without the replication
lag gauges (telemetry).
"""

from __future__ import annotations

import logging
import uuid
from typing import Any, Callable

from ..db.database import LibraryDb
from ..utils.events import EventBus
from ..utils.msgpack_codec import packb
from .crdt import CRDTOperation
from .factory import OperationFactory
from .hlc import HybridLogicalClock

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

def _record_id_blob(record_id: Any) -> bytes:
    return packb(record_id)
