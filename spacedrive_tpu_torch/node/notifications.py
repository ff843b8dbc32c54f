"""Notifications — node- and library-scoped user notifications.

Parity: ref:core/src/notifications.rs + `Node::emit_notification`
(ref:core/src/lib.rs:258-278): library-scoped notifications persist to
the library `notification` table then push a `Notification{id, data}`
onto the node-wide channel; node-scoped ones are in-memory with a
monotonic counter. `data` carries kind/title/content like the
reference's `NotificationData`.

Counterpart of `spacedrive_tpu/node/notifications.py`; `data` is
stored as MessagePack from the port's own codec (utils/msgpack_codec.py),
byte-equal to the JAX package's rows.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any

from ..db.database import LibraryDb
from ..utils.events import EventBus
from ..utils.msgpack_codec import packb, unpackb


@dataclass(frozen=True)
class NotificationId:
    """ref:notifications.rs `NotificationId::{Node(u32), Library(Uuid, u32)}`."""

    library_id: str | None
    local_id: int


@dataclass
class Notification:
    id: NotificationId
    data: dict[str, Any]
    read: bool = False
    expires_at: str | None = None


class Notifications:
    def __init__(self, event_bus: EventBus | None = None):
        self.event_bus = event_bus or EventBus()
        self._node_counter = itertools.count(1)
        self._node_notifications: list[Notification] = []
        self._lock = threading.Lock()

    def emit_node(self, data: dict[str, Any]) -> Notification:
        """Node-scoped, in-memory (ref:lib.rs:258-266)."""
        n = Notification(NotificationId(None, next(self._node_counter)), data)
        with self._lock:
            self._node_notifications.append(n)
        self.event_bus.emit(("notification", n))
        return n

    def emit_library(
        self,
        db: LibraryDb,
        library_id: str,
        data: dict[str, Any],
        expires_at: str | None = None,
    ) -> Notification:
        """Library-scoped, persisted (ref:lib.rs:267-278)."""
        row_id = db.insert(
            "notification", data=packb(data), expires_at=expires_at
        )
        n = Notification(NotificationId(library_id, row_id), data, expires_at=expires_at)
        self.event_bus.emit(("notification", n))
        return n

    def list_node(self) -> list[Notification]:
        with self._lock:
            return list(self._node_notifications)

    @staticmethod
    def list_library(db: LibraryDb, library_id: str) -> list[Notification]:
        return [
            Notification(
                NotificationId(library_id, row["id"]),
                unpackb(row["data"]),
                read=bool(row["read"]),
                expires_at=row["expires_at"],
            )
            for row in db.query("SELECT * FROM notification ORDER BY id")
        ]

    @staticmethod
    def mark_read(db: LibraryDb, local_id: int) -> None:
        db.update("notification", {"id": local_id}, read=1)
