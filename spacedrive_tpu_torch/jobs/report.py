"""JobReport + JobStatus + progress events.

Parity: ref:core/src/job/report.rs (status ints are DB/wire-stable,
:263-271) and the JobProgressEvent shape streamed to the frontend
(ref:core/src/job/worker.rs:39-50).

Counterpart of `spacedrive_tpu/jobs/report.py`.
"""

from __future__ import annotations

import datetime as _dt
import enum
import uuid
from dataclasses import dataclass, field
from typing import Any

from ..db.database import LibraryDb, now_iso
from ..utils.msgpack_codec import packb, unpackb


class JobStatus(enum.IntEnum):
    QUEUED = 0
    RUNNING = 1
    COMPLETED = 2
    CANCELED = 3
    FAILED = 4
    PAUSED = 5
    COMPLETED_WITH_ERRORS = 6

    @property
    def is_finished(self) -> bool:
        return self in (
            JobStatus.COMPLETED,
            JobStatus.CANCELED,
            JobStatus.PAUSED,
            JobStatus.FAILED,
            JobStatus.COMPLETED_WITH_ERRORS,
        )


@dataclass
class JobProgressEvent:
    """Streamed on every progress change (ref:core/src/job/worker.rs:39-50)."""

    id: uuid.UUID
    library_id: uuid.UUID | None
    name: str
    task_count: int
    completed_task_count: int
    phase: str
    message: str
    estimated_completion: str  # ISO timestamp


@dataclass
class JobReport:
    id: uuid.UUID
    name: str
    action: str | None = None
    data: bytes | None = None          # serialized resume state
    metadata: dict[str, Any] = field(default_factory=dict)
    errors_text: list[str] = field(default_factory=list)
    created_at: str | None = None
    started_at: str | None = None
    completed_at: str | None = None
    parent_id: uuid.UUID | None = None
    status: JobStatus = JobStatus.QUEUED
    task_count: int = 0
    completed_task_count: int = 0
    phase: str = ""
    message: str = ""
    estimated_completion: str | None = None

    # --- persistence (job table, ref:core/prisma/schema.prisma:401-430) ---

    def create(self, db: LibraryDb) -> None:
        self.created_at = self.created_at or now_iso()
        db.insert(
            "job",
            id=self.id.bytes,
            name=self.name,
            action=self.action,
            status=int(self.status),
            errors_text="\n\n".join(self.errors_text) or None,
            data=self.data,
            metadata=_pack_meta(self.metadata),
            parent_id=self.parent_id.bytes if self.parent_id else None,
            task_count=self.task_count,
            completed_task_count=self.completed_task_count,
            date_estimated_completion=self.estimated_completion,
            date_created=self.created_at,
            date_started=self.started_at,
            date_completed=self.completed_at,
        )

    def update(self, db: LibraryDb) -> None:
        db.update(
            "job",
            {"id": self.id.bytes},
            status=int(self.status),
            errors_text="\n\n".join(self.errors_text) or None,
            data=self.data,
            metadata=_pack_meta(self.metadata),
            task_count=self.task_count,
            completed_task_count=self.completed_task_count,
            date_estimated_completion=self.estimated_completion,
            date_started=self.started_at,
            date_completed=self.completed_at,
        )

    @classmethod
    def from_row(cls, row: dict[str, Any]) -> "JobReport":
        return cls(
            id=uuid.UUID(bytes=row["id"]),
            name=row["name"] or "",
            action=row["action"],
            data=row["data"],
            metadata=_unpack_meta(row["metadata"]),
            errors_text=(row["errors_text"] or "").split("\n\n") if row["errors_text"] else [],
            created_at=row["date_created"],
            started_at=row["date_started"],
            completed_at=row["date_completed"],
            parent_id=uuid.UUID(bytes=row["parent_id"]) if row["parent_id"] else None,
            status=JobStatus(row["status"] if row["status"] is not None else 0),
            task_count=row["task_count"] or 0,
            completed_task_count=row["completed_task_count"] or 0,
            estimated_completion=row["date_estimated_completion"],
        )

    def progress_event(self, library_id: uuid.UUID | None = None) -> JobProgressEvent:
        eta = self.estimated_completion or now_iso()
        return JobProgressEvent(
            id=self.id,
            library_id=library_id,
            name=self.name,
            task_count=self.task_count,
            completed_task_count=self.completed_task_count,
            phase=self.phase,
            message=self.message,
            estimated_completion=eta,
        )

    def estimate_completion(self, elapsed_seconds: float) -> None:
        """ETA by linear extrapolation over completed tasks."""
        remaining = max(0, self.task_count - self.completed_task_count)
        if self.completed_task_count > 0 and remaining:
            per = elapsed_seconds / self.completed_task_count
            eta = _dt.datetime.now(_dt.timezone.utc) + _dt.timedelta(seconds=per * remaining)
            self.estimated_completion = eta.isoformat(timespec="milliseconds")


def _pack_meta(meta: dict[str, Any]) -> bytes | None:
    if not meta:
        return None
    return packb(meta)


def _unpack_meta(raw: bytes | None) -> dict[str, Any]:
    if not raw:
        return {}
    return unpackb(raw)
