"""Normalized watcher events.

Parity: ref:core/src/location/manager/watcher/mod.rs — the per-OS
watchers (linux/macos/windows.rs) normalize raw notify events into the
same small vocabulary the event handler consumes: create/modify for
files and dirs, rename with both endpoints resolved (the reference's
rename tracker pairs partial events), and remove. `is_dir` reflects the
event target where knowable.

Counterpart of `spacedrive_tpu/location/watcher/events.py`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class EventKind(enum.Enum):
    CREATE = "create"
    MODIFY = "modify"
    RENAME = "rename"
    REMOVE = "remove"
    RESCAN = "rescan"  # events were lost (queue overflow) — reconcile


@dataclass(frozen=True)
class WatchEvent:
    kind: EventKind
    path: str  # absolute; for RENAME this is the NEW path
    old_path: str | None = None  # RENAME only
    is_dir: bool = False
