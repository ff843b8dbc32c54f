"""Library statistics snapshot.

Parity: ref:core/src/library/statistics.rs `update_statistics` +
`Statistics` model (ref:core/prisma/schema.prisma:80-93): total object
count, library DB size, total bytes used (sum of file sizes), volume
capacity/free across mounted volumes, preview-media (thumbnail dir)
bytes. Stored as a single latest row in the `statistics` table; big
byte counts are TEXT columns like the reference (u64-as-string).

Counterpart of `spacedrive_tpu/node/statistics.py`.
"""

from __future__ import annotations

import os
from typing import Any

from ..db.database import LibraryDb, blob_u64
from .volumes import get_volumes


def _dir_size(path: str | None) -> int:
    if not path or not os.path.isdir(path):
        return 0
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def update_statistics(
    db: LibraryDb, thumbnails_dir: str | None = None
) -> dict[str, Any]:
    total_objects = db.count("object")
    # one table scan for both totals; unique bytes = one size per distinct
    # cas_id, aggregated in Python (sizes are LE blobs SQLite can't order)
    total_bytes_used = 0
    by_cas: dict[str, int] = {}
    for r in db.query("SELECT cas_id, size_in_bytes_bytes FROM file_path"):
        size = blob_u64(r["size_in_bytes_bytes"]) or 0
        total_bytes_used += size
        if r["cas_id"] is not None:
            by_cas.setdefault(r["cas_id"], size)
    total_unique_bytes = sum(by_cas.values())

    capacity = 0
    free = 0
    for v in get_volumes():
        capacity += v.total_bytes_capacity
        free += v.total_bytes_available

    db_size = 0
    if db.path != ":memory:":
        for suffix in ("", "-wal", "-shm"):
            try:
                db_size += os.path.getsize(db.path + suffix)
            except OSError:
                pass

    stats = {
        "total_object_count": total_objects,
        "library_db_size": str(db_size),
        "total_bytes_used": str(total_bytes_used),
        "total_bytes_capacity": str(capacity),
        "total_unique_bytes": str(total_unique_bytes),
        "total_bytes_free": str(free),
        "preview_media_bytes": str(_dir_size(thumbnails_dir)),
    }
    existing = db.query_one("SELECT id FROM statistics ORDER BY id DESC LIMIT 1")
    if existing:
        db.update("statistics", {"id": existing["id"]}, **stats)
    else:
        db.insert("statistics", **stats)
    return stats


def get_statistics(db: LibraryDb) -> dict[str, Any] | None:
    return db.query_one("SELECT * FROM statistics ORDER BY id DESC LIMIT 1")
