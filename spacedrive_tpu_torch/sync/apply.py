"""Applying remote CRDT operations to the library DB.

Parity: the generated `ModelSyncData::from_op` appliers
(ref:crates/sync-generator/src/lib.rs:22-36 — model sync types map ops
to typed upserts) as used by the ingest actor
(ref:core/crates/sync/src/ingest.rs:146-166 `apply_op`).

Wire conventions (set by this framework's OperationFactory call sites):
- SHARED models identify records by their sync id — `pub_id` as a hex
  string (or `name`/`key` for label/preference).
- Foreign-key columns sync as the *target's* sync id and are resolved
  to local integer ids here; unknown targets get a placeholder row so
  ops can apply in any order (the later Create fills the fields in).
- RELATION models identify records by {"item": …, "group": …} of the
  two sides' sync ids (ref:crates/sync/src/factory.rs:71-105).
- u64 columns (file_path.size_in_bytes_bytes / inode) sync as ints and
  are stored as 8-byte LE blobs (schema convention, db/schema.py:5-8).

Counterpart of `spacedrive_tpu/sync/apply.py`: the same op applies to
the same rows. A shared row is found and written by its `rowid`, which
is its `id` in every table that has one; JAX's appliers read an `id`
column, so a `preference` op (a table keyed by `key`, with no `id`)
raises there, and applies here.
"""

from __future__ import annotations

import logging
import sqlite3
from typing import Any

from ..db.database import u64_blob
from ..db.sync_registry import SYNC_MODELS, ForeignRef, SyncKind, SyncModel
from .crdt import CREATE, DELETE, UPDATE, CRDTOperation

logger = logging.getLogger(__name__)

# columns stored as 8-byte LE blobs but synced as ints
_U64_COLUMNS = {
    "file_path": {"size_in_bytes_bytes", "inode"},
    "location": {"size_in_bytes"},
}


class ApplyError(Exception):
    pass


def _sync_id_to_key(model: SyncModel, record_id: Any) -> Any:
    """Wire sync id → DB value for the identity column."""
    if model.id_field == "pub_id":
        return bytes.fromhex(record_id)
    return record_id


def _resolve_fk(conn: sqlite3.Connection, fr: ForeignRef, sync_id: Any) -> int | None:
    """Target sync id → local integer id, creating a placeholder row for
    targets whose Create op hasn't arrived yet."""
    if sync_id is None:
        return None
    key = (
        bytes.fromhex(sync_id) if fr.target_id_field == "pub_id" else sync_id
    )
    row = conn.execute(
        f"SELECT id FROM {fr.table} WHERE {fr.target_id_field} = ?", (key,)
    ).fetchone()
    if row is not None:
        return row["id"]
    cur = conn.execute(
        f"INSERT INTO {fr.table} ({fr.target_id_field}) VALUES (?)", (key,)
    )
    return cur.lastrowid


def _db_value(
    conn: sqlite3.Connection, model: SyncModel, col: str, value: Any
) -> tuple[str, Any]:
    """(column, value) as stored locally for one synced field."""
    for fr in model.foreign_refs:
        if fr.column == col:
            return col, _resolve_fk(conn, fr, value)
    if value is not None and col in _U64_COLUMNS.get(model.name, ()):
        return col, u64_blob(int(value))
    return col, value


def _shared_row_id(
    conn: sqlite3.Connection, model: SyncModel, record_id: Any, create: bool
) -> int | None:
    """Local row id for a SHARED record, optionally creating it."""
    if model.id_ref is not None:
        # identity lives through an FK (media_data → object.pub_id)
        fk = _resolve_fk(conn, model.id_ref, record_id)
        row = conn.execute(
            f"SELECT rowid AS id FROM {model.name} WHERE {model.id_ref.column} = ?", (fk,)
        ).fetchone()
        if row is not None:
            return row["id"]
        if not create:
            return None
        return conn.execute(
            f"INSERT INTO {model.name} ({model.id_ref.column}) VALUES (?)", (fk,)
        ).lastrowid
    key = _sync_id_to_key(model, record_id)
    row = conn.execute(
        f"SELECT rowid AS id FROM {model.name} WHERE {model.id_field} = ?", (key,)
    ).fetchone()
    if row is not None:
        return row["id"]
    if not create:
        return None
    return conn.execute(
        f"INSERT INTO {model.name} ({model.id_field}) VALUES (?)", (key,)
    ).lastrowid


def _relation_keys(
    conn: sqlite3.Connection, model: SyncModel, record_id: Any
) -> tuple[int | None, int | None]:
    assert model.item is not None and model.group is not None
    if not isinstance(record_id, dict):
        raise ApplyError(f"relation record_id must be a dict: {record_id!r}")
    return (
        _resolve_fk(conn, model.item, record_id.get("item")),
        _resolve_fk(conn, model.group, record_id.get("group")),
    )


def apply_op(conn: sqlite3.Connection, op: CRDTOperation) -> None:
    """Apply one remote op inside the caller's transaction."""
    model = SYNC_MODELS.get(op.model)
    if model is None or model.kind is SyncKind.LOCAL:
        raise ApplyError(f"model does not sync: {op.model}")

    if model.kind is SyncKind.SHARED:
        if op.data.kind == CREATE:
            _shared_row_id(conn, model, op.record_id, create=True)
        elif op.data.kind == UPDATE:
            rid = _shared_row_id(conn, model, op.record_id, create=True)
            col, val = _db_value(conn, model, op.data.field_name, op.data.value)
            if col in model.local_fields:
                return  # @local fields never apply from remote
            conn.execute(
                f"UPDATE {model.name} SET {col} = ? WHERE rowid = ?", (val, rid)
            )
        elif op.data.kind == DELETE:
            rid = _shared_row_id(conn, model, op.record_id, create=False)
            if rid is not None:
                conn.execute(f"DELETE FROM {model.name} WHERE rowid = ?", (rid,))
        return

    # RELATION (tag_on_object / label_on_object)
    item_id, group_id = _relation_keys(conn, model, op.record_id)
    item_col = model.item.column
    group_col = model.group.column
    if op.data.kind == CREATE:
        conn.execute(
            f"INSERT OR IGNORE INTO {model.name} ({item_col}, {group_col}) "
            "VALUES (?, ?)",
            (item_id, group_id),
        )
    elif op.data.kind == UPDATE:
        conn.execute(
            f"INSERT OR IGNORE INTO {model.name} ({item_col}, {group_col}) "
            "VALUES (?, ?)",
            (item_id, group_id),
        )
        conn.execute(
            f"UPDATE {model.name} SET {op.data.field_name} = ? "
            f"WHERE {item_col} = ? AND {group_col} = ?",
            (op.data.value, item_id, group_id),
        )
    elif op.data.kind == DELETE:
        conn.execute(
            f"DELETE FROM {model.name} WHERE {item_col} = ? AND {group_col} = ?",
            (item_id, group_id),
        )
