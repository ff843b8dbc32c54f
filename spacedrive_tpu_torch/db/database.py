"""LibraryDb — thread-safe SQLite access for one library.

Counterpart of `spacedrive_tpu/db/database.py`, with its `db.slow`
fault point on the read path.

The reference connects one SQLite file per library through a typed
Prisma client (ref:core/src/library/manager/mod.rs library load). Here:
WAL-mode sqlite3 with a single writer lock, dict rows, tiny typed
helpers (insert/update/upsert), and explicit transactions — everything
the job/sync layers need, with no ORM in the way.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import os
import sqlite3
import threading
import time
import uuid
from typing import Any, Iterable, Iterator, Sequence

from ..utils import faults as _faults
from .schema import MIGRATIONS


def dict_row(cursor: sqlite3.Cursor, row: tuple) -> dict[str, Any]:
    return {d[0]: row[i] for i, d in enumerate(cursor.description)}


def now_iso() -> str:
    return _dt.datetime.now(_dt.timezone.utc).isoformat(timespec="milliseconds")


def new_pub_id() -> bytes:
    """16-byte UUIDv4 — the sync identity of shared rows."""
    return uuid.uuid4().bytes


def escape_like(s: str) -> str:
    r"""Escape LIKE wildcards in user-derived path fragments; pair with
    ``LIKE ? ESCAPE '\'`` so a directory named ``50% off`` can't match
    unrelated rows."""
    return s.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")


def u64_blob(value: int) -> bytes:
    """u64 -> 8-byte LE BLOB (inode / size columns; SQLite lacks u64,
    same workaround as ref:core/prisma/schema.prisma:164)."""
    return int(value).to_bytes(8, "little")


def blob_u64(blob: bytes | None) -> int | None:
    return None if blob is None else int.from_bytes(blob, "little")


class LibraryDb:
    """One library database. All writes hold the writer lock; reads use
    the same connection (SQLite serializes internally under WAL)."""

    def __init__(self, path: str | os.PathLike | None, *, memory: bool = False):
        self.path = ":memory:" if memory or path is None else os.fspath(path)
        if self.path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".", exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = dict_row
        self._lock = threading.RLock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA foreign_keys=ON")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._migrate()

    # --- lifecycle -----------------------------------------------------------

    def _migrate(self) -> None:
        version = self._conn.execute("PRAGMA user_version").fetchone()["user_version"]
        while version < len(MIGRATIONS):
            with self._conn:
                for stmt in MIGRATIONS[version]:
                    self._conn.execute(stmt)
                version += 1
                self._conn.execute(f"PRAGMA user_version={version}")

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # --- core access ---------------------------------------------------------

    @contextlib.contextmanager
    def transaction(self) -> Iterator[sqlite3.Connection]:
        """Exclusive write transaction (the sync layer's atomicity
        guarantee: domain rows + crdt_operation rows in one tx,
        ref:core/crates/sync/src/manager.rs:70-93)."""
        with self._lock:
            with self._conn:
                yield self._conn

    def execute(self, sql: str, params: Sequence | dict = ()) -> sqlite3.Cursor:
        with self._lock:
            with self._conn:
                return self._conn.execute(sql, params)

    def executemany(self, sql: str, seq: Iterable[Sequence]) -> None:
        with self._lock:
            with self._conn:
                self._conn.executemany(sql, seq)

    @staticmethod
    def _maybe_slow() -> None:
        """`db.slow` fault point: one `is None` check in production; an
        armed `stall` spec sleeps delay_s per read, the stand-in for a
        slow or contended disk under the whole read surface."""
        spec = _faults.hit("db.slow")
        if spec is not None:
            time.sleep(spec.delay_s)

    def query(self, sql: str, params: Sequence | dict = ()) -> list[dict[str, Any]]:
        self._maybe_slow()
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def query_one(self, sql: str, params: Sequence | dict = ()) -> dict[str, Any] | None:
        self._maybe_slow()
        with self._lock:
            return self._conn.execute(sql, params).fetchone()

    def change_stamp(self) -> tuple[int, int]:
        """Rows this connection has changed since it opened, and the
        file's data version (which other connections' commits bump):
        while the stamp stays equal, no row of the database changed."""
        with self._lock:
            version = self._conn.execute("PRAGMA data_version").fetchone()["data_version"]
            return self._conn.total_changes, version

    # --- typed helpers -------------------------------------------------------

    @staticmethod
    def _quote(col: str) -> str:
        return f'"{col}"'

    def insert(self, table: str, **cols: Any) -> int:
        names = ", ".join(self._quote(c) for c in cols)
        ph = ", ".join("?" for _ in cols)
        cur = self.execute(
            f"INSERT INTO {table} ({names}) VALUES ({ph})", tuple(cols.values())
        )
        return cur.lastrowid

    def update(self, table: str, where: dict[str, Any], **cols: Any) -> int:
        sets = ", ".join(f"{self._quote(c)}=?" for c in cols)
        conds = " AND ".join(f"{self._quote(c)}=?" for c in where)
        cur = self.execute(
            f"UPDATE {table} SET {sets} WHERE {conds}",
            tuple(cols.values()) + tuple(where.values()),
        )
        return cur.rowcount

    def upsert(self, table: str, key_cols: dict[str, Any], **cols: Any) -> None:
        all_cols = {**key_cols, **cols}
        names = ", ".join(self._quote(c) for c in all_cols)
        ph = ", ".join("?" for _ in all_cols)
        keys = ", ".join(self._quote(c) for c in key_cols)
        sets = ", ".join(f"{self._quote(c)}=excluded.{self._quote(c)}" for c in cols) or \
            f"{next(iter(key_cols))}={next(iter(key_cols))}"
        self.execute(
            f"INSERT INTO {table} ({names}) VALUES ({ph}) "
            f"ON CONFLICT ({keys}) DO UPDATE SET {sets}",
            tuple(all_cols.values()),
        )

    def delete(self, table: str, **where: Any) -> int:
        conds = " AND ".join(f"{self._quote(c)}=?" for c in where)
        cur = self.execute(f"DELETE FROM {table} WHERE {conds}", tuple(where.values()))
        return cur.rowcount

    def find(self, table: str, **where: Any) -> list[dict[str, Any]]:
        if not where:
            return self.query(f"SELECT * FROM {table}")
        conds = " AND ".join(f"{self._quote(c)}=?" for c in where)
        return self.query(f"SELECT * FROM {table} WHERE {conds}", tuple(where.values()))

    def find_one(self, table: str, **where: Any) -> dict[str, Any] | None:
        rows = self.find(table, **where)
        return rows[0] if rows else None

    def count(self, table: str, where_sql: str = "", params: Sequence = ()) -> int:
        sql = f"SELECT COUNT(*) AS n FROM {table}"
        if where_sql:
            sql += f" WHERE {where_sql}"
        return self.query_one(sql, params)["n"]
