"""Persistent per-location index journal — never hash a byte twice.

The journal maps a file_path key `(location_id, materialized_path,
name, extension)` to its last-known stat identity
`(inode, dev, mtime_ns, size)` and the derived results that identity
vouches for: `cas_id`, a thumbnail-stored flag, the media-metadata
digest, the duplicate-detector pHash, and the dirty-range chunk cache
(`ops.cas.ChunkCache`). Consumers — the walker, the file identifier,
the media processor, the duplicate detector — consult it BEFORE reading
any byte: an identity match means the cached result is current, so a
warm pass stats files but only reads/hashes/ships/thumbnails the
changed ones.

Truth discipline (the journal may only ever make a pass FASTER, never
wrong):

- a verdict is `hit` only when every identity field matches exactly
  (`st_mtime_ns`, not the float mtime) AND the entry is not stale;
- journal writes happen strictly AFTER the store/DB commit they vouch
  for (identifier: after the object-link sync write; thumbnails: after
  the rendezvous confirms the webp is in the store) — a crash between
  commit and journal write costs a redundant rehash, never a lie;
- watcher change events mark entries `stale` (targeted invalidation)
  instead of deleting them: a stale entry never vouches, but its chunk
  cache still powers the dirty-range rehash;
- any malformed row/payload (torn write, version drift) reads as
  `bypassed` and is dropped — the pass degrades to a cold rehash.

`SD_INDEX_JOURNAL=0` disables consults AND writes (every lookup is
`bypassed`).

Counterpart of `spacedrive_tpu/location/indexer/journal.py`, with its
batched consult (`consult_many`) and that consult's process-pool match
half (`_consult_pool`). The payload bytes and the verdicts are the same,
and so is the watcher's surface (`mark_stale_subtree`, `delete_path`,
`rename_path`: a rename moves the key and keeps every vouch and the
chunk cache) and the orphan prune (`prune_orphans`,
`prune_orphans_step`: liveness from the journal/DB join, never a
re-stat of the disk). Verdicts and bytes saved count into `sd_index_journal_ops_total`
and `sd_index_journal_bytes_saved_total` and into the per-location
runtime counters, as in the JAX journal; `location_stats` joins those
with the persisted entry counts for the federation snapshot, and
`reset_runtime` (called by `telemetry.reset()`) drops them.
"""

from __future__ import annotations

import itertools
import logging
import os
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any

from ...db.database import blob_u64, now_iso, u64_blob
from ...ops.cas_host import ChunkCache
from ...telemetry import metrics as _tm
from ...utils.msgpack_codec import MsgpackError, packb, unpackb

logger = logging.getLogger(__name__)

#: payload format version; a mismatch reads as a miss and is rewritten
JOURNAL_FORMAT = 1

#: verdict vocabulary (the metric's `result` label)
HIT, MISS, INVALIDATED, BYPASSED = "hit", "miss", "invalidated", "bypassed"


def enabled() -> bool:
    return os.environ.get("SD_INDEX_JOURNAL", "1") != "0"


@dataclass(frozen=True)
class Identity:
    """Exact stat identity — all four fields must match for a hit."""

    inode: int
    dev: int
    mtime_ns: int
    size: int

    @classmethod
    def from_stat(cls, st: os.stat_result) -> "Identity":
        return cls(st.st_ino, st.st_dev, st.st_mtime_ns, st.st_size)

    @classmethod
    def from_metadata(cls, meta: Any) -> "Identity | None":
        """From files.isolated_path.FilePathMetadata (walker plumbing)."""
        if meta is None or not getattr(meta, "mtime_ns", 0):
            return None
        return cls(meta.inode, meta.dev, meta.mtime_ns, meta.size_in_bytes)


def stat_identity(path: str | os.PathLike) -> Identity | None:
    """The sanctioned stat for journal-governed pipelines (sdlint SD012
    flags direct ``os.stat`` in those modules). None when unreadable."""
    try:
        return Identity.from_stat(os.stat(path))
    except OSError:
        return None


# key = (materialized_path, name, extension) within one location
Key = tuple[str, str, str]


def key_of(row_or_iso: Any) -> Key:
    """Key from a file_path DB row (dict) or an IsolatedFilePathData."""
    if isinstance(row_or_iso, dict):
        return (
            row_or_iso["materialized_path"],
            row_or_iso["name"],
            row_or_iso["extension"] or "",
        )
    return (
        row_or_iso.materialized_path,
        row_or_iso.name,
        row_or_iso.extension or "",
    )


@dataclass
class JournalEntry:
    identity: Identity | None
    stale: bool
    cas_id: str | None
    thumb: bool = False
    media_digest: str | None = None
    phash: bytes | None = None
    embed: bool = False
    chunks: ChunkCache | None = None


def entry_of_row(row: dict) -> JournalEntry | None:
    """Strictly validated row → entry decode (None = corrupt/foreign)."""
    payload = _decode_payload(row.get("payload"))
    if payload is None:
        return None
    try:
        ident = None
        if row.get("inode") is not None:
            ident = Identity(
                blob_u64(row["inode"]), blob_u64(row["dev"]),
                blob_u64(row["mtime_ns"]), blob_u64(row["size"]),
            )
        chunks = None
        if payload.get("chunks") is not None:
            chunks = ChunkCache.from_payload(payload["chunks"])
            if chunks is None:
                return None  # torn chunk cache → whole row suspect
        cas = row.get("cas_id")
        media = payload.get("media")
        phash = payload.get("phash")
        if cas is not None and not isinstance(cas, str):
            return None
        if media is not None and not isinstance(media, str):
            return None
        if phash is not None and (
            not isinstance(phash, bytes) or len(phash) != 8
        ):
            return None
        return JournalEntry(
            identity=ident,
            stale=bool(row.get("stale")),
            cas_id=cas,
            thumb=bool(payload.get("thumb")),
            media_digest=media,
            phash=phash,
            embed=bool(payload.get("embed")),
            chunks=chunks,
        )
    except (TypeError, ValueError):
        return None


def entry_to_plain(entry: JournalEntry) -> dict:
    """A validated entry as a MessagePack-plain dict (the pool's
    ``journal.match`` reply); `_entry_of_plain` reverses it."""
    ident = entry.identity
    return {
        "identity": ([ident.inode, ident.dev, ident.mtime_ns, ident.size]
                     if ident is not None else None),
        "stale": entry.stale,
        "cas_id": entry.cas_id,
        "thumb": entry.thumb,
        "media": entry.media_digest,
        "phash": entry.phash,
        "embed": entry.embed,
        "chunks": entry.chunks.to_payload() if entry.chunks is not None else None,
    }


def _entry_of_plain(plain: dict) -> JournalEntry:
    chunks = None
    if plain.get("chunks") is not None:
        # validated by the worker's entry_of_row: built without a second
        # O(chunks) pass
        p = plain["chunks"]
        chunks = ChunkCache(p["len"], list(p["dig"]), p.get("cvs"))
    return JournalEntry(
        identity=Identity(*plain["identity"]) if plain.get("identity") is not None else None,
        stale=bool(plain["stale"]),
        cas_id=plain.get("cas_id"),
        thumb=bool(plain.get("thumb")),
        media_digest=plain.get("media"),
        phash=plain.get("phash"),
        embed=bool(plain.get("embed")),
        chunks=chunks,
    )


def _decode_payload(blob: Any) -> dict | None:
    """Strictly validated payload decode; None = corrupt/foreign."""
    if blob is None:
        return {}
    if not isinstance(blob, bytes):
        return None
    try:
        obj = unpackb(blob)
    except MsgpackError:  # torn/corrupt payload
        return None
    if not isinstance(obj, dict) or obj.get("v") != JOURNAL_FORMAT:
        return None
    return obj


#: process-lifetime per-location runtime counters (hits/misses/…,
#: bytes saved), keyed (db path, location_id) — IndexJournal instances
#: are transient per-call wrappers, so the counts live here the way
#: series live in the telemetry registry. Read by location_stats() for
#: the federation snapshot (GET /mesh, sdx mesh-status).
_LOC_RUNTIME: dict[tuple[str, int], dict[str, int]] = {}
_LOC_RUNTIME_LOCK = threading.Lock()
_LOC_FIELDS = ("hits", "misses", "invalidated", "bypassed", "bytes_saved")
#: a verdict's runtime counter
_LOC_FIELD_OF = {HIT: "hits", MISS: "misses", INVALIDATED: "invalidated",
                 BYPASSED: "bypassed"}
#: hard cap on tracked (db, location) counter sets — libraries churned
#: by tests/bench arms would otherwise grow the dict for process
#: lifetime; eviction is oldest-inserted first (dict order)
_LOC_RUNTIME_MAX = 1024
_RT_KEY_SEQ = itertools.count()
#: location_stats() DB-half cache: (monotonic ts, db_half, live ids)
#: per db key — federation refreshes snapshots every ~5 s on the event
#: loop, and the GROUP BY scans one journal row per file
_STATS_CACHE: dict[str, tuple[float, dict, Any]] = {}
_STATS_TTL_S = 5.0


def reset_runtime() -> None:
    """Test/bench isolation (called by telemetry.reset()): drop the
    process-lifetime per-location counters and the stats cache."""
    with _LOC_RUNTIME_LOCK:
        _LOC_RUNTIME.clear()
    _STATS_CACHE.clear()


class IndexJournal:
    """Journal access bound to one library DB. Location scoping rides
    in each call's `location_id` (duplicates span locations)."""

    def __init__(self, db: Any):
        self.db = db

    def _db_key(self) -> str:
        """Runtime-counter namespace for this library DB. Disk DBs key
        by path; in-memory DBs (tests) would all collide on
        ":memory:", so each gets a token minted once per Database
        object (NOT id() — a recycled address must not inherit a dead
        DB's counters)."""
        path = str(getattr(self.db, "path", "?"))
        if path != ":memory:":
            return path
        tok = getattr(self.db, "_journal_rt_key", None)
        if tok is None:
            tok = f":memory:#{next(_RT_KEY_SEQ)}"
            try:
                self.db._journal_rt_key = tok
            except AttributeError:
                pass  # slotted/foreign db: fall back to per-call token
        return tok

    def _loc_count(self, location_id: int | None, field: str,
                   n: int = 1) -> None:
        if location_id is None:
            return
        key = (self._db_key(), int(location_id))
        with _LOC_RUNTIME_LOCK:
            stats = _LOC_RUNTIME.get(key)
            if stats is None:
                while len(_LOC_RUNTIME) >= _LOC_RUNTIME_MAX:
                    _LOC_RUNTIME.pop(next(iter(_LOC_RUNTIME)))
                stats = _LOC_RUNTIME[key] = dict.fromkeys(_LOC_FIELDS, 0)
            stats[field] += n

    # ---- consult -------------------------------------------------------

    def lookup(
        self, location_id: int, key: Key, identity: Identity | None,
        count_invalidated: bool = True, count: bool = True,
    ) -> tuple[str, JournalEntry | None]:
        """(verdict, entry). `hit` entries vouch for their cached
        results; `invalidated` entries are returned too — their chunk
        cache still powers dirty-range rehash. A pipeline re-consulting
        a file the walker already judged this pass (the media job)
        passes `count_invalidated=False`, so one changed file counts one
        invalidation. `count=False` counts nothing: a probe-only consult
        (the watcher's debounce sizing) is no pipeline verdict."""
        verdict, entry = self._lookup(location_id, key, identity)
        if count and (verdict != INVALIDATED or count_invalidated):
            _tm.INDEX_JOURNAL_OPS.inc(result=verdict)
            self._loc_count(location_id, _LOC_FIELD_OF[verdict])
        return verdict, entry

    def _lookup(
        self, location_id: int, key: Key, identity: Identity | None,
    ) -> tuple[str, JournalEntry | None]:
        if not enabled():
            return BYPASSED, None
        mat, name, ext = key
        try:
            row = self.db.query_one(
                "SELECT * FROM index_journal WHERE location_id = ? AND "
                "materialized_path = ? AND name = ? AND extension = ?",
                (location_id, mat, name, ext),
            )
        except sqlite3.Error:
            return BYPASSED, None
        return self._verdict_of_row(location_id, key, row, identity)

    #: keys per batched consult query: 3 bind parameters a key stay
    #: under SQLite's default 999-variable limit
    CONSULT_CHUNK = 300
    #: the smallest fetched-row count worth a pool round trip
    POOL_MIN_ITEMS = 16

    def consult_many(
        self,
        location_id: int,
        items: list[tuple[Key, Identity | None]],
        count_invalidated: bool = True,
        count: bool = True,
    ) -> dict[Key, tuple[str, JournalEntry | None]]:
        """Batched :meth:`lookup`: one row-value ``IN`` query per
        :data:`CONSULT_CHUNK` keys instead of one SELECT a file, with the
        same verdicts, counters and corrupt-row drop. With the process
        pool live and at least :data:`POOL_MIN_ITEMS` rows fetched, the
        payload decode and identity compare run in a worker
        (``journal.match``)."""
        if not items:
            return {}
        rows_by_key = self._fetch_many(location_id, items) if enabled() else None
        if rows_by_key is None:
            verdicts = [(BYPASSED, None)] * len(items)
        else:
            verdicts = self._consult_pool(location_id, items, rows_by_key)
            if verdicts is None:
                verdicts = [
                    self._verdict_of_row(location_id, key, rows_by_key.get(key), ident)
                    for key, ident in items
                ]
        if count:
            tally: dict[str, int] = {}
            for verdict, _entry in verdicts:
                if verdict != INVALIDATED or count_invalidated:
                    tally[verdict] = tally.get(verdict, 0) + 1
            for verdict, n in tally.items():
                _tm.INDEX_JOURNAL_OPS.inc(n, result=verdict)
                self._loc_count(location_id, _LOC_FIELD_OF[verdict], n)
        return {key: v for (key, _ident), v in zip(items, verdicts)}

    def _fetch_many(
        self, location_id: int, items: list[tuple[Key, Identity | None]],
    ) -> dict[Key, dict] | None:
        """The journal rows of `items`' keys; None when SQLite fails (every
        verdict then reads `bypassed`)."""
        rows_by_key: dict[Key, dict] = {}
        try:
            for start in range(0, len(items), self.CONSULT_CHUNK):
                chunk = items[start:start + self.CONSULT_CHUNK]
                params: list[Any] = [location_id]
                for key, _ident in chunk:
                    params.extend(key)
                placeholders = ",".join("(?,?,?)" for _ in chunk)
                for row in self.db.query(
                    "SELECT * FROM index_journal WHERE location_id = ? "
                    "AND (materialized_path, name, extension) IN "
                    f"(VALUES {placeholders})",
                    params,
                ):
                    rows_by_key[(row["materialized_path"], row["name"],
                                 row["extension"])] = row
        except sqlite3.Error:
            return None
        return rows_by_key

    def _verdict_of_row(
        self, location_id: int, key: Key, row: dict | None, identity: Identity | None,
    ) -> tuple[str, JournalEntry | None]:
        if row is None:
            return MISS, None
        entry = entry_of_row(row)
        if entry is None:
            # corrupt row: drop it so the next pass starts clean
            self._delete_key(location_id, key)
            return BYPASSED, None
        if not entry.stale and identity is not None and entry.identity == identity:
            return HIT, entry
        return INVALIDATED, entry

    def _consult_pool(
        self,
        location_id: int,
        items: list[tuple[Key, Identity | None]],
        rows_by_key: dict[Key, dict],
    ) -> list[tuple[str, JournalEntry | None]] | None:
        """consult_many's match half on the process pool: the fetched rows
        ship as plain dicts, a worker decodes and validates each payload
        and compares identities (`procworker._stage_journal_match`), and
        the counting and the corrupt-row deletes stay here. None (the
        caller runs the inline loop over the rows in hand) when the pool
        is off, too few rows were fetched, or the round trip fails; as
        nothing was counted or deleted yet, nothing counts twice."""
        if len(rows_by_key) < self.POOL_MIN_ITEMS:
            return None
        from ...parallel import procpool as _procpool

        pool = _procpool.get()
        if pool is None:
            return None
        wire_items = [
            [list(key), [ident.inode, ident.dev, ident.mtime_ns, ident.size]
             if ident is not None else None]
            for key, ident in items
        ]
        try:
            reply = pool.request(
                "journal.match",
                {"items": wire_items, "rows": [rows_by_key.get(k) for k, _i in items]},
                rows=len(items),
            )
            raw = reply["verdicts"]
            if len(raw) != len(items):
                raise ValueError("verdict count mismatch")
            out: list[tuple[str, JournalEntry | None]] = []
            corrupt: list[Key] = []
            for (key, _ident), (verdict, plain, is_corrupt) in zip(items, raw):
                if is_corrupt:
                    corrupt.append(key)
                    out.append((BYPASSED, None))
                    continue
                if verdict not in (HIT, MISS, INVALIDATED):
                    raise ValueError(f"foreign verdict {verdict!r}")
                out.append((verdict, None if plain is None else _entry_of_plain(plain)))
        except (_procpool.ProcPoolError, KeyError, TypeError, ValueError):
            return None
        for key in corrupt:
            self._delete_key(location_id, key)
        return out

    def bytes_saved(self, n: int, location_id: int | None = None) -> None:
        """Count `n` bytes whose work a vouch skipped."""
        if n > 0:
            _tm.INDEX_JOURNAL_BYTES_SAVED.inc(n)
            self._loc_count(location_id, "bytes_saved", n)

    # ---- record --------------------------------------------------------

    def record_many(
        self,
        location_id: int,
        records: list[
            tuple[Key, Identity, str, ChunkCache | None, JournalEntry | None]
        ],
    ) -> None:
        """Batch vouch (one transaction — an identifier window writes
        up to 1024 rows; per-row commits would dominate).
        Each record may carry the PRIOR journal entry: when the
        recomputed cas matches its cas_id the content is unchanged (an
        mtime-only touch), so the thumb/media/phash vouches carry
        forward instead of forcing a re-thumbnail + EXIF re-probe."""
        if not enabled() or not records:
            return
        stamp = now_iso()
        rows = []
        for (mat, name, ext), ident, cas, chunks, carry in records:
            payload: dict[str, Any] = {"v": JOURNAL_FORMAT}
            if chunks is not None:
                payload["chunks"] = chunks.to_payload()
            if carry is not None and carry.cas_id == cas:
                if carry.thumb:
                    payload["thumb"] = True
                if carry.media_digest is not None:
                    payload["media"] = carry.media_digest
                if carry.phash is not None:
                    payload["phash"] = carry.phash
                if carry.embed:
                    payload["embed"] = True
            rows.append((
                location_id, mat, name, ext,
                u64_blob(ident.inode), u64_blob(ident.dev),
                u64_blob(ident.mtime_ns), u64_blob(ident.size),
                cas, packb(payload), stamp,
            ))
        try:
            self.db.executemany(
                "INSERT INTO index_journal (location_id, materialized_path, "
                "name, extension, inode, dev, mtime_ns, size, cas_id, "
                "payload, stale, date_vouched) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,0,?) "
                "ON CONFLICT (location_id, materialized_path, name, extension) "
                "DO UPDATE SET inode=excluded.inode, dev=excluded.dev, "
                "mtime_ns=excluded.mtime_ns, size=excluded.size, "
                "cas_id=excluded.cas_id, payload=excluded.payload, "
                "stale=0, date_vouched=excluded.date_vouched",
                rows,
            )
        except sqlite3.Error:
            logger.exception("index journal batch write failed (non-fatal)")

    def _amend_payload(
        self, location_id: int, key: Key, cas_id: str | None, **updates: Any,
    ) -> None:
        """Merge fields into a FRESH entry's payload. Refuses when the
        row is missing, stale, or vouches a different cas — an amend
        must never resurrect an invalidated vouch."""
        if not enabled():
            return
        mat, name, ext = key
        try:
            with self.db.transaction() as conn:
                row = conn.execute(
                    "SELECT payload, cas_id, stale FROM index_journal "
                    "WHERE location_id = ? AND materialized_path = ? "
                    "AND name = ? AND extension = ?",
                    (location_id, mat, name, ext),
                ).fetchone()
                if row is None or row["stale"]:
                    return
                if cas_id is not None and row["cas_id"] != cas_id:
                    return
                payload = _decode_payload(row["payload"])
                if payload is None:
                    return
                payload["v"] = JOURNAL_FORMAT
                payload.update(updates)
                conn.execute(
                    "UPDATE index_journal SET payload = ?, date_vouched = ? "
                    "WHERE location_id = ? AND materialized_path = ? "
                    "AND name = ? AND extension = ?",
                    (packb(payload), now_iso(), location_id, mat, name, ext),
                )
        except sqlite3.Error:
            logger.exception("index journal amend failed (non-fatal)")

    def vouch_thumb(self, location_id: int, key: Key, cas_id: str) -> None:
        """Mark the thumbnail stored — call ONLY after the webp landed
        in the store (a crash between store and this write is safe: the
        next pass re-checks the store and re-vouches)."""
        self._amend_payload(location_id, key, cas_id, thumb=True)

    def vouch_embed(self, location_id: int, key: Key, cas_id: str | None) -> None:
        """Mark the embedding persisted — call ONLY after the
        object_embedding row (and its sync ops) committed; a crash
        between commit and this write just re-embeds once."""
        self._amend_payload(location_id, key, cas_id, embed=True)

    def vouch_media(self, location_id: int, key: Key, cas_id: str | None,
                    digest: str) -> None:
        """Record the media-metadata digest after the media_data upsert.
        An empty digest is a valid vouch: "probed, nothing to extract"
        — it stops warm passes from re-probing EXIF-less files."""
        self._amend_payload(location_id, key, cas_id, media=digest)

    def record_phash(self, location_id: int, key: Key, cas_id: str | None,
                     phash: bytes) -> None:
        """Record the pHash after the `object.phash` update committed."""
        self._amend_payload(location_id, key, cas_id, phash=bytes(phash))

    # ---- invalidate ----------------------------------------------------

    def mark_stale(self, location_id: int, key: Key) -> int:
        """Targeted invalidation: the entry stops vouching but keeps its
        chunk cache for the dirty-range rehash."""
        if not enabled():
            return 0
        mat, name, ext = key
        try:
            n = self.db.execute(
                "UPDATE index_journal SET stale = 1 WHERE location_id = ? "
                "AND materialized_path = ? AND name = ? AND extension = ? "
                "AND stale = 0",
                (location_id, mat, name, ext),
            ).rowcount
        except sqlite3.Error:
            return 0
        if n:
            _tm.INDEX_JOURNAL_OPS.inc(n, result=INVALIDATED)
        return n

    def mark_stale_subtree(self, location_id: int, prefix: str) -> int:
        """Invalidate every entry under a materialized-path prefix
        (lost watcher events / RESCAN: unknown depths changed)."""
        if not enabled():
            return 0
        try:
            n = self.db.execute(
                "UPDATE index_journal SET stale = 1 WHERE location_id = ? "
                "AND substr(materialized_path, 1, ?) = ? AND stale = 0",
                (location_id, len(prefix), prefix),
            ).rowcount
        except sqlite3.Error:
            return 0
        if n:
            _tm.INDEX_JOURNAL_OPS.inc(n, result=INVALIDATED)
        return n

    def _delete_key(self, location_id: int, key: Key) -> None:
        mat, name, ext = key
        try:
            self.db.execute(
                "DELETE FROM index_journal WHERE location_id = ? AND "
                "materialized_path = ? AND name = ? AND extension = ?",
                (location_id, mat, name, ext),
            )
        except sqlite3.Error:
            pass

    def delete_path(self, location_id: int, key: Key,
                    subtree_prefix: str | None = None) -> None:
        """Remove journal rows for a deleted path (and, for a removed
        directory, its whole subtree)."""
        if not enabled():
            return
        self._delete_key(location_id, key)
        if subtree_prefix is not None:
            try:
                self.db.execute(
                    "DELETE FROM index_journal WHERE location_id = ? AND "
                    "substr(materialized_path, 1, ?) = ?",
                    (location_id, len(subtree_prefix), subtree_prefix),
                )
            except sqlite3.Error:
                pass

    def rename_path(
        self, location_id: int, old_key: Key, new_key: Key,
        old_prefix: str | None = None, new_prefix: str | None = None,
    ) -> None:
        """A rename moves the key but keeps every vouch: content,
        thumbnail, and media are untouched by a rename. For a directory,
        pass the old/new materialized-path prefixes to move the subtree."""
        if not enabled():
            return
        delete = ("DELETE FROM index_journal WHERE location_id = ? AND "
                  "materialized_path = ? AND name = ? AND extension = ?")
        try:
            rows = [] if old_prefix is None or new_prefix is None else self.db.query(
                "SELECT materialized_path, name, extension FROM "
                "index_journal WHERE location_id = ? AND "
                "substr(materialized_path, 1, ?) = ?",
                (location_id, len(old_prefix), old_prefix),
            )
            # one transaction, as JAX's statements in its order: a commit
            # per row costs seconds on a directory of 16k files
            with self.db.transaction() as conn:
                # landing on an existing key would violate the PK: clear it
                conn.execute(delete, (location_id, *new_key))
                conn.execute(
                    "UPDATE index_journal SET materialized_path = ?, name = ?, "
                    "extension = ? WHERE location_id = ? AND "
                    "materialized_path = ? AND name = ? AND extension = ?",
                    (*new_key, location_id, *old_key),
                )
                for r in rows:
                    moved = new_prefix + r["materialized_path"][len(old_prefix):]
                    conn.execute(delete, (location_id, moved, r["name"], r["extension"]))
                    conn.execute(
                        "UPDATE index_journal SET materialized_path = ? "
                        "WHERE location_id = ? AND materialized_path = ? "
                        "AND name = ? AND extension = ?",
                        (moved, location_id, r["materialized_path"],
                         r["name"], r["extension"]),
                    )
        except sqlite3.Error:
            logger.exception("index journal rename failed (non-fatal)")

    # ---- stats ---------------------------------------------------------

    def location_stats(self) -> dict[int, dict[str, Any]]:
        """Per-location journal effectiveness: persisted entry counts
        (DB truth) joined with this process's runtime verdict counters.
        Rides the federation snapshot's per-library block so hit rates
        and bytes saved show up on ``telemetry.mesh`` / the CLI's ``mesh-status``
        without any new wire surface.

        The DB half (a GROUP BY over one row per file, plus the live
        location-id set) is cached for ``_STATS_TTL_S`` per DB:
        federation refreshes every snapshot pull (5 s cadence,
        synchronous on the event loop), and a million-file library
        must not pay a full index_journal scan on each one. Runtime
        counters are merged fresh on every call."""
        db_path = self._db_key()
        now = time.monotonic()
        cached = _STATS_CACHE.get(db_path)
        if cached is not None and now - cached[0] < _STATS_TTL_S:
            db_half, live = cached[1], cached[2]
        else:
            db_half = {}
            try:
                rows = self.db.query(
                    "SELECT location_id, COUNT(*) AS entries, "
                    "COALESCE(SUM(stale), 0) AS stale "
                    "FROM index_journal GROUP BY location_id"
                )
            except sqlite3.Error:
                return {}
            for r in rows:
                db_half[int(r["location_id"])] = {
                    "entries": int(r["entries"]),
                    "stale_entries": int(r["stale"]),
                }
            try:
                live = {int(r["id"]) for r in self.db.query(
                    "SELECT id FROM location")}
            except sqlite3.Error:
                live = None
            while len(_STATS_CACHE) >= _LOC_RUNTIME_MAX:
                _STATS_CACHE.pop(next(iter(_STATS_CACHE)))
            _STATS_CACHE[db_path] = (now, db_half, live)
        out: dict[int, dict[str, Any]] = {
            loc: dict(v) for loc, v in db_half.items()
        }
        with _LOC_RUNTIME_LOCK:
            if live is not None:
                # a deleted location's counters must not haunt GET /mesh
                # until process restart (the DB rows are pruned by
                # prune_orphans; this prunes their runtime shadow)
                for key in [k for k in _LOC_RUNTIME
                            if k[0] == db_path and k[1] not in live]:
                    del _LOC_RUNTIME[key]
            runtime = {
                loc: dict(stats)
                for (path, loc), stats in _LOC_RUNTIME.items()
                if path == db_path
            }
        for loc, stats in runtime.items():
            entry = out.setdefault(
                loc, {"entries": 0, "stale_entries": 0})
            entry.update(stats)
            consults = (stats["hits"] + stats["misses"]
                        + stats["invalidated"])
            entry["hit_rate"] = (
                round(stats["hits"] / consults, 4) if consults else None
            )
        return out


#: orphan-prune delete batch: small enough that one DELETE holds the
#: write lock for milliseconds even against a million-row journal,
#: large enough that a typical prune is one round trip
PRUNE_BATCH = 2048


def prune_orphans(db: Any, batch: int = PRUNE_BATCH) -> int:
    """Drop journal rows whose file_path row vanished — the journal's
    share of the orphan-remover pass (object/orphan_remover.py). Uses
    the DB as the liveness source instead of re-stat'ing paths on disk.

    Deletes in bounded rowid batches: one unbounded DELETE against a
    million-row journal holds SQLite's write lock (and whichever thread
    issued it) for the whole scan. Callers on the event loop should use
    the async wrapper in object/orphan_remover.py, which yields between
    batches."""
    total = 0
    while True:
        n = prune_orphans_step(db, batch)
        total += n
        if n < max(1, batch):
            break
    return total


def prune_orphans_step(db: Any, batch: int = PRUNE_BATCH) -> int:
    """One bounded prune batch; a return < ``batch`` means the journal
    is clean. The orphan-remover actor's async path calls this between
    event-loop yields so a million-row prune can't freeze the loop."""
    batch = max(1, batch)
    try:
        n = db.execute(
            "DELETE FROM index_journal WHERE rowid IN ("
            "SELECT ij.rowid FROM index_journal ij "
            "WHERE NOT EXISTS ("
            "SELECT 1 FROM file_path fp WHERE "
            "fp.location_id = ij.location_id AND "
            "fp.materialized_path = ij.materialized_path AND "
            "fp.name = ij.name AND "
            "fp.extension = ij.extension) LIMIT ?)",
            (batch,),
        ).rowcount
    except sqlite3.Error:
        return 0
    n = max(0, n)
    if n:
        _tm.INDEX_JOURNAL_OPS.inc(n, result=INVALIDATED)
    return n
