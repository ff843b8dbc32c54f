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

Counterpart of `spacedrive_tpu/location/indexer/journal.py` without its
process-pool consult and the watcher, rename and orphan-prune surface
the port does not run yet. The payload bytes and the verdicts are the
same. Where the JAX journal counts verdicts and bytes saved into
process-wide telemetry, each `IndexJournal` here tallies them in its
own `counts`. No program code reads `counts` yet: it, `bytes_saved` and
`lookup(count_invalidated=)` keep the JAX journal's API until the port's
telemetry reads them.
"""

from __future__ import annotations

import collections
import logging
import os
import sqlite3
from dataclasses import dataclass
from typing import Any

from ...db.database import blob_u64, now_iso, u64_blob
from ...ops.cas import ChunkCache
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


class IndexJournal:
    """Journal access bound to one library DB. Location scoping rides
    in each call's `location_id` (duplicates span locations)."""

    def __init__(self, db: Any):
        self.db = db
        #: verdicts this journal handed out (hit / miss / invalidated /
        #: bypassed) and the bytes whose work a vouch skipped
        self.counts: collections.Counter[str] = collections.Counter()

    # ---- consult -------------------------------------------------------

    def lookup(
        self, location_id: int, key: Key, identity: Identity | None,
        count_invalidated: bool = True,
    ) -> tuple[str, JournalEntry | None]:
        """(verdict, entry). `hit` entries vouch for their cached
        results; `invalidated` entries are returned too — their chunk
        cache still powers dirty-range rehash. A pipeline re-consulting
        a file the walker already judged this pass (the media job)
        passes `count_invalidated=False`, so one changed file counts one
        invalidation."""
        verdict, entry = self._lookup(location_id, key, identity)
        if verdict != INVALIDATED or count_invalidated:
            self.counts[verdict] += 1
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
        if row is None:
            return MISS, None
        entry = entry_of_row(row)
        if entry is None:
            # corrupt row: drop it so the next pass starts clean
            self._delete_key(location_id, key)
            return BYPASSED, None
        if (
            not entry.stale
            and identity is not None
            and entry.identity == identity
        ):
            return HIT, entry
        return INVALIDATED, entry

    def bytes_saved(self, n: int) -> None:
        """Count `n` bytes whose work a vouch skipped."""
        if n > 0:
            self.counts["bytes_saved"] += n

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
            return self.db.execute(
                "UPDATE index_journal SET stale = 1 WHERE location_id = ? "
                "AND materialized_path = ? AND name = ? AND extension = ? "
                "AND stale = 0",
                (location_id, mat, name, ext),
            ).rowcount
        except sqlite3.Error:
            return 0

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
