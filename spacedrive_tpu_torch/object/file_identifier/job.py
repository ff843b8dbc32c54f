"""FileIdentifierJob — cas_id hashing + object linking, device-batched.

Parity: ref:core/src/object/file_identifier/ — orphan query with cursor
pagination (file_identifier_job.rs:56-165), CHUNK_SIZE = 100 files per
step (mod.rs:33-34), FileMetadata::new = fs metadata + kind resolve +
cas_id (mod.rs:57-96), then cas_id sync updates + object
dedupe/create/connect (mod.rs:98-350).

Where the reference hashes ≤100 files concurrently on CPU cores
(join_all), each step here assembles the sampled messages on the host
and hashes the whole window as ONE device batch (the BLAKE3 chunk
kernel, ops/csrc/blake3_chunk.cu) — the batch dim replaces task-level
concurrency.

Counterpart of `spacedrive_tpu/object/file_identifier/job.py`, without
its telemetry, its autotuned window sizing and its host fallback. The
backend is "cuda" (default) or "cpu" and nothing else: a device window
is IDENTIFY_DEVICE_WINDOW rows with FEEDER_BASE_DEPTH windows in flight,
a CPU window the reference's IDENTIFY_CPU_WINDOW. A CUDA failure in
dispatch or finish fails the step; nothing re-hashes on the host.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

import torch

from ...db.database import blob_u64, escape_like, new_pub_id, now_iso
from ...files.isolated_path import full_path_from_db_row as _row_full_path
from ...files.isolated_path import materialized_prefix
from ...jobs import StatefulJob
from ...jobs.job import JobContext, JobError, StepResult
from ...jobs.manager import register_job
from ...location.indexer import journal as _journal
from ...ops import cas
from ...parallel import autotune as _autotune
from ...parallel.feeder import WindowPipeline
from .link import kind_for_row as _kind_for_row

logger = logging.getLogger(__name__)

BACKENDS = ("cuda", "cpu")


def orphan_where_clause(sub_path_mat: str | None = None) -> str:
    """Orphan = no object, not identified yet, real file
    (ref:file_identifier_job.rs orphan_path_filters)."""
    base = (
        "object_id IS NULL AND cas_id IS NULL AND is_dir = 0 "
        "AND location_id = ?"
    )
    if sub_path_mat is not None:
        base += " AND materialized_path LIKE ? ESCAPE '\\'"
    return base


@register_job
class FileIdentifierJob(StatefulJob):
    """init: {location_id, sub_path?, backend?}"""

    NAME = "file_identifier"
    IS_BATCHED = True
    _pipeline = None  # runtime-only window pipeline (never serialized)

    async def init_job(self, ctx: JobContext) -> None:
        library = ctx.library
        loc_id = self.init["location_id"]
        location = library.db.find_one("location", id=loc_id)
        if location is None:
            raise JobError(f"location {loc_id} not found")

        backend = self.init.get("backend", "cuda")
        if backend not in BACKENDS:
            raise JobError(f"backend must be one of {BACKENDS}, got {backend!r}")
        chunk = (
            _autotune.IDENTIFY_DEVICE_WINDOW if backend == "cuda"
            else _autotune.IDENTIFY_CPU_WINDOW
        )

        params: list[Any] = [loc_id]
        where = orphan_where_clause(self.init.get("sub_path") and self.init["sub_path"])
        if self.init.get("sub_path"):
            params.append(escape_like(materialized_prefix(self.init['sub_path'])) + "%")
        total = library.db.count("file_path", where, tuple(params))

        self.data.update(
            location_id=loc_id,
            location_path=location["path"],
            backend=backend,
            chunk_size=chunk,
            cursor=0,
        )
        n_steps = (total + chunk - 1) // chunk
        for _ in range(n_steps):
            self.steps.append({"kind": "identify"})
        self.run_metadata.update(
            total_orphan_paths=total, created_objects=0, linked_objects=0,
            hash_time=0.0, db_time=0.0,
            journal_hits=0, journal_dirty_rehash=0,
            read_time=0.0, rehash_time=0.0, dispatch_time=0.0, hash_wait_time=0.0,
            device_files=0,
        )
        ctx.progress(
            task_count=n_steps,
            message=f"identifying {total} orphan paths", phase="identifying",
        )

    def _fetch_window(self, library, cursor: int, device: torch.device):
        """Read+dispatch stage: one cursor window of rows, their sampled
        bytes, and the hash batch already dispatched on `device` (on
        CUDA it is enqueued on a side stream, so back-to-back windows
        pipeline their transfers). Runs on the pipeline's producer
        thread; disk I/O never blocks the loop.

        The index journal is consulted per row BEFORE any byte is read:
        a `hit` reuses the vouched cas_id with zero I/O; an invalidated
        entry with a chunk cache and an unchanged message length takes
        the host dirty-range rehash (only dirty chunks pay BLAKE3, zero
        bytes shipped to the device); everything else rides the device
        batch."""
        t_start = time.perf_counter()
        d = self.data
        params: list[Any] = [d["location_id"]]
        where = orphan_where_clause(self.init.get("sub_path"))
        if self.init.get("sub_path"):
            params.append(escape_like(materialized_prefix(self.init['sub_path'])) + "%")
        limit = d["chunk_size"]
        # cursor pagination by id (ref:file_identifier_job.rs:126-165)
        rows = library.db.query(
            f"SELECT * FROM file_path WHERE {where} AND id > ? ORDER BY id LIMIT ?",
            tuple(params) + (cursor, limit),
        )
        loc_path = d["location_path"]
        loc_id = d["location_id"]
        journal = _journal.IndexJournal(library.db)
        metas: list[dict | None] = []
        messages: list[bytes] = []
        msg_rows: list[dict] = []
        resolved: dict[int, str] = {}  # row id -> cas from journal/dirty-range
        # row id -> (key, identity, cas, chunk cache, prior entry) to
        # vouch after commit; the prior entry lets an unchanged-content
        # re-record (mtime-only touch) keep its thumb/media/phash vouches
        to_record: dict[int, tuple] = {}
        jstats = {"hit": 0, "dirty": 0, "dirty_chunks": 0}
        rehash_s = 0.0  # host dirty-range rehash, inside the read stage
        for row in rows:
            full = _row_full_path(loc_path, row)
            size = blob_u64(row["size_in_bytes_bytes"]) or 0
            key = _journal.key_of(row)
            if size == 0:
                metas.append({"row": row, "cas_id": None})
                # journal the empty file (cas sentinel "") so warm-pass
                # walks get a `hit` instead of an eternal miss
                ident = _journal.stat_identity(full)
                if ident is not None:
                    to_record[row["id"]] = (key, ident, "", None, None)
                continue
            ident = _journal.stat_identity(full)
            entry = None
            if ident is not None:
                verdict, entry = journal.lookup(loc_id, key, ident)
                if verdict == _journal.HIT and entry.cas_id:
                    # vouched: skip the read, the hash, and the transfer
                    resolved[row["id"]] = entry.cas_id
                    jstats["hit"] += 1
                    metas.append({"row": row, "cas_id": "journal"})
                    continue
            try:
                msg = cas.read_message(full, size)
            except OSError as e:
                metas.append(None)
                logger.debug("identifier: unreadable %s: %s", full, e)
                continue
            if (
                ident is not None
                and entry is not None
                and entry.chunks is not None
                and entry.chunks.msg_len == len(msg)
                and len(msg) > cas.CHUNK_LEN
            ):
                t_rehash = time.perf_counter()
                try:
                    cas_id, cache, n_dirty, _hashed = cas.dirty_range_rehash(
                        msg, entry.chunks
                    )
                except ValueError:
                    cache = None
                else:
                    rehash_s += time.perf_counter() - t_rehash
                    resolved[row["id"]] = cas_id
                    to_record[row["id"]] = (key, ident, cas_id, cache, entry)
                    jstats["dirty"] += 1
                    jstats["dirty_chunks"] += n_dirty
                    metas.append({"row": row, "cas_id": "journal"})
                    continue
            messages.append(msg)
            msg_rows.append(row)
            metas.append({"row": row, "cas_id": "pending"})
            if ident is not None:
                # cas filled in post-hash; digest-only chunk cache so the
                # FIRST in-place modification can already diff chunks
                to_record[row["id"]] = (key, ident, None,
                                        cas.build_chunk_cache(msg), entry)
        t_read = time.perf_counter()
        # dispatch now (async on CUDA); a failure raises to the consumer
        finisher = cas.cas_ids_begin(messages, device) if messages else (lambda: [])
        times = {"read": t_read - t_start, "rehash": rehash_s,
                 "dispatch": time.perf_counter() - t_read}
        return (rows, metas, messages, msg_rows, finisher, resolved,
                to_record, jstats, times)

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        library = ctx.library
        d = self.data
        if self._pipeline is None:
            # The producer chains cursor windows back-to-back: window
            # N+1's disk reads and device dispatch start as soon as N's
            # reads finish, so up to FEEDER_BASE_DEPTH transfers are in
            # flight while this step's hashes complete and its DB writes
            # run. Fetches are side-effect-free, so a pause/resume
            # simply re-reads in-flight windows.
            device = torch.device(d["backend"])

            def fetch(cursor):
                window = self._fetch_window(library, cursor, device)
                rows = window[0]
                if not rows:
                    return None
                return rows[-1]["id"], window

            self._pipeline = WindowPipeline(fetch, d["cursor"])

        t0 = time.perf_counter()
        window = await asyncio.to_thread(self._pipeline.take)
        if window is None:
            return StepResult()
        (rows, metas, messages, msg_rows, finisher, resolved, to_record,
         jstats, times) = window
        d["cursor"] = rows[-1]["id"]

        t_wait = time.perf_counter()
        cas_ids = await asyncio.to_thread(finisher)
        hash_wait = time.perf_counter() - t_wait
        # take + finish, as in the JAX package's run metadata
        hash_time = time.perf_counter() - t0

        by_row_id = {r["id"]: c for r, c in zip(msg_rows, cas_ids)}
        by_row_id.update(resolved)

        t1 = time.perf_counter()
        created, linked = self._link_objects(library, rows, by_row_id)
        # journal vouches ONLY after the cas/object sync write
        # committed: a crash in between costs a redundant rehash on
        # resume, never a journal entry ahead of the DB
        records = []
        for row_id, (key, ident, cas_hex, cache, carry) in to_record.items():
            if cas_hex is None:
                cas_hex = by_row_id.get(row_id)
            if cas_hex is not None:  # "" = vouched-empty sentinel
                records.append((key, ident, cas_hex, cache, carry))
        _journal.IndexJournal(library.db).record_many(d["location_id"], records)
        db_time = time.perf_counter() - t1

        errors = [f"unreadable file_path {r['id']}" for m, r in zip(metas, rows) if m is None]
        md = self.run_metadata
        # the step count was estimated at init; should more orphan rows
        # remain than steps, keep draining until the cursor is exhausted
        # (an extra step against a dry pipeline no-ops)
        more_steps = [] if self.steps else [{"kind": "identify"}]
        return StepResult(
            errors=errors,
            more_steps=more_steps,
            metadata={
                "created_objects": md["created_objects"] + created,
                "linked_objects": md["linked_objects"] + linked,
                "hash_time": round(md["hash_time"] + hash_time, 4),
                "db_time": round(md["db_time"] + db_time, 4),
                "journal_hits": md["journal_hits"] + jstats["hit"],
                "journal_dirty_rehash": md["journal_dirty_rehash"] + jstats["dirty"],
                "read_time": round(md["read_time"] + times["read"], 4),
                "rehash_time": round(md["rehash_time"] + times["rehash"], 4),
                "dispatch_time": round(md["dispatch_time"] + times["dispatch"], 4),
                "hash_wait_time": round(md["hash_wait_time"] + hash_wait, 4),
                "device_files": md["device_files"] + len(messages),
            },
        )

    def _link_objects(
        self, library, rows: list[dict], cas_by_row_id: dict[int, str]
    ) -> tuple[int, int]:
        """cas_id updates + object dedupe/create/connect in one sync
        write (ref:mod.rs:157-347)."""
        sync = library.sync
        ops = []
        created = linked = 0

        # existing objects for these cas_ids
        distinct = sorted({c for c in cas_by_row_id.values()})
        existing: dict[str, tuple[int, bytes]] = {}
        if distinct:
            qmarks = ",".join("?" for _ in distinct)
            for row in library.db.query(
                f"SELECT fp.cas_id, fp.object_id, o.pub_id AS object_pub FROM file_path fp "
                f"JOIN object o ON o.id = fp.object_id "
                f"WHERE fp.cas_id IN ({qmarks}) AND fp.object_id IS NOT NULL",
                tuple(distinct),
            ):
                existing.setdefault(row["cas_id"], (row["object_id"], row["object_pub"]))

        new_objects: dict[str, tuple[bytes, dict]] = {}  # cas -> (obj pub_id, row)
        updates: list[tuple[dict, str, int | None, bytes | None]] = []
        for row in rows:
            cas_id = cas_by_row_id.get(row["id"])
            if cas_id is None:
                continue
            if cas_id in existing:
                obj_id, obj_pub = existing[cas_id]
                updates.append((row, cas_id, obj_id, obj_pub))
                linked += 1
            elif cas_id in new_objects:
                updates.append((row, cas_id, None, new_objects[cas_id][0]))
                linked += 1
            else:
                obj_pub = new_pub_id()
                new_objects[cas_id] = (obj_pub, row)
                updates.append((row, cas_id, None, obj_pub))
                created += 1

        date_created = now_iso()
        obj_rows: dict[bytes, int] = {}

        def writes(conn):
            # create missing objects
            for cas_id, (obj_pub, src_row) in new_objects.items():
                kind = _kind_for_row(src_row)
                cur = conn.execute(
                    "INSERT INTO object (pub_id, kind, date_created) VALUES (?,?,?)",
                    (obj_pub, int(kind), date_created),
                )
                obj_rows[obj_pub] = cur.lastrowid
            # connect + cas updates
            for row, cas_id, obj_id, obj_pub in updates:
                if obj_id is None and obj_pub is not None:
                    obj_id = obj_rows.get(obj_pub)
                conn.execute(
                    "UPDATE file_path SET cas_id = ?, object_id = ? WHERE id = ?",
                    (cas_id, obj_id, row["id"]),
                )

        for cas_id, (obj_pub, src_row) in new_objects.items():
            kind = _kind_for_row(src_row)
            ops.extend(
                sync.shared_create(
                    "object", obj_pub.hex(),
                    [("kind", int(kind)), ("date_created", date_created)],
                )
            )
        for row, cas_id, _obj_id, obj_pub in updates:
            rid = row["pub_id"].hex()
            ops.append(sync.shared_update("file_path", rid, "cas_id", cas_id))
            if obj_pub is not None:
                ops.append(
                    sync.shared_update("file_path", rid, "object_id", obj_pub.hex())
                )

        sync.write_ops(ops, writes)
        return created, linked

    def cleanup(self) -> None:
        """Every exit path (done/pause/cancel/fail) stops the window
        pipeline."""
        if self._pipeline is not None:
            self._pipeline.close()
            self._pipeline = None

    async def finalize(self, ctx: JobContext) -> Any:
        self.cleanup()
        ctx.progress(message="identification complete", phase="done")
        return dict(self.run_metadata)
