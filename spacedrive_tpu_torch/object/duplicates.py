"""Duplicate detection — the pHash job and the grouping query.

Counterpart of `spacedrive_tpu/object/duplicates.py` (BASELINE.json
config 5). The job walks image objects that lack an `object.phash`,
decodes the originals (JPEG draft mode decodes at 1/8 DCT scale, cheap,
and avoids the distance inflation of re-hashing webp-q30 thumbnails;
the thumbnail is only the fallback), batches 32×32 grayscale planes and
hashes them on the job's device (`ops/phash_torch.py`).
`find_duplicates` then groups objects by Hamming distance in device row
blocks, beside the exact-duplicate groups by cas_id.

The job's device is `init["backend"]` ("cuda" or "cpu"), else the
node's device. The gray-plane decode rides the process pool
(`phash.gray`, parallel/procpool.py) when the pool is up, one file a
job, else runs inline; both run `ops/phash_gray.decode_gray`, so the
planes are bit-identical, and a pool failure decodes that row inline.
The device pHash and the DB update stay on the owner. Not ported:
`distribute_phash`.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any

import numpy as np
import torch

from ..db.database import blob_u64
from ..files.isolated_path import full_path_from_db_row
from ..files.kind import ObjectKind
from ..jobs import StatefulJob
from ..jobs.job import JobContext, JobError, StepResult
from ..jobs.manager import register_job
from ..location.indexer import journal as _journal
from ..ops import phash_torch
from ..ops.phash_gray import decode_gray
from ..parallel import procpool as _procpool
from .file_identifier.job import BACKENDS
from .search.index import device_of

CHUNK = 64


def job_device(library: Any, backend: str | None) -> torch.device:
    """The device of a read-side job: its `backend` ("cuda" or "cpu")
    when given, else the library's node's device, else "cuda"."""
    if backend is not None and backend not in BACKENDS:
        raise JobError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return device_of(library, backend)


@register_job
class DuplicateDetectorJob(StatefulJob):
    """init: {location_id?, threshold?, backend?} — hashes image objects
    missing a phash; finalize records the duplicate groups found."""

    NAME = "duplicate_detector"
    IS_BATCHED = True
    _locs: dict | None = None  # runtime-only location rows (never serialized)

    async def init_job(self, ctx: JobContext) -> None:
        db = ctx.library.db
        conds = ["o.kind = ?", "o.phash IS NULL", "fp.cas_id IS NOT NULL"]
        params: list[Any] = [int(ObjectKind.Image)]
        if self.init.get("location_id"):
            conds.append("fp.location_id = ?")
            params.append(int(self.init["location_id"]))
        rows = db.query(
            "SELECT o.id AS object_id, fp.cas_id, fp.location_id, "
            "fp.materialized_path, fp.name, fp.extension, fp.is_dir, "
            "fp.size_in_bytes_bytes "
            "FROM object o JOIN file_path fp ON fp.object_id = o.id "
            f"WHERE {' AND '.join(conds)} GROUP BY o.id",
            params,
        )
        for off in range(0, len(rows), CHUNK):
            self.steps.append({"rows": rows[off:off + CHUNK]})
        self.run_metadata.update(hashed=0, skipped=0)
        ctx.progress(task_count=len(self.steps), message=f"hashing {len(rows)} images",
                     phase="phash")

    def _location(self, ctx: JobContext, location_id: int) -> dict | None:
        if self._locs is None:
            self._locs = {}
        if location_id not in self._locs:
            self._locs[location_id] = ctx.library.db.find_one("location", id=location_id)
        return self._locs[location_id]

    def _decode_gray(self, ctx: JobContext, row: dict) -> np.ndarray | None:
        """Original-first decode: JPEG draft mode pulls a 1/8-scale DCT
        decode, so cost stays low while avoiding the distance inflation
        of re-hashing webp-q30 (possibly upscaled) thumbnails; the
        thumbnail is the fallback when the original is gone or
        undecodable."""
        loc = self._location(ctx, row["location_id"])
        if loc is not None:
            try:
                return decode_gray(full_path_from_db_row(loc["path"], row), draft=True)
            except Exception:  # noqa: BLE001 - any decode failure: try the thumbnail
                pass
        thumb = self._thumb_path(ctx, row)
        if thumb is not None and os.path.exists(thumb):
            try:
                return decode_gray(thumb, draft=False)
            except Exception:  # noqa: BLE001 - undecodable: the row is skipped
                pass
        return None

    @staticmethod
    def _thumb_path(ctx: JobContext, row: dict) -> str | None:
        node = getattr(ctx.library, "node", None)
        if node is None:
            return None
        return node.thumbnailer.store.path_for(str(ctx.library.id), row["cas_id"])

    def _pool_decode(self, ctx: JobContext, pool: Any, pending: list[tuple[int, dict]],
                     grays: list) -> None:
        """Ship the undecoded rows' gray-plane decode to the process pool,
        one job a row (the original first, the thumbnail as fallback, as
        `_decode_gray`); a row whose job fails decodes inline."""
        futs = []
        for _idx, r in pending:
            loc = self._location(ctx, r["location_id"])
            path = full_path_from_db_row(loc["path"], r) if loc is not None else None
            try:
                futs.append(pool.submit("phash.gray",
                                        {"path": path, "thumb_path": self._thumb_path(ctx, r)}))
            except _procpool.ProcPoolError:
                futs.append(None)
        for (idx, r), fut in zip(pending, futs):
            gray = None
            if fut is not None:
                try:
                    blob = fut.result(_procpool.REQUEST_TIMEOUT_S)["gray"]
                    if blob is not None:
                        gray = np.frombuffer(blob, np.float32).reshape(
                            phash_torch.DCT_SIZE, phash_torch.DCT_SIZE).copy()
                except (_procpool.ProcPoolError, TimeoutError, KeyError, TypeError, ValueError):
                    gray = self._decode_gray(ctx, r)  # a torn round trip: decode inline
            else:
                gray = self._decode_gray(ctx, r)
            grays[idx] = gray

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        rows = step["rows"]
        journal = _journal.IndexJournal(ctx.library.db)

        def consult(r: dict) -> bytes | None:
            """Journal-vouched pHash: skip the original's decode when a
            fresh entry for this exact cas already carries one."""
            loc = self._location(ctx, r["location_id"])
            if loc is None:
                return None
            # count_invalidated=False: the walker already counted this
            # pass's invalidations
            verdict, entry = journal.lookup(
                r["location_id"], _journal.key_of(r),
                _journal.stat_identity(full_path_from_db_row(loc["path"], r)),
                count_invalidated=False,
            )
            if (verdict == _journal.HIT and entry is not None
                    and entry.phash is not None and entry.cas_id == r["cas_id"]):
                journal.bytes_saved(blob_u64(r["size_in_bytes_bytes"]) or 0,
                                    location_id=r["location_id"])
                return entry.phash
            return None

        def decode_all() -> tuple[list, list]:
            pool = _procpool.get()
            cached = [consult(r) for r in rows]
            grays: list = []
            pending: list[tuple[int, dict]] = []  # undecoded (index, row)
            for r, ph in zip(rows, cached):
                if ph is not None or pool is None:
                    grays.append(None if ph is not None else self._decode_gray(ctx, r))
                else:
                    grays.append(None)
                    pending.append((len(grays) - 1, r))
            if pending:
                self._pool_decode(ctx, pool, pending, grays)
            return cached, grays

        t0 = time.perf_counter()
        cached, grays = await asyncio.to_thread(decode_all)
        # the decode leg's wall seconds into the node's stage totals
        add = getattr(getattr(ctx.library, "node", None), "add_stage_seconds", None)
        if add is not None:
            add("phash_decode", time.perf_counter() - t0)
        ok = [(r, g) for r, g, c in zip(rows, grays, cached) if g is not None and c is None]
        reused = [(r, c) for r, c in zip(rows, cached) if c is not None]
        skipped = len(rows) - len(ok) - len(reused)
        updates: list[tuple[bytes, int]] = [(ph, row["object_id"]) for row, ph in reused]
        hashed_pairs: list[tuple[dict, bytes]] = []
        if ok:
            device = job_device(ctx.library, self.init.get("backend"))
            batch = np.stack([g for _r, g in ok])
            hashes = await asyncio.to_thread(phash_torch.phash_batch, batch, device)
            for (row, _g), h in zip(ok, hashes):
                updates.append((h.tobytes(), row["object_id"]))
                hashed_pairs.append((row, h.tobytes()))
        if updates:
            ctx.library.db.executemany("UPDATE object SET phash = ? WHERE id = ?", updates)
            # journal writes strictly after the phash rows committed
            for row, ph in hashed_pairs:
                journal.record_phash(row["location_id"], _journal.key_of(row), row["cas_id"], ph)
        self.run_metadata["hashed"] += len(ok)
        self.run_metadata["reused"] = self.run_metadata.get("reused", 0) + len(reused)
        self.run_metadata["skipped"] += skipped
        ctx.progress(completed_task_count=step_number + 1)
        return StepResult()

    async def finalize(self, ctx: JobContext) -> Any:
        device = job_device(ctx.library, self.init.get("backend"))
        groups = await asyncio.to_thread(
            find_duplicates, ctx.library, int(self.init.get("threshold", 8)), device
        )
        self.run_metadata["duplicate_groups"] = len(groups)
        return {"hashed": self.run_metadata["hashed"], "duplicate_groups": len(groups)}


def find_duplicates(library: Any, threshold: int = 8,
                    device: str | torch.device = "cuda") -> list[dict[str, Any]]:
    """Near-duplicate groups over all hashed objects (on `device`) and
    exact cas_id groups. Returns [{object_ids, kind: 'near'|'exact',
    files}]."""
    rows = library.db.query("SELECT id, phash FROM object WHERE phash IS NOT NULL")
    near = phash_torch.duplicate_groups([(r["id"], r["phash"]) for r in rows],
                                        threshold=threshold, device=device)
    out = [{"object_ids": g, "kind": "near"} for g in near]
    exact = library.db.query(
        "SELECT cas_id, GROUP_CONCAT(DISTINCT object_id) AS ids FROM file_path "
        "WHERE cas_id IS NOT NULL AND object_id IS NOT NULL "
        "GROUP BY cas_id HAVING COUNT(DISTINCT object_id) > 1"
    )
    for r in exact:
        out.append({"object_ids": [int(i) for i in r["ids"].split(",")], "kind": "exact"})
    # the file_path rows, so clients can render the groups
    all_ids = sorted({oid for g in out for oid in g["object_ids"]})
    by_object: dict[int, list[dict[str, Any]]] = {}
    for off in range(0, len(all_ids), 900):  # SQLite bind-variable limit
        chunk = all_ids[off:off + 900]
        qmarks = ",".join("?" * len(chunk))
        for row in library.db.query(
            f"SELECT object_id, name, extension, materialized_path, cas_id, "
            f"size_in_bytes_bytes FROM file_path WHERE object_id IN ({qmarks})",
            tuple(chunk),
        ):
            by_object.setdefault(row["object_id"], []).append({
                "name": row["name"],
                "extension": row["extension"],
                "materialized_path": row["materialized_path"],
                "cas_id": row["cas_id"],
                "size_in_bytes": blob_u64(row["size_in_bytes_bytes"]) or 0,
            })
    for g in out:
        g["files"] = [f for oid in g["object_ids"] for f in by_object.get(oid, [])]
    return out
