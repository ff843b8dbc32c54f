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
node's device. Not ported: the process-pool decode leg (the port
decodes inline, as the JAX job does without a pool) and
`distribute_phash`.
"""

from __future__ import annotations

import asyncio
import os
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
        from PIL import Image

        loc = self._location(ctx, row["location_id"])
        if loc is not None:
            try:
                with Image.open(full_path_from_db_row(loc["path"], row)) as img:
                    if img.format == "JPEG":
                        img.draft("RGB", (phash_torch.DCT_SIZE, phash_torch.DCT_SIZE))
                    return phash_torch.to_gray32(np.asarray(img.convert("RGBA")))
            except Exception:  # noqa: BLE001 - any decode failure: try the thumbnail
                pass
        node = getattr(ctx.library, "node", None)
        if node is not None:
            thumb = node.thumbnailer.store.path_for(str(ctx.library.id), row["cas_id"])
            if os.path.exists(thumb):
                try:
                    with Image.open(thumb) as img:
                        return phash_torch.to_gray32(np.asarray(img.convert("RGBA")))
                except Exception:  # noqa: BLE001 - undecodable: the row is skipped
                    pass
        return None

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
                journal.bytes_saved(blob_u64(r["size_in_bytes_bytes"]) or 0)
                return entry.phash
            return None

        def decode_all() -> tuple[list, list]:
            cached = [consult(r) for r in rows]
            grays = [None if ph is not None else self._decode_gray(ctx, r)
                     for r, ph in zip(rows, cached)]
            return cached, grays

        cached, grays = await asyncio.to_thread(decode_all)
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
