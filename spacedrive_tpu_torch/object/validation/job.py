"""ObjectValidatorJob — fill missing `integrity_checksum` columns.

Counterpart of `spacedrive_tpu/object/validation/job.py`
(ref:core/src/object/validation/validator_job.rs): targets file_paths
in a location (optionally under a sub_path) with `is_dir = false` and no
checksum yet (validator_job.rs:107-125); each checksum is written
through sync as a shared_update on file_path.integrity_checksum
(validator_job.rs:152-170). A step is CHUNK_SIZE rows, whose small files
hash as padded device batches (validation/hash.py). The job's device is
`init["backend"]` ("cuda" or "cpu"), else the node's device.
"""

from __future__ import annotations

import asyncio
from typing import Any

from ...db.database import escape_like
from ...files.isolated_path import full_path_from_db_row, materialized_prefix
from ...jobs import StatefulJob
from ...jobs.job import JobContext, JobError, StepResult
from ...jobs.manager import register_job
from ..duplicates import job_device
from .hash import file_checksums

CHUNK_SIZE = 256


@register_job
class ObjectValidatorJob(StatefulJob):
    """init: {location_id, sub_path?, backend?}"""

    NAME = "object_validator"
    IS_BATCHED = True

    def _where(self) -> tuple[str, list[Any]]:
        where = "location_id = ? AND is_dir = 0 AND integrity_checksum IS NULL"
        params: list[Any] = [self.init["location_id"]]
        if self.init.get("sub_path"):
            where += " AND materialized_path LIKE ? ESCAPE '\\'"
            params.append(escape_like(materialized_prefix(self.init["sub_path"])) + "%")
        return where, params

    async def init_job(self, ctx: JobContext) -> None:
        db = ctx.library.db
        loc = db.find_one("location", id=self.init["location_id"])
        if loc is None:
            raise JobError(f"location {self.init['location_id']} not found")
        job_device(ctx.library, self.init.get("backend"))  # refuse a bad backend up front
        where, params = self._where()
        total = db.count("file_path", where, tuple(params))
        self.data.update(location_path=loc["path"], cursor=0)
        n_steps = (total + CHUNK_SIZE - 1) // CHUNK_SIZE
        for _ in range(n_steps):
            self.steps.append({"kind": "validate"})
        self.run_metadata.update(validated=0)
        ctx.progress(task_count=n_steps, message=f"validating {total} files", phase="validating")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        library = ctx.library
        where, params = self._where()
        rows = library.db.query(
            f"SELECT * FROM file_path WHERE {where} AND id > ? ORDER BY id LIMIT ?",
            tuple(params) + (self.data["cursor"], CHUNK_SIZE),
        )
        if not rows:
            return StepResult()
        self.data["cursor"] = rows[-1]["id"]

        paths = [full_path_from_db_row(self.data["location_path"], r) for r in rows]
        device = job_device(library, self.init.get("backend"))
        # reads, host hashing and the device wait block: off the loop
        checksums = await asyncio.to_thread(file_checksums, paths, device)

        sync = library.sync
        ops = []
        updates = []
        errors = []
        for row, checksum in zip(rows, checksums):
            if not checksum:
                errors.append(f"unreadable file_path {row['id']}")
                continue
            ops.append(sync.shared_update("file_path", row["pub_id"].hex(),
                                          "integrity_checksum", checksum))
            updates.append((checksum, row["id"]))

        def writes(conn) -> None:
            conn.executemany("UPDATE file_path SET integrity_checksum = ? WHERE id = ?", updates)

        sync.write_ops(ops, writes)
        return StepResult(errors=errors,
                          metadata={"validated": self.run_metadata["validated"] + len(updates)})

    async def finalize(self, ctx: JobContext) -> Any:
        ctx.progress(message="validation complete", phase="done")
        return dict(self.run_metadata)
