"""FileDeleterJob — remove file_paths from disk (and the library DB).

Parity: ref:core/src/object/fs/delete.rs — directories via
`remove_dir_all`, files via `remove_file` (delete.rs:79-83). The
reference leaves DB cleanup to the watcher; here the rows (and their
CRDT delete ops) are removed in the same job so the library stays
consistent even with watching disabled.

Counterpart of `spacedrive_tpu/object/fs/delete.py`: the same
`shared_delete` CRDT ops through `sync.write_ops`.
"""

from __future__ import annotations

import asyncio
import os
import shutil

from ...db.database import escape_like
from ...jobs import StatefulJob
from ...jobs.job import JobContext, StepResult
from ...jobs.manager import register_job
from . import get_location_path, get_many_files_datas


def _delete_path(step: dict) -> None:
    if os.path.islink(step["full_path"]):
        os.remove(step["full_path"])  # never follow links
    elif step["is_dir"]:
        shutil.rmtree(step["full_path"])
    else:
        os.remove(step["full_path"])


@register_job
class FileDeleterJob(StatefulJob):
    """init: {location_id, file_path_ids}"""

    NAME = "file_deleter"
    INVALIDATES = ("search.paths",)

    async def init_job(self, ctx: JobContext) -> None:
        db = ctx.library.db
        loc_path = get_location_path(db, self.init["location_id"])
        for fd in get_many_files_datas(db, loc_path, self.init["file_path_ids"]):
            self.steps.append(
                {
                    "full_path": fd.full_path,
                    "file_path_id": fd.row["id"],
                    "pub_id": fd.row["pub_id"],
                    "is_dir": bool(fd.row.get("is_dir")),
                }
            )
        ctx.progress(task_count=len(self.steps), phase="deleting")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        errors = []
        try:
            # rmtree of a deep tree can run for seconds — keep it off
            # the event loop so other jobs/streams keep making progress
            await asyncio.to_thread(_delete_path, step)
        except FileNotFoundError:
            pass  # already gone — the DB row still needs removal
        except OSError as e:
            return StepResult(errors=[f"delete {step['full_path']}: {e}"])

        self._remove_rows(ctx.library, step)
        return StepResult(errors=errors)

    def _remove_rows(self, library, step: dict) -> None:
        db, sync = library.db, library.sync
        rows = [db.find_one("file_path", id=step["file_path_id"])]
        if step["is_dir"] and rows[0] is not None:
            mat = (rows[0]["materialized_path"] or "/") + rows[0]["name"] + "/"
            rows += db.query(
                "SELECT * FROM file_path WHERE location_id = ? AND "
                "(materialized_path = ? OR materialized_path LIKE ? ESCAPE '\\')",
                (rows[0]["location_id"], mat, escape_like(mat) + "%"),
            )
        rows = [r for r in rows if r is not None]
        if not rows:
            return
        ops = [sync.shared_delete("file_path", r["pub_id"].hex()) for r in rows]
        ids = [r["id"] for r in rows]

        def writes(conn):
            qmarks = ",".join("?" for _ in ids)
            conn.execute(f"DELETE FROM file_path WHERE id IN ({qmarks})", ids)

        sync.write_ops(ops, writes)

    async def finalize(self, ctx: JobContext):
        ctx.progress(message="delete complete", phase="done")
        return dict(self.run_metadata)
