"""FileEraserJob — secure-overwrite then delete.

Parity: ref:core/src/object/fs/erase.rs — directories expand to one
step per child and are collected for removal at finalize
(erase.rs:104-141); files are overwritten `passes` times with random
data in BLOCK_LEN blocks, truncated, flushed, then removed
(erase.rs:143-177; the overwrite loop itself is
ref:crates/crypto/src/fs/erase.rs:18-42). Erased rows leave the DB in
the same transaction as their CRDT delete ops.

Counterpart of `spacedrive_tpu/object/fs/erase.py`. The overwrite's
random bytes come from an explicit generator (`random_bytes`,
`os.urandom` unless a caller sets another), so a seeded run can be held
to the bytes another writes. Each step pauses the watcher on its own
file only, and the finalizer on the erased rows' paths while it removes
their directories and rows, so the watcher sets those directories'
sizes once the rows are gone.
"""

from __future__ import annotations

import os
from typing import Callable

from ...db.database import escape_like
from ...files.isolated_path import full_path_from_db_row
from ...jobs import StatefulJob
from ...jobs.job import JobContext, StepResult
from ...jobs.manager import register_job
from . import get_location_path, get_many_files_datas, watcher_pause

BLOCK_LEN = 1 << 20  # ref:crates/crypto/src/primitives.rs BLOCK_LEN


def erase_file(path: str, passes: int,
               random_bytes: Callable[[int], bytes] = os.urandom) -> None:
    """Overwrite with random data block-wise, pass by pass, then
    truncate (ref:crates/crypto/src/fs/erase.rs:18-42)."""
    with open(path, "r+b") as f:
        size = os.fstat(f.fileno()).st_size
        block_count, additional = divmod(size, BLOCK_LEN)
        for _ in range(max(1, passes)):
            f.seek(0)
            for _ in range(block_count):
                f.write(random_bytes(BLOCK_LEN))
            if additional:
                f.write(random_bytes(additional))
            f.flush()
            os.fsync(f.fileno())
        f.truncate(0)


@register_job
class FileEraserJob(StatefulJob):
    """init: {location_id, file_path_ids, passes}"""

    NAME = "file_eraser"
    #: the overwrite's generator: n -> n random bytes
    random_bytes: Callable[[int], bytes] = staticmethod(os.urandom)

    async def init_job(self, ctx: JobContext) -> None:
        db = ctx.library.db
        loc_path = get_location_path(db, self.init["location_id"])
        for fd in get_many_files_datas(db, loc_path, self.init["file_path_ids"]):
            self.steps.append(
                {
                    "full_path": fd.full_path,
                    "file_path_id": fd.row["id"],
                    "is_dir": bool(fd.row.get("is_dir")),
                }
            )
        self.run_metadata["directories_to_remove"] = []
        ctx.progress(task_count=len(self.steps), phase="erasing")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        full_path = step["full_path"]
        if os.path.islink(full_path):
            # never follow links: unlink only, the target is out of scope
            try:
                os.remove(full_path)
            except OSError as e:
                return StepResult(errors=[f"unlink {full_path}: {e}"])
            return StepResult()

        if step["is_dir"]:
            more = []
            try:
                children = sorted(os.listdir(full_path))
            except OSError as e:
                return StepResult(errors=[f"read_dir {full_path}: {e}"])
            for child in children:
                child_path = os.path.join(full_path, child)
                more.append(
                    {
                        "full_path": child_path,
                        "file_path_id": None,
                        "is_dir": os.path.isdir(child_path) and not os.path.islink(child_path),
                    }
                )
            dirs = self.run_metadata["directories_to_remove"] + [full_path]
            return StepResult(more_steps=more, metadata={"directories_to_remove": dirs})

        try:
            # the overwrite passes fire MODIFY storms; don't let the
            # watcher rescan a file that's being scrambled
            with watcher_pause(ctx, self.init["location_id"], [full_path]):
                erase_file(full_path, self.init.get("passes", 1), self.random_bytes)
                os.remove(full_path)
        except FileNotFoundError:
            pass
        except OSError as e:
            return StepResult(errors=[f"erase {full_path}: {e}"])
        return StepResult()

    async def finalize(self, ctx: JobContext):
        db = ctx.library.db
        loc_path = get_location_path(db, self.init["location_id"])
        erased = [row for fp_id in self.init["file_path_ids"]
                  if (row := db.find_one("file_path", id=fp_id)) is not None]
        with watcher_pause(ctx, self.init["location_id"],
                           [full_path_from_db_row(loc_path, r) for r in erased]):
            self._remove_dirs_and_rows(ctx, loc_path, erased)
        ctx.progress(message="erase complete", phase="done")
        return dict(self.run_metadata)

    def _remove_dirs_and_rows(self, ctx: JobContext, loc_path: str, erased: list[dict]) -> None:
        # deepest-first so children go before parents (ref:erase.rs:181-196)
        db, sync = ctx.library.db, ctx.library.sync
        for d in sorted(self.run_metadata["directories_to_remove"], key=len, reverse=True):
            try:
                os.rmdir(d)
            except OSError as e:
                self.errors.append(f"rmdir {d}: {e}")
        candidates = []
        for row in erased:
            candidates.append(row)
            if row.get("is_dir"):
                mat = (row["materialized_path"] or "/") + row["name"] + "/"
                candidates += db.query(
                    "SELECT * FROM file_path WHERE location_id = ? AND "
                    "(materialized_path = ? OR materialized_path LIKE ? ESCAPE '\\')",
                    (row["location_id"], mat, escape_like(mat) + "%"),
                )
        # only rows whose on-disk path is actually gone — a failed erase
        # must keep its library record
        rows = [
            r for r in candidates
            if not os.path.lexists(full_path_from_db_row(loc_path, r))
        ]
        if rows:
            ops = [sync.shared_delete("file_path", r["pub_id"].hex()) for r in rows]
            ids = [r["id"] for r in rows]

            def writes(conn):
                qmarks = ",".join("?" for _ in ids)
                conn.execute(f"DELETE FROM file_path WHERE id IN ({qmarks})", ids)

            sync.write_ops(ops, writes)
