"""FileCopierJob — recursive copy with duplicate renaming.

Parity: ref:core/src/object/fs/copy.rs — init resolves source FileDatas
and target paths, renaming when source == target
(copy.rs:60-106); execute_step: directories create the target dir and
push one more step per child (copy.rs:118-160), files copy with
"(N)" renaming when the target already exists (copy.rs:162-200).

Counterpart of `spacedrive_tpu/object/fs/copy.py`. The copies land in a
watched target, whose watcher rescans them: they link to the objects
their sources already have.
"""

from __future__ import annotations

import logging
import os
import shutil

from ...jobs import StatefulJob
from ...jobs.job import JobContext, JobError, StepResult
from ...jobs.manager import register_job
from . import (
    construct_target_filename,
    fetch_source_and_target_location_paths,
    find_available_filename_for_duplicate,
    get_many_files_datas,
)

logger = logging.getLogger(__name__)


@register_job
class FileCopierJob(StatefulJob):
    """init: {source_location_id, target_location_id,
    sources_file_path_ids, target_relative_path}"""

    NAME = "file_copier"
    INVALIDATES = ("search.paths",)

    async def init_job(self, ctx: JobContext) -> None:
        db = ctx.library.db
        init = self.init
        src_loc_path, tgt_loc_path = fetch_source_and_target_location_paths(
            db, init["source_location_id"], init["target_location_id"]
        )
        target_dir = os.path.normpath(
            os.path.join(tgt_loc_path, init.get("target_relative_path", "").lstrip("/"))
        )
        for fd in get_many_files_datas(db, src_loc_path, init["sources_file_path_ids"]):
            target = os.path.join(target_dir, construct_target_filename(fd))
            if os.path.abspath(fd.full_path) == os.path.abspath(target):
                target = find_available_filename_for_duplicate(target)
            self.steps.append(
                {
                    "source_path": fd.full_path,
                    "target_path": target,
                    "is_dir": bool(fd.row.get("is_dir")),
                }
            )
        self.data["sources_location_path"] = src_loc_path
        # copy targets must never become copy sources (directory copied
        # into its own subtree would otherwise recurse forever)
        self.data["target_roots"] = [
            os.path.abspath(s["target_path"]) for s in self.steps if s["is_dir"]
        ]
        ctx.progress(task_count=len(self.steps), phase="copying")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        source, target = step["source_path"], step["target_path"]
        if step["is_dir"]:
            # snapshot children BEFORE creating the target: copying a
            # directory into itself must not descend into the copy
            try:
                children = sorted(os.listdir(source))
            except OSError as e:
                raise JobError(f"read_dir {source}: {e}") from e
            os.makedirs(target, exist_ok=True)
            skip = {os.path.abspath(target), *self.data.get("target_roots", [])}
            more = []
            for child in children:
                child_path = os.path.join(source, child)
                child_abs = os.path.abspath(child_path)
                if any(child_abs == t or child_abs.startswith(t + os.sep) for t in skip):
                    continue
                more.append(
                    {
                        "source_path": child_path,
                        "target_path": os.path.join(target, child),
                        "is_dir": os.path.isdir(child_path),
                    }
                )
            return StepResult(more_steps=more)

        if os.path.exists(target):
            target = find_available_filename_for_duplicate(target)
        try:
            os.makedirs(os.path.dirname(target), exist_ok=True)
            shutil.copy2(source, target)
        except OSError as e:
            raise JobError(f"copy {source} -> {target}: {e}") from e
        return StepResult()

    async def finalize(self, ctx: JobContext):
        ctx.progress(message="copy complete", phase="done")
        return dict(self.run_metadata)
