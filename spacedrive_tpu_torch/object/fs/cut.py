"""FileCutterJob — move file_paths into a target directory.

Parity: ref:core/src/object/fs/cut.rs — same-path is a no-op
(cut.rs:93-96), an existing target is skipped with a non-critical
"WouldOverwrite" error (cut.rs:98-110), otherwise a rename
(cut.rs:111-122; cross-device falls back to copy+remove, which
`fs::rename` cannot do — shutil.move covers the EXDEV case).

Counterpart of `spacedrive_tpu/object/fs/cut.py`.
"""

from __future__ import annotations

import os
import shutil

from ...jobs import StatefulJob
from ...jobs.job import JobContext, JobError, StepResult
from ...jobs.manager import register_job
from . import (
    construct_target_filename,
    fetch_source_and_target_location_paths,
    get_many_files_datas,
)


@register_job
class FileCutterJob(StatefulJob):
    """init: {source_location_id, target_location_id,
    sources_file_path_ids, target_relative_path}"""

    NAME = "file_cutter"
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
            self.steps.append(
                {
                    "source_path": fd.full_path,
                    "target_path": os.path.join(target_dir, construct_target_filename(fd)),
                }
            )
        self.data["target_directory"] = target_dir
        ctx.progress(task_count=len(self.steps), phase="moving")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        source, target = step["source_path"], step["target_path"]
        if os.path.abspath(source) == os.path.abspath(target):
            return StepResult()
        if os.path.lexists(target):
            return StepResult(errors=[f"would overwrite: {target}"])
        try:
            os.makedirs(os.path.dirname(target), exist_ok=True)
            shutil.move(source, target)
        except OSError as e:
            raise JobError(f"move {source} -> {target}: {e}") from e
        return StepResult()

    async def finalize(self, ctx: JobContext):
        ctx.progress(message="move complete", phase="done")
        return dict(self.run_metadata)
