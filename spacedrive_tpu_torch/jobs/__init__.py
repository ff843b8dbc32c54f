"""Stateful job layer — long-running, persistent, resumable pipelines.

Parity: the reference's production job system (ref:core/src/job/):
`StatefulJob` (init → step queue → execute_step loop → finalize),
msgpack-serialized `JobState` persisted to the `job` table for
pause/resume and crash recovery, report/progress events, `queue_next`
chaining, and a manager with ingest/dispatch/pause/resume/cancel/
cold_resume.

Device-first design: steps are *batch descriptors*; the generic runner
drives them through the task system so step execution interleaves with
other work and can suspend at batch boundaries (the only preemption
points a device dispatch allows).

Counterpart of `spacedrive_tpu/jobs/__init__.py`.
"""

from .job import JobContext, JobError, StatefulJob, StepResult
from .report import JobReport, JobStatus, JobProgressEvent
from .manager import JobManager, JobBuilder

__all__ = [
    "JobContext",
    "JobError",
    "StatefulJob",
    "StepResult",
    "JobReport",
    "JobStatus",
    "JobProgressEvent",
    "JobManager",
    "JobBuilder",
]
