"""StatefulJob — the resumable job contract + generic runner task.

Parity: ref:core/src/job/mod.rs:85-130 (trait: init → steps →
execute_step → finalize), :266-307 (serialized JobState{init, data,
steps, step_number, run_metadata}), :463-700 (generic run loop with
pause/cancel handling at step boundaries).

Steps and state are msgpack-serializable dicts so any job can be
persisted mid-flight and cold-resumed after a crash.

Counterpart of `spacedrive_tpu/jobs/job.py`: each phase's wall time goes
to `sd_job_phase_seconds`, and a job carries its trace context through
pause, serialization and resume.
"""

from __future__ import annotations

import abc
import collections
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, TYPE_CHECKING

from ..tasks import ExecStatus, Interrupter, InterruptionKind, Task
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
from ..utils.msgpack_codec import packb, unpackb
from .report import JobReport, JobStatus

if TYPE_CHECKING:
    from .manager import JobManager

logger = logging.getLogger(__name__)


class JobError(Exception):
    """Critical job failure (job → Failed)."""


@dataclass
class StepResult:
    """Outcome of one step (ref JobStepOutput): optional extra steps to
    append, optional non-critical errors, metadata merge."""

    more_steps: list[dict] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    metadata: dict[str, Any] = field(default_factory=dict)


class JobContext:
    """What a job sees while running: the library handle, progress
    reporting, and node-level services (thumbnailer etc.)."""

    def __init__(self, library: Any, report: JobReport, manager: "JobManager | None" = None):
        self.library = library
        self.report = report
        self.manager = manager
        self._started = time.monotonic()
        self._phase: str | None = None
        self._phase_started = self._started

    def progress(
        self,
        *,
        task_count: int | None = None,
        completed_task_count: int | None = None,
        message: str | None = None,
        phase: str | None = None,
    ) -> None:
        r = self.report
        if task_count is not None:
            r.task_count = task_count
        if completed_task_count is not None:
            r.completed_task_count = completed_task_count
        if message is not None:
            r.message = message
        if phase is not None:
            r.phase = phase
            if phase != self._phase:
                self._close_phase()
                self._phase = phase
        r.estimate_completion(time.monotonic() - self._started)
        if self.manager is not None:
            self.manager._emit_progress(self)

    def _close_phase(self) -> None:
        """Observe the elapsed phase into sd_job_phase_seconds; the
        pre-first-phase stretch records as "init". Called on every
        phase transition and by the manager when the job settles."""
        now = time.monotonic()
        _tm.JOB_PHASE_SECONDS.observe(
            now - self._phase_started,
            job=self.report.name,
            phase=self._phase or "init",
        )
        self._phase_started = now


class StatefulJob(abc.ABC):
    """Subclass contract: override NAME, `init_job`, `execute_step`,
    optionally `finalize` and `IS_BATCHED`."""

    NAME: str = "unnamed"
    IS_BATCHED: bool = False  # batched jobs report per-batch progress

    def __init__(self, init: dict[str, Any] | None = None):
        self.id = uuid.uuid4()
        self.init: dict[str, Any] = init or {}
        self.data: dict[str, Any] = {}
        self.steps: collections.deque[dict] = collections.deque()
        self.step_number: int = 0
        self.run_metadata: dict[str, Any] = {}
        self.errors: list[str] = []
        self.initialized = False
        self.next_jobs: list["StatefulJob"] = []
        # distributed-trace context: minted or inherited at ingest,
        # carried through pause/resume (it serializes with the job
        # state) and down job chains, so one user action is one trace
        self.trace_ctx: "_trace.TraceContext | None" = None

    # --- contract ---

    @abc.abstractmethod
    async def init_job(self, ctx: JobContext) -> None:
        """Populate `self.steps` (and `self.data`)."""

    @abc.abstractmethod
    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        ...

    async def finalize(self, ctx: JobContext) -> Any:
        return self.run_metadata

    # --- chaining (ref:core/src/job/mod.rs:213-231) ---

    def queue_next(self, job: "StatefulJob") -> "StatefulJob":
        self.next_jobs.append(job)
        return self

    def cleanup(self) -> None:
        """Release runtime-only resources; called by the runner on every
        exit path (done/paused/cancelled/failed). Must be idempotent."""

    # --- persistence (ref:core/src/job/mod.rs:266-307) ---

    def serialize_state(self) -> bytes:
        return packb(
            {
                "id": self.id.bytes,
                "name": self.NAME,
                "init": self.init,
                "data": self.data,
                "steps": list(self.steps),
                "step_number": self.step_number,
                "run_metadata": self.run_metadata,
                "errors": self.errors,
                "initialized": self.initialized,
                "next_jobs": [j.serialize_state() for j in self.next_jobs],
                # a resumed job continues its original trace
                "trace": self.trace_ctx.to_wire() if self.trace_ctx else None,
            }
        )

    @classmethod
    def deserialize_state(cls, raw: bytes, registry: dict[str, type["StatefulJob"]]) -> "StatefulJob":
        obj = unpackb(raw)
        job_cls = registry[obj["name"]]
        job = job_cls(obj["init"])
        job.id = uuid.UUID(bytes=obj["id"])
        job.data = obj["data"]
        job.steps = collections.deque(obj["steps"])
        job.step_number = obj["step_number"]
        job.run_metadata = obj["run_metadata"]
        job.errors = obj.get("errors", [])
        job.initialized = obj["initialized"]
        job.next_jobs = [
            StatefulJob.deserialize_state(r, registry) for r in obj.get("next_jobs", [])
        ]
        job.trace_ctx = _trace.TraceContext.from_wire(obj.get("trace"))
        return job


class JobRunnerTask(Task):
    """Drives one StatefulJob through the task system. Interruption is
    honored at step boundaries — the device-batch preemption model: a
    dispatched batch is atomic, pausing drains to the boundary and
    serializes what's left (ref run loop: core/src/job/mod.rs:463-700).
    """

    def __init__(self, job: StatefulJob, ctx: JobContext):
        super().__init__()
        self.job = job
        self.ctx = ctx
        self.output: Any = None

    async def run(self, interrupter: Interrupter) -> ExecStatus:
        job, ctx = self.job, self.ctx
        report = ctx.report
        # normally the task system installed the dispatch-time context;
        # a directly-driven runner (tests, tools) still continues the
        # job's own trace
        trace_token = (
            _trace.set_current(job.trace_ctx)
            if _trace.current() is None and job.trace_ctx is not None
            else None
        )
        try:
            if not job.initialized:
                await job.init_job(ctx)
                job.initialized = True
                report.task_count = max(report.task_count, len(job.steps))
                ctx.progress(task_count=report.task_count)

            while job.steps:
                kind = interrupter.check()
                if kind in (InterruptionKind.PAUSE, InterruptionKind.SUSPEND):
                    return ExecStatus.PAUSED
                if kind == InterruptionKind.CANCEL:
                    return ExecStatus.CANCELED

                step = job.steps.popleft()
                result = await job.execute_step(ctx, step, job.step_number)
                job.step_number += 1
                if result.more_steps:
                    job.steps.extend(result.more_steps)
                    report.task_count += len(result.more_steps)
                if result.errors:
                    job.errors.extend(result.errors)
                    report.errors_text.extend(result.errors)
                if result.metadata:
                    job.run_metadata.update(result.metadata)
                ctx.progress(completed_task_count=job.step_number)

            self.output = await job.finalize(ctx)
            return ExecStatus.DONE
        except JobError:
            raise
        except Exception as e:  # noqa: BLE001 - surfaced as job failure
            logger.exception("job %s failed", job.NAME)
            raise JobError(str(e)) from e
        finally:
            if trace_token is not None:
                _trace.reset_current(trace_token)
            # runs on DONE, pause, cancel, and failure alike — jobs
            # release runtime-only resources (thread pools, prefetch
            # buffers) here, never in finalize (which pause skips)
            try:
                job.cleanup()
            except Exception:
                logger.exception("job %s cleanup failed", job.NAME)


def status_for_result(status: "Any", had_errors: bool) -> JobStatus:
    from ..tasks import TaskStatus

    if status == TaskStatus.DONE:
        return JobStatus.COMPLETED_WITH_ERRORS if had_errors else JobStatus.COMPLETED
    # FORCED_ABORTION is the task coroutine being cancelled out from
    # under the job — loop teardown at node shutdown, or an explicit
    # force-abort. Either way nothing *failed*: recording it as FAILED
    # put a spurious `job.failed`-shaped settled event on the flight
    # ring (and an error toast) every time a node shut down mid-job.
    if status in (TaskStatus.CANCELED, TaskStatus.FORCED_ABORTION):
        return JobStatus.CANCELED
    if status in (TaskStatus.PAUSED, TaskStatus.SHUTDOWN):
        return JobStatus.PAUSED
    return JobStatus.FAILED
