"""JobManager — ingest/dispatch/pause/resume/cancel/cold_resume.

Parity: ref:core/src/job/manager.rs (Jobs::{ingest,dispatch,pause,
resume,cancel,cold_resume}) + JobBuilder chaining
(ref:core/src/location/mod.rs:455-472 spawns Indexer → FileIdentifier →
MediaProcessor chains). Reports persist in the library's `job` table;
progress streams over the library event bus as JobProgressEvent.

Counterpart of `spacedrive_tpu/jobs/manager.py`, with its job events on
the `jobs` flight ring and its trace context (a job runs under the
trace of the caller that ingested it, or a fresh one, and a chain
continues it), without the attribution plane's pass markers: progress
also reaches the node's bus (what `jobs.progress` reads), a settled job
notifies its outcome (`_notify_outcome`) and a completed one invalidates
the queries its class names in INVALIDATES (`_invalidate_on_complete`).
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any

from ..db.database import now_iso
from ..tasks import TaskStatus, TaskSystem
from ..telemetry import trace as _trace
from ..telemetry.events import JOB_EVENTS
from ..utils.tasks import supervise
from .job import JobContext, JobRunnerTask, StatefulJob, status_for_result
from .report import JobProgressEvent, JobReport, JobStatus

logger = logging.getLogger(__name__)

# name -> class, for cold resume deserialization; populated by
# register_job (each job module registers itself at import).
JOB_REGISTRY: dict[str, type[StatefulJob]] = {}


def register_job(cls: type[StatefulJob]) -> type[StatefulJob]:
    JOB_REGISTRY[cls.NAME] = cls
    return cls


class JobBuilder:
    """JobBuilder(init_job).queue_next(other).spawn(manager, library)."""

    def __init__(self, job: StatefulJob):
        self.job = job

    def queue_next(self, job: StatefulJob) -> "JobBuilder":
        tail = self.job
        while tail.next_jobs:
            tail = tail.next_jobs[-1]
        tail.queue_next(job)
        return self

    async def spawn(self, manager: "JobManager", library: Any) -> uuid.UUID:
        await manager.ingest(self.job, library)
        return self.job.id


class JobManager:
    def __init__(self, task_system: TaskSystem | None = None):
        self.system = task_system or TaskSystem()
        self._active: dict[uuid.UUID, tuple[Any, JobContext]] = {}  # job id -> (handle, ctx)
        self._supervisors: set = set()
        self._supervisor_by_job: dict[uuid.UUID, Any] = {}

    # --- ingest & drive (ref:manager.rs:101-178) ---

    async def ingest(self, job: StatefulJob, library: Any, parent: JobReport | None = None) -> None:
        # the job's trace: the caller's (an rspc mutation, a parent job)
        # when one is active, else a fresh root; the whole chain and
        # every task it dispatches runs under it
        if job.trace_ctx is None:
            job.trace_ctx = _trace.current() or _trace.new_context()
        report = JobReport(
            id=job.id,
            name=job.NAME,
            action=self._action_string(job),
            parent_id=parent.id if parent else None,
            status=JobStatus.QUEUED,
        )
        report.create(library.db)
        JOB_EVENTS.emit("queued", job=job.NAME, id=str(job.id))
        self._dispatch(job, library, report)

    def _dispatch(self, job: StatefulJob, library: Any, report: JobReport) -> None:
        ctx = JobContext(library, report, manager=self)
        report.status = JobStatus.RUNNING
        report.started_at = report.started_at or now_iso()
        report.update(library.db)
        JOB_EVENTS.emit("running", job=job.NAME, id=str(job.id))
        runner = JobRunnerTask(job, ctx)
        # dispatch under the job's context so the task-system boundary
        # carries it (cold resume re-enters here with the deserialized
        # context, and the resumed job continues its original trace)
        with _trace.use(job.trace_ctx):
            handle = self.system.dispatch(runner)
        self._active[job.id] = (handle, ctx)
        # keep a strong ref: the loop only weak-refs tasks and a GC'd
        # supervisor would drop final status writes + job chaining
        sup = supervise(
            asyncio.ensure_future(self._supervise(job, library, handle, ctx)),
            self._supervisors, logger, f"job supervisor ({report.name})",
        )
        self._supervisor_by_job[job.id] = sup
        sup.add_done_callback(lambda _t, jid=job.id: self._supervisor_by_job.pop(jid, None))

    async def _supervise(self, job: StatefulJob, library: Any, handle, ctx: JobContext) -> None:
        result = await handle.wait()
        # close the job's last phase so sd_job_phase_seconds accounts
        # the full wall time, not just up to the last transition
        ctx._close_phase()
        report = ctx.report
        report.status = status_for_result(result.status, bool(job.errors))
        if result.status == TaskStatus.ERROR:
            if isinstance(result.error, asyncio.CancelledError):
                # a cancellation surfacing as ERROR (e.g. re-raised from
                # inside the job body during node shutdown) is not a
                # crash — no spurious failed transition, no error toast
                report.status = JobStatus.CANCELED
            else:
                report.errors_text.append(str(result.error))
        if report.status == JobStatus.PAUSED:
            report.data = job.serialize_state()  # resume state
        else:
            report.data = None
        if report.status.is_finished and report.status != JobStatus.PAUSED:
            report.completed_at = now_iso()
        if isinstance(result.output, dict):
            report.metadata.update(result.output)
        report.update(library.db)
        self._emit_progress(ctx)
        self._active.pop(job.id, None)
        logger.info("job %s -> %s", job.NAME, report.status.name)
        JOB_EVENTS.emit(
            "settled", job=job.NAME, id=str(job.id),
            status=report.status.name,
            errors=len(report.errors_text),
        )

        self._notify_outcome(job, library, report)

        # chain: spawn queued next jobs on success (ref:mod.rs:213-231)
        if report.status in (JobStatus.COMPLETED, JobStatus.COMPLETED_WITH_ERRORS):
            self._invalidate_on_complete(job, library)
            for next_job in job.next_jobs:
                # chained jobs continue the originating trace: the
                # indexer → identifier → media chain is ONE user action
                if next_job.trace_ctx is None:
                    next_job.trace_ctx = job.trace_ctx
                await self.ingest(next_job, library, parent=report)

    @staticmethod
    def _notify_outcome(job: StatefulJob, library: Any, report: JobReport) -> None:
        """Persisted library notification for job outcomes the user
        should see (ref:lib.rs:267-278 emit_notification): failures,
        and the completion of a chain's last job. NOT notified:
        user-initiated cancels (the user already knows), intermediate
        chain stages (one toast per chain, not per stage), and jobs
        flagged `notify_outcome=False` (watcher-triggered rescans fire
        on every filesystem flush — toasting those would spam and grow
        the notification table without bound)."""
        if not getattr(job, "notify_outcome", True):
            return
        node = getattr(library, "node", None)
        if node is None or getattr(node, "notifications", None) is None:
            return
        failed = report.status == JobStatus.FAILED
        partial = report.status == JobStatus.COMPLETED_WITH_ERRORS
        # chain terminus: the last job of a chain (no queued successors)
        chain_done = (
            not job.next_jobs
            and report.status in (JobStatus.COMPLETED,
                                  JobStatus.COMPLETED_WITH_ERRORS)
        )
        if not (failed or chain_done):
            return
        message = None
        if failed and report.errors_text:
            message = report.errors_text[-1][:200]
        elif partial:
            n = len(report.errors_text) or len(job.errors)
            message = f"{n or 'some'} items failed"
            if report.errors_text:
                message += f"; last: {report.errors_text[-1][:150]}"
        try:
            node.notifications.emit_library(library.db, str(library.id), {
                "kind": "error" if failed else ("warning" if partial else "ok"),
                "job": job.NAME,
                "status": report.status.name,
                "message": message,
            })
        except Exception:  # noqa: BLE001 - notifying must never kill a job
            logger.debug("job outcome notification failed", exc_info=True)

    @staticmethod
    def _invalidate_on_complete(job: StatefulJob, library: Any) -> None:
        """Completed jobs invalidate the queries they changed so live
        frontends refetch (the reference's jobs call invalidate_query!
        in finalize, e.g. ref:indexer/indexer_job.rs); keys come from
        the job class's INVALIDATES tuple."""
        keys = getattr(job, "INVALIDATES", ())
        node = getattr(library, "node", None)
        if node is None or getattr(node, "event_bus", None) is None or not keys:
            return
        from ..api.invalidate import invalidate_query

        for key in keys:
            invalidate_query(node, key, library)

    # --- control (ref:manager.rs:222-267) ---

    async def pause(self, job_id: uuid.UUID) -> None:
        """Interrupt at the next step boundary and persist the
        serialized resume state (the reference serializes JobState on
        pause, ref:core/src/job/worker.rs pause handling)."""
        entry = self._active.get(job_id)
        if entry is None:
            return
        handle, ctx = entry
        await handle.pause()
        # job may complete before reaching a pause boundary — wait on
        # whichever happens first
        paused = asyncio.ensure_future(handle.wait_paused())
        done = asyncio.ensure_future(handle.wait())
        await asyncio.wait({paused, done}, return_when=asyncio.FIRST_COMPLETED)
        done.cancel()
        if not paused.done():
            paused.cancel()
            return  # finished instead of pausing; supervisor persists it
        runner = handle.task
        report = ctx.report
        report.status = JobStatus.PAUSED
        report.data = runner.job.serialize_state()
        report.update(ctx.library.db)
        JOB_EVENTS.emit("paused", job=report.name, id=str(job_id))
        self._emit_progress(ctx)

    async def resume(self, job_id: uuid.UUID) -> None:
        entry = self._active.get(job_id)
        if entry:
            await entry[0].resume()
            report = entry[1].report
            report.status = JobStatus.RUNNING
            report.update(entry[1].library.db)
            JOB_EVENTS.emit("resumed", job=report.name, id=str(job_id))

    async def cancel(self, job_id: uuid.UUID) -> None:
        entry = self._active.get(job_id)
        if entry:
            await entry[0].cancel()

    async def wait(self, job_id: uuid.UUID) -> JobReport | None:
        entry = self._active.get(job_id)
        if entry is None:
            return None
        await entry[0].wait()
        # the supervisor writes the final status after the task settles
        sup = self._supervisor_by_job.get(job_id)
        if sup is not None:
            await asyncio.shield(sup)
        return entry[1].report

    async def wait_idle(self) -> None:
        """Wait until no job is actively running (paused/parked jobs
        don't count — they only finish after resume)."""
        while True:
            waiters = [
                asyncio.ensure_future(h.wait())
                for jid, (h, _) in self._active.items()
                if h.task.id not in self.system._paused
            ]
            if not waiters:
                return
            done, pending = await asyncio.wait(waiters, return_when=asyncio.FIRST_COMPLETED)
            for p in pending:
                p.cancel()
            await asyncio.sleep(0)

    # --- crash recovery (ref:manager.rs:269-320) ---

    async def cold_resume(self, library: Any) -> int:
        """Re-dispatch persisted Paused/Running/Queued jobs at library
        load; unparseable ones are marked Canceled."""
        resumed = 0
        rows = library.db.query(
            "SELECT * FROM job WHERE status IN (?, ?, ?) AND parent_id IS NULL",
            (int(JobStatus.PAUSED), int(JobStatus.RUNNING), int(JobStatus.QUEUED)),
        )
        for row in rows:
            report = JobReport.from_row(row)
            if not report.data:
                report.status = JobStatus.CANCELED
                report.update(library.db)
                continue
            try:
                job = StatefulJob.deserialize_state(report.data, JOB_REGISTRY)
            except Exception:  # noqa: BLE001 - corrupt state is expected input
                logger.warning("cold_resume: dropping unparseable job %s", report.name)
                report.status = JobStatus.CANCELED
                report.update(library.db)
                continue
            self._dispatch(job, library, report)
            resumed += 1
        return resumed

    # --- events ---

    def _emit_progress(self, ctx: JobContext) -> None:
        library = ctx.library
        event = ctx.report.progress_event(getattr(library, "id", None))
        bus = getattr(library, "event_bus", None)
        if bus is not None:
            bus.emit(("JobProgress", event))
        # the jobs.progress subscription listens on the NODE bus
        # (CoreEvent::JobProgress, ref:api/mod.rs:54-58); each library
        # has its own private bus, so emit there too
        node_bus = getattr(getattr(library, "node", None), "event_bus", None)
        if node_bus is not None and node_bus is not bus:
            node_bus.emit(("JobProgress", event))

    @staticmethod
    def _action_string(job: StatefulJob) -> str:
        """"{action}(-{children})*" composition (ref:schema.prisma:405)."""
        parts = [job.NAME]
        tail = job.next_jobs
        while tail:
            parts.append(tail[-1].NAME)
            tail = tail[-1].next_jobs
        return "-".join(parts)


async def shutdown_jobs(manager: JobManager, library: Any) -> None:
    """Node shutdown: pause all running jobs so their state persists
    (the reference pauses via WorkerCommand::Shutdown)."""
    for job_id in list(manager._active):
        await manager.pause(job_id)
    await manager.wait_idle()
