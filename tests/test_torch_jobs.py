"""Job-layer tests: run loop, chaining, pause/resume serialization,
cold resume from DB (the recovery path the reference exercises via
Jobs::cold_resume, ref:core/src/job/manager.rs:269-320).

The JAX package's tests/test_jobs.py, pointed at the port package.
"""

import asyncio
import uuid

import pytest

from spacedrive_tpu_torch.db import LibraryDb
from spacedrive_tpu_torch.jobs import JobBuilder, JobManager, JobStatus, StatefulJob
from spacedrive_tpu_torch.jobs.job import JobContext, StepResult
from spacedrive_tpu_torch.jobs.manager import JOB_REGISTRY, register_job
from spacedrive_tpu_torch.tasks import TaskSystem
from spacedrive_tpu_torch.utils.events import EventBus


class FakeLibrary:
    def __init__(self):
        self.id = uuid.uuid4()
        self.db = LibraryDb(None, memory=True)
        self.event_bus = EventBus()


@register_job
class CountJob(StatefulJob):
    NAME = "count"

    async def init_job(self, ctx):
        self.data["total"] = 0
        for i in range(self.init.get("steps", 5)):
            self.steps.append({"n": i})

    async def execute_step(self, ctx, step, step_number):
        await asyncio.sleep(self.init.get("step_time", 0.002))
        self.data["total"] += step["n"]
        return StepResult(metadata={"sum": self.data["total"]})

    async def finalize(self, ctx):
        return {"sum": self.data["total"]}


@register_job
class GrowJob(StatefulJob):
    NAME = "grow"

    async def init_job(self, ctx):
        self.steps.append({"kind": "seed"})

    async def execute_step(self, ctx, step, step_number):
        if step["kind"] == "seed":
            return StepResult(more_steps=[{"kind": "leaf"}] * 3)
        self.data.setdefault("leaves", 0)
        self.data["leaves"] += 1
        return StepResult()


@register_job
class FailJob(StatefulJob):
    NAME = "fail"

    async def init_job(self, ctx):
        self.steps.append({})

    async def execute_step(self, ctx, step, step_number):
        raise ValueError("boom")


@pytest.fixture()
def library():
    return FakeLibrary()


@pytest.mark.asyncio
async def test_job_completes_and_persists_report(library):
    mgr = JobManager(TaskSystem(2))
    job = CountJob({"steps": 5})
    await mgr.ingest(job, library)
    report = await mgr.wait(job.id)
    await mgr.wait_idle()
    assert report.status == JobStatus.COMPLETED
    assert report.metadata["sum"] == 10
    row = library.db.find_one("job", id=job.id.bytes)
    assert row["status"] == int(JobStatus.COMPLETED)
    assert row["completed_task_count"] == 5
    await mgr.system.shutdown()


@pytest.mark.asyncio
async def test_steps_can_append_steps(library):
    mgr = JobManager(TaskSystem(2))
    job = GrowJob()
    await mgr.ingest(job, library)
    await mgr.wait(job.id)
    await mgr.wait_idle()
    assert job.data["leaves"] == 3
    await mgr.system.shutdown()


@pytest.mark.asyncio
async def test_failed_job(library):
    mgr = JobManager(TaskSystem(2))
    job = FailJob()
    await mgr.ingest(job, library)
    report = await mgr.wait(job.id)
    await mgr.wait_idle()
    assert report.status == JobStatus.FAILED
    assert "boom" in " ".join(report.errors_text)
    await mgr.system.shutdown()


@pytest.mark.asyncio
async def test_job_chaining(library):
    mgr = JobManager(TaskSystem(2))
    first = CountJob({"steps": 2})
    second = CountJob({"steps": 3})
    builder = JobBuilder(first).queue_next(second)
    await builder.spawn(mgr, library)
    await mgr.wait(first.id)
    await mgr.wait_idle()
    rows = library.db.query("SELECT * FROM job ORDER BY date_created")
    assert len(rows) == 2
    child = library.db.find_one("job", id=second.id.bytes)
    assert child["parent_id"] == first.id.bytes
    assert child["status"] == int(JobStatus.COMPLETED)
    await mgr.system.shutdown()


@pytest.mark.asyncio
async def test_pause_serializes_and_resume_completes(library):
    mgr = JobManager(TaskSystem(2))
    job = CountJob({"steps": 300, "step_time": 0.003})
    await mgr.ingest(job, library)
    await asyncio.sleep(0.05)
    await mgr.pause(job.id)
    handle, ctx = mgr._active[job.id]
    # paused: handle pending, state persisted to the job table
    assert not handle.done()
    assert 0 < job.step_number < 300
    row = library.db.find_one("job", id=job.id.bytes)
    assert row["status"] == int(JobStatus.PAUSED) and row["data"]
    await mgr.resume(job.id)
    report = await mgr.wait(job.id)
    await mgr.wait_idle()
    assert report.status == JobStatus.COMPLETED
    await mgr.system.shutdown()


@pytest.mark.asyncio
async def test_shutdown_pause_then_cold_resume(library):
    mgr = JobManager(TaskSystem(2))
    job = CountJob({"steps": 400, "step_time": 0.003})
    await mgr.ingest(job, library)
    await asyncio.sleep(0.05)
    # node shutdown: pause persists serialized state immediately
    await mgr.pause(job.id)
    row = library.db.find_one("job", id=job.id.bytes)
    assert row["status"] == int(JobStatus.PAUSED) and row["data"]
    await mgr.system.shutdown()

    # new manager (fresh "process"): cold_resume picks the job up
    mgr2 = JobManager(TaskSystem(2))
    resumed = await mgr2.cold_resume(library)
    assert resumed == 1
    new_id = next(iter(mgr2._active))
    report2 = await mgr2.wait(new_id)
    await mgr2.wait_idle()
    assert report2.status == JobStatus.COMPLETED
    assert report2.completed_task_count == 400
    await mgr2.system.shutdown()


@pytest.mark.asyncio
async def test_cold_resume_drops_unparseable(library):
    lib = library
    lib.db.insert(
        "job", id=uuid.uuid4().bytes, name="count",
        status=int(JobStatus.PAUSED), data=b"not msgpack at all",
        date_created="2024-01-01",
    )
    mgr = JobManager(TaskSystem(1))
    resumed = await mgr.cold_resume(lib)
    assert resumed == 0
    row = lib.db.query("SELECT * FROM job")[0]
    assert row["status"] == int(JobStatus.CANCELED)
    await mgr.system.shutdown()


def test_registry_contains_jobs():
    assert "count" in JOB_REGISTRY and "grow" in JOB_REGISTRY


@pytest.mark.asyncio
async def test_progress_events_stream(library):
    mgr = JobManager(TaskSystem(1))
    sub = library.event_bus.subscribe()
    job = CountJob({"steps": 4})
    await mgr.ingest(job, library)
    await mgr.wait(job.id)
    await mgr.wait_idle()
    events = [e for e in sub.poll() if e[0] == "JobProgress"]
    assert events
    last = events[-1][1]
    assert last.completed_task_count == 4 and last.task_count == 4
    await mgr.system.shutdown()
