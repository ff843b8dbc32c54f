"""Task-system integration tests.

Mirrors the scenario shape of the reference's suite
(ref:crates/task-system/tests/integration_test.rs: ready/never/bogus
tasks, pause, cancel, abort, shutdown-returns-tasks, steal) with
deterministic fake workloads.

The JAX package's tests/test_task_system.py, pointed at the port package.
"""

import asyncio

import pytest

from spacedrive_tpu_torch.tasks import (
    ExecStatus,
    Interrupter,
    InterruptionKind,
    Task,
    TaskStatus,
    TaskSystem,
)


class ReadyTask(Task):
    """Completes immediately with an output."""

    def __init__(self, value=42, **kw):
        super().__init__(**kw)
        self.value = value
        self.output = None

    async def run(self, interrupter: Interrupter) -> ExecStatus:
        self.output = self.value
        return ExecStatus.DONE


class StepTask(Task):
    """Counts steps with interrupter checkpoints; resumable."""

    def __init__(self, steps=10, step_time=0.005, **kw):
        super().__init__(**kw)
        self.steps = steps
        self.step_time = step_time
        self.completed = 0
        self.output = None
        self.started = asyncio.Event()

    async def run(self, interrupter: Interrupter) -> ExecStatus:
        self.started.set()
        while self.completed < self.steps:
            kind = interrupter.check()
            if kind in (InterruptionKind.PAUSE, InterruptionKind.SUSPEND):
                return ExecStatus.PAUSED
            if kind == InterruptionKind.CANCEL:
                return ExecStatus.CANCELED
            await asyncio.sleep(self.step_time)
            self.completed += 1
        self.output = self.completed
        return ExecStatus.DONE


class NeverTask(Task):
    """Runs until interrupted (ref NeverTask)."""

    async def run(self, interrupter: Interrupter) -> ExecStatus:
        kind = await interrupter.wait_interrupt()
        if kind == InterruptionKind.CANCEL:
            return ExecStatus.CANCELED
        return ExecStatus.PAUSED


class BogusTask(Task):
    async def run(self, interrupter: Interrupter) -> ExecStatus:
        raise RuntimeError("bogus")


class HangingTask(Task):
    """Ignores the interrupter entirely; only force-abort stops it."""

    async def run(self, interrupter: Interrupter) -> ExecStatus:
        await asyncio.sleep(3600)
        return ExecStatus.DONE


@pytest.fixture()
def system():
    return TaskSystem(worker_count=4)


async def _shutdown(system):
    await system.shutdown()


@pytest.mark.asyncio
async def test_done_task(system):
    result = await system.dispatch(ReadyTask(7)).wait()
    assert result.status == TaskStatus.DONE and result.output == 7
    await _shutdown(system)


@pytest.mark.asyncio
async def test_many_tasks_all_complete(system):
    handles = system.dispatch_many([ReadyTask(i) for i in range(100)])
    results = await asyncio.gather(*(h.wait() for h in handles))
    assert [r.output for r in results] == list(range(100))
    await _shutdown(system)


@pytest.mark.asyncio
async def test_error_task(system):
    result = await system.dispatch(BogusTask()).wait()
    assert result.status == TaskStatus.ERROR
    assert isinstance(result.error, RuntimeError)
    await _shutdown(system)


@pytest.mark.asyncio
async def test_pause_resume(system):
    task = StepTask(steps=50)
    handle = system.dispatch(task)
    await task.started.wait()
    await handle.pause()
    await handle.wait_paused()
    done_at_pause = task.completed
    assert not handle.done() and done_at_pause < 50
    await handle.resume()
    result = await handle.wait()
    assert result.status == TaskStatus.DONE and result.output == 50
    await _shutdown(system)


@pytest.mark.asyncio
async def test_cancel_running(system):
    task = NeverTask()
    handle = system.dispatch(task)
    await asyncio.sleep(0.02)
    await handle.cancel()
    result = await handle.wait()
    assert result.status == TaskStatus.CANCELED
    await _shutdown(system)


@pytest.mark.asyncio
async def test_cancel_queued(system):
    blockers = [NeverTask() for _ in range(4)]
    for b in blockers:
        system.dispatch(b)
    queued = ReadyTask()
    handle = system.dispatch(queued)
    await handle.cancel()
    result = await handle.wait()
    assert result.status == TaskStatus.CANCELED
    for b in blockers:
        await system._force_abort(b.id)
    await _shutdown(system)


@pytest.mark.asyncio
async def test_force_abort(system):
    task = HangingTask()
    handle = system.dispatch(task)
    await asyncio.sleep(0.02)
    await handle.force_abort()
    result = await handle.wait()
    assert result.status == TaskStatus.FORCED_ABORTION
    await _shutdown(system)


@pytest.mark.asyncio
async def test_priority_suspends_running(system):
    sys1 = TaskSystem(worker_count=1)
    slow = StepTask(steps=200, step_time=0.003)
    h_slow = sys1.dispatch(slow)
    await slow.started.wait()
    await asyncio.sleep(0.02)
    prio = ReadyTask(99, priority=True)
    h_prio = sys1.dispatch(prio)
    r_prio = await h_prio.wait()
    assert r_prio.status == TaskStatus.DONE
    # the suspended task must not be finished yet, then complete on its own
    assert not h_slow.done()
    r_slow = await h_slow.wait()
    assert r_slow.status == TaskStatus.DONE and r_slow.output == 200
    await _shutdown(sys1)


@pytest.mark.asyncio
async def test_work_stealing_spreads_load():
    system = TaskSystem(worker_count=4)
    # enqueue everything onto one worker, others must steal
    system.start()
    from spacedrive_tpu_torch.tasks.task import TaskHandle

    tasks = [StepTask(steps=3, step_time=0.001) for _ in range(40)]
    handles = []
    for t in tasks:
        handle = TaskHandle(t, system)
        system._handles[t.id] = handle
        system.workers[0].enqueue(handle)
        handles.append(handle)
    results = await asyncio.gather(*(h.wait() for h in handles))
    assert all(r.status == TaskStatus.DONE for r in results)
    await _shutdown(system)


@pytest.mark.asyncio
async def test_shutdown_returns_unfinished():
    system = TaskSystem(worker_count=2)
    running = [NeverTask(), NeverTask()]
    queued = [StepTask(steps=1000) for _ in range(6)]
    handles = [system.dispatch(t) for t in running + queued]
    await asyncio.sleep(0.05)
    leftover = await system.shutdown()
    # both running tasks pause + all queued return
    assert len(leftover) + sum(1 for h in handles if h.done()) >= len(handles)
    statuses = [ (await h.wait()).status for h in handles ]
    assert all(s in (TaskStatus.SHUTDOWN, TaskStatus.DONE) for s in statuses)
    assert any(s == TaskStatus.SHUTDOWN for s in statuses)


def test_supervise_helper_retains_and_retrieves():
    """utils.tasks.supervise — the canonical SD003 remediation: retains
    the handle, discards on completion, and retrieves+logs the exception
    so it can never become an unraisable GC warning."""
    import logging

    from spacedrive_tpu_torch.utils.tasks import supervise

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("test.supervise")
    logger.addHandler(Capture())
    logger.setLevel(logging.ERROR)

    async def run():
        tasks: set = set()

        async def ok():
            return 42

        async def boom():
            raise RuntimeError("nope")

        t1 = supervise(asyncio.get_running_loop().create_task(ok()),
                       tasks, logger, "ok task")
        t2 = supervise(asyncio.get_running_loop().create_task(boom()),
                       tasks, logger, "boom task")
        assert tasks == {t1, t2}
        await asyncio.gather(t1, t2, return_exceptions=True)
        await asyncio.sleep(0)  # let done-callbacks run
        assert not tasks  # drained

    asyncio.run(run())
    assert any("boom task failed" in m for m in records)
    assert not any("ok task" in m for m in records)
