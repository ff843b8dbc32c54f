"""TaskSystem — cooperative multi-worker scheduler with work stealing.

Parity: ref:crates/task-system/src/system.rs (round-robin `dispatch`,
least-loaded `dispatch_many`, worker-per-core), worker/mod.rs:282
(stealing), worker/runner.rs:46-115 (priority suspension), and the
shutdown contract that returns unfinished tasks to the caller
(ref:src/task.rs:69-71). Implemented over one asyncio loop: "workers"
are concurrent coroutines, which matches this framework's workload
(batch assembly + device-step awaiting + async IO).

Counterpart of `spacedrive_tpu/tasks/system.py`, without its metrics,
trace propagation and process-pool hold.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
from typing import Iterable

from .task import (
    ExecStatus,
    Interrupter,
    InterruptionKind,
    Task,
    TaskHandle,
    TaskResult,
    TaskStatus,
)

logger = logging.getLogger(__name__)


class _Worker:
    def __init__(self, system: "TaskSystem", index: int):
        self.system = system
        self.index = index
        self.queue: collections.deque[TaskHandle] = collections.deque()
        self.current: TaskHandle | None = None
        self.current_interrupter: Interrupter | None = None
        self.current_coro: asyncio.Task | None = None
        self.wakeup = asyncio.Event()
        self.runner: asyncio.Task | None = None

    # -- queue ops --

    def enqueue(self, handle: TaskHandle) -> None:
        if handle.task.priority:
            self.queue.appendleft(handle)
            # suspend a running non-priority task so the priority one
            # starts now (ref:worker/runner.rs:46-115)
            if (
                self.current is not None
                and not self.current.task.priority
                and self.current_interrupter is not None
            ):
                self.current_interrupter.interrupt(InterruptionKind.SUSPEND)
        else:
            self.queue.append(handle)
        self.wakeup.set()

    def load(self) -> int:
        return len(self.queue) + (1 if self.current else 0)

    def steal_from(self) -> TaskHandle | None:
        """Steal from the back (oldest non-priority work)."""
        if self.queue:
            return self.queue.pop()
        return None

    # -- main loop --

    async def run_loop(self) -> None:
        while True:
            if self.system._shutting_down:
                # stop immediately; queued tasks are returned to the
                # caller by shutdown(), not drained (ref:system.rs:224)
                return
            handle = self._next() or self.system._steal(self.index)
            if handle is None:
                self.wakeup.clear()
                try:
                    await asyncio.wait_for(self.wakeup.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    continue
                continue
            await self._execute(handle)

    def _next(self) -> TaskHandle | None:
        while self.queue:
            handle = self.queue.popleft()
            if not handle.done():
                return handle
        return None

    async def _execute(self, handle: TaskHandle) -> None:
        task = handle.task
        interrupter = Interrupter()
        self.current = handle
        self.current_interrupter = interrupter
        self.system._running[task.id] = self
        self.current_coro = asyncio.ensure_future(task.run(interrupter))
        try:
            status = await self.current_coro
        except asyncio.CancelledError:
            handle._resolve(TaskResult(TaskStatus.FORCED_ABORTION, task=task))
            return
        except Exception as e:  # noqa: BLE001 - task errors are data
            logger.exception("task %r failed", task)
            handle._resolve(TaskResult(TaskStatus.ERROR, error=e, task=task))
            return
        finally:
            self.current = None
            self.current_interrupter = None
            self.current_coro = None
            self.system._running.pop(task.id, None)

        kind = interrupter.check()
        if status == ExecStatus.DONE:
            handle._resolve(TaskResult(TaskStatus.DONE, output=getattr(task, "output", None)))
        elif status == ExecStatus.CANCELED:
            handle._resolve(TaskResult(TaskStatus.CANCELED, task=task))
        elif status == ExecStatus.PAUSED:
            if kind == InterruptionKind.SUSPEND:
                # transparent preemption: task goes back on our queue
                self.queue.append(handle)
                self.wakeup.set()
            elif kind == InterruptionKind.CANCEL:
                handle._resolve(TaskResult(TaskStatus.CANCELED, task=task))
            elif self.system._shutting_down:
                handle._resolve(TaskResult(TaskStatus.SHUTDOWN, task=task))
                self.system._shutdown_leftover.append(task)
            else:
                self.system._paused[task.id] = handle
                handle._on_paused()


class TaskSystem:
    """Dispatch tasks over `worker_count` cooperative workers.

    `dispatch` round-robins; `dispatch_many` fills least-loaded first
    (ref:system.rs:404-461). `shutdown()` pauses everything and returns
    the unfinished Task objects for persistence.
    """

    def __init__(self, worker_count: int | None = None):
        self.worker_count = worker_count or os.cpu_count() or 1
        self.workers = [_Worker(self, i) for i in range(self.worker_count)]
        self._rr = 0
        self._running: dict = {}
        self._paused: dict = {}
        self._handles: dict = {}
        self._shutdown_leftover: list[Task] = []
        self._shutting_down = False
        self._started = False

    # -- lifecycle --

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for w in self.workers:
            w.runner = asyncio.ensure_future(w.run_loop())

    async def shutdown(self) -> list[Task]:
        """Stop workers; returns queued/paused/suspended tasks
        (ref:system.rs:224-258)."""
        self._shutting_down = True
        for w in self.workers:
            if w.current_interrupter is not None:
                w.current_interrupter.interrupt(InterruptionKind.PAUSE)
            w.wakeup.set()
        for w in self.workers:
            if w.runner is not None:
                await w.runner
        leftover: list[Task] = list(self._shutdown_leftover)
        for w in self.workers:
            while w.queue:
                handle = w.queue.popleft()
                if not handle.done():
                    handle._resolve(TaskResult(TaskStatus.SHUTDOWN, task=handle.task))
                    leftover.append(handle.task)
        for handle in list(self._paused.values()):
            handle._resolve(TaskResult(TaskStatus.SHUTDOWN, task=handle.task))
            leftover.append(handle.task)
        self._paused.clear()
        return leftover

    # -- dispatch --

    def dispatch(self, task: Task) -> TaskHandle:
        self.start()
        handle = TaskHandle(task, self)
        self._handles[task.id] = handle
        worker = self.workers[self._rr % self.worker_count]
        self._rr += 1
        worker.enqueue(handle)
        return handle

    def dispatch_many(self, tasks: Iterable[Task]) -> list[TaskHandle]:
        self.start()
        handles = []
        for task in tasks:
            handle = TaskHandle(task, self)
            self._handles[task.id] = handle
            min(self.workers, key=lambda w: w.load()).enqueue(handle)
            handles.append(handle)
        return handles

    # -- stealing --

    def _steal(self, thief_index: int) -> TaskHandle | None:
        donors = sorted(
            (w for w in self.workers if w.index != thief_index),
            key=lambda w: len(w.queue),
            reverse=True,
        )
        for donor in donors:
            handle = donor.steal_from()
            if handle is not None:
                logger.debug("worker %d stole %r from %d", thief_index, handle.task, donor.index)
                return handle
        return None

    # -- control plane (used by TaskHandle) --

    async def _interrupt(self, task_id, kind: InterruptionKind) -> None:
        worker = self._running.get(task_id)
        if worker is not None and worker.current_interrupter is not None:
            worker.current_interrupter.interrupt(kind)
            return
        # not running: find it queued or paused
        handle = self._paused.pop(task_id, None)
        if handle is not None:
            if kind == InterruptionKind.CANCEL:
                handle._resolve(TaskResult(TaskStatus.CANCELED, task=handle.task))
            else:
                self._paused[task_id] = handle
            return
        for w in self.workers:
            for handle in list(w.queue):
                if handle.task.id == task_id:
                    w.queue.remove(handle)
                    if kind == InterruptionKind.CANCEL:
                        handle._resolve(TaskResult(TaskStatus.CANCELED, task=handle.task))
                    else:
                        self._paused[task_id] = handle
                        handle._on_paused()
                    return

    async def _resume(self, task_id) -> None:
        handle = self._paused.pop(task_id, None)
        if handle is not None:
            handle._paused_event.clear()
            min(self.workers, key=lambda w: w.load()).enqueue(handle)

    async def _force_abort(self, task_id) -> None:
        worker = self._running.get(task_id)
        if worker is not None and worker.current_coro is not None:
            worker.current_coro.cancel()
            return
        await self._interrupt(task_id, InterruptionKind.CANCEL)

    # -- introspection --

    def pending_count(self) -> int:
        return sum(w.load() for w in self.workers) + len(self._paused)
