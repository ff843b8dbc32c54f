"""TaskSystem — cooperative multi-worker scheduler with work stealing.

Parity: ref:crates/task-system/src/system.rs (round-robin `dispatch`,
least-loaded `dispatch_many`, worker-per-core), worker/mod.rs:282
(stealing), worker/runner.rs:46-115 (priority suspension), and the
shutdown contract that returns unfinished tasks to the caller
(ref:src/task.rs:69-71). Implemented over one asyncio loop: "workers"
are concurrent coroutines, which matches this framework's workload
(batch assembly + device-step awaiting + async IO).

Counterpart of `spacedrive_tpu/tasks/system.py`, with its metrics
(queue wait, dispatch latency, occupancy, steals) and its trace
propagation: a task runs under the trace of the caller that dispatched
it, below a synthetic `task.dispatch` span that covers its queue wait.
`start` takes a refcounted hold on the process
pool (parallel/procpool.py; a no-op under SD_PROCS=0) and `shutdown`
releases it, so task bodies can ship host decodes to it.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import time
from typing import Iterable

from ..parallel import procpool as _procpool
from ..telemetry import metrics as _tm
from ..telemetry import trace as _trace
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
        handle._enqueued_at = time.monotonic()
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

    @staticmethod
    def _trace_dispatch(handle: TaskHandle, now: float) -> "_trace.TraceContext | None":
        """The execution-side half of dispatch propagation: record a
        synthetic "task.dispatch" span covering the queue wait, and
        return the context the task body should run under (child of the
        dispatcher's span). None when the dispatcher had no trace."""
        ctx = getattr(handle, "_trace_ctx", None)
        if ctx is None:
            return None
        span_id = _trace.new_span_id()
        enqueued = getattr(handle, "_enqueued_at", None)
        wait = max(0.0, now - enqueued) if enqueued is not None else 0.0
        _trace.record_span({
            "stage": "task.dispatch",
            "seconds": wait,
            "t0": time.time() - wait,
            "trace_id": ctx.trace_id,
            "span_id": span_id,
            "parent_id": ctx.span_id,
        })
        return _trace.TraceContext(ctx.trace_id, span_id)

    async def _execute(self, handle: TaskHandle) -> None:
        task = handle.task
        now = time.monotonic()
        enqueued = getattr(handle, "_enqueued_at", None)
        if enqueued is not None:
            _tm.TASK_QUEUE_WAIT.observe(now - enqueued)
        dispatched = getattr(handle, "_dispatched_at", None)
        if dispatched is not None:
            # first execution only: a suspended or stolen task
            # re-entering would double-count its dispatch latency
            _tm.TASK_DISPATCH_LATENCY.observe(now - dispatched)
            handle._dispatched_at = None
        busy = len(self.system._running) + 1  # including us
        _tm.TASK_BATCH_OCCUPANCY.observe(busy / self.system.worker_count)
        # the worker coroutine has its own contextvars, so the context
        # captured at dispatch() rides the handle; the task body (a copy
        # of this context, taken by ensure_future) nests under it
        exec_ctx = self._trace_dispatch(handle, now)
        trace_token = _trace.set_current(exec_ctx) if exec_ctx is not None else None
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
            if trace_token is not None:
                _trace.reset_current(trace_token)

        kind = interrupter.check()
        if status == ExecStatus.DONE:
            handle._resolve(TaskResult(TaskStatus.DONE, output=getattr(task, "output", None)))
        elif status == ExecStatus.CANCELED:
            handle._resolve(TaskResult(TaskStatus.CANCELED, task=task))
        elif status == ExecStatus.PAUSED:
            if kind == InterruptionKind.SUSPEND:
                # transparent preemption: task goes back on our queue
                handle._enqueued_at = time.monotonic()
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
        self._procpool_held = False

    # -- lifecycle --

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        # the pool's lifecycle rides this system's: a bare TaskSystem gets
        # workers under SD_PROCS>0 without a Node, and a Node's own hold
        # stacks on it
        self._procpool_held = _procpool.POOL.start()
        for w in self.workers:
            w.runner = asyncio.ensure_future(w.run_loop())

    async def shutdown(self) -> list[Task]:
        """Stop workers; returns queued/paused/suspended tasks
        (ref:system.rs:224-258)."""
        self._shutting_down = True
        if self._procpool_held:
            _procpool.POOL.stop()
            self._procpool_held = False
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
        handle._dispatched_at = time.monotonic()
        # the worker re-installs the dispatcher's trace before the body
        handle._trace_ctx = _trace.current()
        _tm.TASKS_DISPATCHED.inc()
        self._handles[task.id] = handle
        worker = self.workers[self._rr % self.worker_count]
        self._rr += 1
        worker.enqueue(handle)
        return handle

    def dispatch_many(self, tasks: Iterable[Task]) -> list[TaskHandle]:
        self.start()
        handles = []
        now = time.monotonic()
        ctx = _trace.current()
        for task in tasks:
            handle = TaskHandle(task, self)
            handle._dispatched_at = now
            handle._trace_ctx = ctx
            _tm.TASKS_DISPATCHED.inc()
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
                _tm.TASK_STEALS.inc()
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
