"""Task contract for the execution plane.

Mirrors the reference's `Task` trait and interruption machinery
(ref:crates/task-system/src/task.rs:81-148): a task runs to an
ExecStatus, checking its Interrupter at safe points; the system can
pause, cancel, or force-abort it, and priority tasks can suspend
non-priority ones mid-run.

Counterpart of `spacedrive_tpu/tasks/task.py`.
"""

from __future__ import annotations

import abc
import asyncio
import enum
import itertools
import uuid
from dataclasses import dataclass
from typing import Any


class ExecStatus(enum.Enum):
    """What a task's `run` returned (ref:task.rs:81-85)."""

    DONE = "done"
    PAUSED = "paused"
    CANCELED = "canceled"


class InterruptionKind(enum.Enum):
    PAUSE = "pause"
    CANCEL = "cancel"
    SUSPEND = "suspend"  # priority preemption; worker will requeue


class TaskStatus(enum.Enum):
    """Final disposition reported through the handle
    (ref:task.rs TaskStatus)."""

    DONE = "done"
    PAUSED = "paused"
    CANCELED = "canceled"
    FORCED_ABORTION = "forced_abortion"
    ERROR = "error"
    SHUTDOWN = "shutdown"  # system shut down; task returned for persistence


class Interrupter:
    """Cooperative interruption point. Tasks call `check()` (cheap) at
    batch boundaries; long waits use `wait_interrupt(timeout)`."""

    def __init__(self) -> None:
        self._kind: InterruptionKind | None = None
        self._event = asyncio.Event()

    def interrupt(self, kind: InterruptionKind) -> None:
        # cancel wins over pause/suspend; first non-cancel sticks
        if self._kind is None or kind == InterruptionKind.CANCEL:
            self._kind = kind
        self._event.set()

    def check(self) -> InterruptionKind | None:
        """Non-blocking: the pending interruption, if any."""
        return self._kind

    async def wait_interrupt(self, timeout: float | None = None) -> InterruptionKind | None:
        try:
            await asyncio.wait_for(self._event.wait(), timeout)
        except asyncio.TimeoutError:
            return None
        return self._kind

    def clear(self) -> None:
        self._kind = None
        self._event = asyncio.Event()


_task_counter = itertools.count(1)


class Task(abc.ABC):
    """A resumable unit of work. Subclasses hold their own progress
    state so a Paused/suspended task continues where it left off when
    re-run (the contract the job steps rely on)."""

    priority: bool = False

    def __init__(self, *, priority: bool | None = None) -> None:
        self.id = uuid.uuid4()
        self.seq = next(_task_counter)
        if priority is not None:
            self.priority = priority

    @abc.abstractmethod
    async def run(self, interrupter: Interrupter) -> ExecStatus:
        ...

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {str(self.id)[:8]} prio={self.priority}>"


@dataclass
class TaskResult:
    status: TaskStatus
    output: Any = None
    error: BaseException | None = None
    task: Task | None = None  # returned for PAUSED / SHUTDOWN persistence


class TaskHandle:
    """Control + completion future for a dispatched task
    (ref:task.rs TaskHandle: pause/cancel/resume/force_abort)."""

    def __init__(self, task: Task, system: "Any") -> None:
        self.task = task
        self._system = system
        self._done: asyncio.Future[TaskResult] = asyncio.get_running_loop().create_future()
        self._paused_event = asyncio.Event()

    # -- completion --

    def _resolve(self, result: TaskResult) -> None:
        if not self._done.done():
            self._done.set_result(result)

    def _on_paused(self) -> None:
        self._paused_event.set()

    async def wait_paused(self) -> None:
        await self._paused_event.wait()

    async def wait(self) -> TaskResult:
        # shielded: cancelling one waiter must not cancel the shared
        # result future other waiters (e.g. the job supervisor) hold
        return await asyncio.shield(self._done)

    def done(self) -> bool:
        return self._done.done()

    # -- control --

    async def pause(self) -> None:
        await self._system._interrupt(self.task.id, InterruptionKind.PAUSE)

    async def cancel(self) -> None:
        await self._system._interrupt(self.task.id, InterruptionKind.CANCEL)

    async def resume(self) -> None:
        await self._system._resume(self.task.id)

    async def force_abort(self) -> None:
        await self._system._force_abort(self.task.id)
